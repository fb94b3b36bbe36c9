"""The port's layout search (``isotope_tpu_torch/parallel/layout.py``) and
collective cost rows (``analysis/costmodel.comm_table``) against the JAX
package's.

Handed the reference's four link constants (the port's module
attributes replaced with ``monkeypatch``), the port's rows, scores and
choices equal the reference's over a grid of device counts, service
counts, host counts and merge counts: rows key for key, floats within
rtol 1e-12.  With the port's own constants (NVLink inside a host, a NIC
between hosts) the cases of ``tests/test_layout.py`` hold: the ordering
of the links, no between-hosts row on one slice, slices pinned to the
host count, a deterministic choice.
"""
import itertools

import pytest

from isotope_tpu.analysis import costmodel as jax_costmodel
from isotope_tpu.parallel import layout as jax_layout
from isotope_tpu_torch.analysis import costmodel
from isotope_tpu_torch.parallel import MeshSpec, layout, mesh

RTOL = 1e-12

#: the port's constant -> the reference's
CONSTANTS = {
    "IN_HOST_BANDWIDTH_BYTES_S": "ICI_BANDWIDTH_BYTES_S",
    "CROSS_HOST_BANDWIDTH_BYTES_S": "DCN_BANDWIDTH_BYTES_S",
    "IN_HOST_LATENCY_S": "ICI_LATENCY_S",
    "CROSS_HOST_LATENCY_S": "DCN_LATENCY_S",
}

GRID = list(itertools.product((1, 2, 4, 8, 16), (1, 3, 100, 1024),
                              (1, 2), (1, 10)))


@pytest.fixture
def reference_constants(monkeypatch):
    for port, ref in CONSTANTS.items():
        monkeypatch.setattr(costmodel, port, getattr(jax_costmodel, ref))


def _rows_equal(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert list(g) == list(w), what
        for k in w:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=RTOL, abs=0.0), (
                    what, k)
            else:
                assert g[k] == w[k], (what, k)


@pytest.mark.parametrize("n,S,hosts,merges", GRID,
                         ids=[f"{n}dev-{s}svc-{h}host-{m}merge"
                              for n, s, h, m in GRID])
def test_search_equals_the_reference_on_its_constants(
        reference_constants, n, S, hosts, merges):
    """Every candidate's rows and score, and the choice, are the
    reference's; a host count that does not divide the devices raises
    in both."""
    if n % hosts:
        with pytest.raises(ValueError, match="divide"):
            jax_layout.enumerate_specs(n, S, max_slices=hosts)
        with pytest.raises(ValueError, match="divide"):
            layout.enumerate_specs(n, S, max_slices=hosts)
        return
    want_specs = jax_layout.enumerate_specs(n, S, max_slices=hosts)
    got_specs = layout.enumerate_specs(n, S, max_slices=hosts)
    assert ([(s.data, s.svc, s.slices) for s in got_specs]
            == [(s.data, s.svc, s.slices) for s in want_specs])
    for g, w in zip(got_specs, want_specs):
        what = g.describe()
        _rows_equal(
            costmodel.comm_table(S, g.data, g.svc, g.slices,
                                 num_merges=merges),
            jax_costmodel.comm_table(S, w.data, w.svc, w.slices,
                                     num_merges=merges), what)
        gs = layout.score_layout(g, S, num_merges=merges)
        ws = jax_layout.score_layout(w, S, num_merges=merges)
        assert gs.score_s == pytest.approx(ws.score_s, rel=RTOL, abs=0.0)
        assert gs.pad_fraction == ws.pad_fraction
        _rows_equal([dict(r) for r in gs.comm_rows],
                    [dict(r) for r in ws.comm_rows], what)
    got = layout.choose_layout(n, S, max_slices=hosts, num_merges=merges)
    want = jax_layout.choose_layout(n, S, max_slices=hosts,
                                    num_merges=merges)
    assert got.spec.describe() == want.spec.describe()
    d, wd = got.to_dict(), want.to_dict()
    assert list(d) == list(wd)
    assert d["mesh"] == wd["mesh"]
    _rows_equal(d["comm"], wd["comm"], "to_dict")


def test_summary_bytes_equal_the_reference():
    for s, e in ((1, None), (100, None), (1024, 3000)):
        got = costmodel.summary_bytes(s, e)
        want = jax_costmodel.summary_bytes(s, e)
        assert got == want


# -- the port's own constants (tests/test_layout.py's cases) ----------------


def test_constants_order_the_links():
    assert (costmodel.CROSS_HOST_BANDWIDTH_BYTES_S
            < costmodel.IN_HOST_BANDWIDTH_BYTES_S)
    assert costmodel.CROSS_HOST_LATENCY_S > costmodel.IN_HOST_LATENCY_S


def test_comm_table_single_slice_has_no_dcn_row():
    rows = costmodel.comm_table(100, data=4, svc=2)
    assert [r["collective"] for r in rows] == [
        "psum_replicated", "psum_scatter_svc",
    ]
    assert all(r["link"] == "ici" for r in rows)


def test_comm_table_dcn_row_carries_scattered_tile():
    rows = costmodel.comm_table(1024, data=2, svc=2, slices=2)
    by = {r["collective"]: r for r in rows}
    assert by["psum_dcn"]["link"] == "dcn"
    full = by["psum_replicated"]["bytes"] + by["psum_scatter_svc"]["bytes"]
    assert by["psum_dcn"]["bytes"] < full


def test_comm_table_dcn_slower_than_ici_for_same_bytes():
    ici = costmodel._collective_s(1e6, 2, "ici")
    dcn = costmodel._collective_s(1e6, 2, "dcn")
    assert dcn > ici
    assert costmodel._collective_s(1e6, 1, "dcn") == 0.0


def test_comm_table_num_merges_scales_time():
    one = costmodel.comm_table(64, data=4, svc=2, num_merges=1)
    ten = costmodel.comm_table(64, data=4, svc=2, num_merges=10)
    for a, b in zip(one, ten):
        assert b["time_s"] == pytest.approx(10 * a["time_s"])


def test_enumerate_respects_device_count():
    for spec in layout.enumerate_specs(8, 1024, max_slices=2):
        assert spec.size == 8


def test_enumerate_never_pads_only_svc_shards():
    for spec in layout.enumerate_specs(8, 3):
        assert spec.svc <= 3
    assert all(s.svc == 1 for s in layout.enumerate_specs(8, 1))


def test_enumerate_slices_pinned_to_host_count():
    with_slices = layout.enumerate_specs(8, 100, max_slices=2)
    assert {s.slices for s in with_slices} == {2}
    with pytest.raises(ValueError, match="divide"):
        layout.enumerate_specs(8, 100, max_slices=3)


def test_choose_respects_padded_service_width():
    best = layout.choose_layout(8, 1024)
    s_pad = -(-1024 // best.spec.svc) * best.spec.svc
    assert best.spec.svc <= s_pad
    assert best.spec.size == 8


def test_choose_beats_hardcoded_multichip_mesh():
    auto = layout.choose_layout(8, 1024, max_slices=2)
    hand = layout.score_layout(MeshSpec(data=2, svc=2, slices=2), 1024)
    assert auto.score_s <= hand.score_s


def test_choose_slices_match_host_count():
    for n in (2, 4, 8, 16):
        assert layout.choose_layout(n, 1024, max_slices=1).spec.slices == 1
        assert layout.choose_layout(n, 1024, max_slices=2).spec.slices == 2


def test_choose_tiny_service_count_narrow_svc():
    assert layout.choose_layout(8, 1).spec == MeshSpec(data=8, svc=1)
    assert layout.choose_layout(1, 1024).spec == MeshSpec(data=1, svc=1)


def test_choose_deterministic():
    a = layout.choose_layout(8, 200, max_slices=2)
    b = layout.choose_layout(8, 200, max_slices=2)
    assert a.spec == b.spec and a.score_s == b.score_s
    assert a.to_dict() == b.to_dict()


def test_score_to_dict_shape():
    d = layout.choose_layout(4, 64).to_dict()
    assert set(d) == {"mesh", "score_s", "pad_fraction", "comm"}
    assert all({"collective", "link", "bytes", "time_s",
                "participants"} <= set(r) for r in d["comm"])


# -- the host count ------------------------------------------------------------


@pytest.mark.parametrize("world,local,hosts", [
    (None, None, 1),     # no launcher: one host
    ("8", "8", 1),       # torchrun --nproc-per-node 8 on one host
    ("8", "4", 2),       # two hosts of four
    ("16", "4", 4),
    ("1", "1", 1),
], ids=["no-launcher", "8-on-1", "8-on-2", "16-on-4", "world-of-one"])
def test_host_count_reads_the_launcher(monkeypatch, world, local, hosts):
    """``WORLD_SIZE // LOCAL_WORLD_SIZE`` as ``torchrun`` announces them
    (no process group here: ``world_size`` reads ``$WORLD_SIZE``)."""
    import torch.distributed as dist

    assert not (dist.is_available() and dist.is_initialized())
    for name, value in (("WORLD_SIZE", world), ("LOCAL_WORLD_SIZE", local)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert mesh.host_count() == hosts
