"""The port's sharded runs (``isotope_tpu_torch/parallel/sharded.py``) in
``gloo`` worlds on the CPU, against the port's emulated twin and the JAX
package's ``ShardedSimulator`` on conftest's 8 virtual CPU devices.

Three worlds, each launched once (``tests/torch_mesh_world.py``, one
process per rank, every group's timeout 60 s, the world killed at
``WORLD_TIMEOUT_S``): data=2; data=2 x svc=2 (also the lb pin's
data=4 mesh over the same four ranks); data=2 x svc=2 x slice=2.  Each
runs the plain run (open loop with the trim window, a paced closed
loop), the overlapped run, the attributed run (tail) and the recorded
run; the tests read the saved results.

Tolerances:

- every rank returns the same results, bit for bit;
- collective path against the port's emulated twin (the same draws):
  the integer-valued fields (counts, histogram bins, ``hop_events``,
  the recorder's counts, blame counts) and the extremes are equal; the
  float sums and the second moment within ``n_shards`` float32 spacings
  (gloo's sums do not keep the twin's shard order); the exemplars equal;
- overlap on against off: the bounds of the reference's
  ``test_overlap_equivalence`` (integers and extremes equal, sums and
  m2 within rtol 1e-5, the per-service series within 4 spacings);
- both against the JAX ``ShardedSimulator`` on the same draws: the
  engine's tolerances (counts equal, seconds within rtol 1e-5 / atol
  1e-9 s, quantiles within one histogram bucket), and the attribution
  and timeline bands of ``tests/test_torch_attribution.py`` and
  ``tests/test_torch_timeline.py``.
"""
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_lb as jax_compile_lb
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.parallel import MeshSpec as JaxMeshSpec
from isotope_tpu.parallel import ShardedSimulator as JaxSharded
from isotope_tpu.parallel import build_mesh as jax_build_mesh
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim.config import ChaosEvent as JaxChaos
from isotope_tpu_torch.compiler import compiled_from_arrays, compiled_to_arrays
from isotope_tpu_torch.metrics import histogram
from test_torch_attribution import assert_attr_match
from test_torch_replay import JaxReplayDraws
from test_torch_timeline import assert_timeline_match
from torch_mesh_world import (
    FORK,
    LB_CHAIN,
    SCENARIOS,
    WORLDS,
    Recording,
    launch,
    mesh_spec_of,
    twin_runs,
)

KEY = jax.random.PRNGKey(23)
#: a world's processes are killed past this many seconds
WORLD_TIMEOUT_S = 300.0

RUN_INT = ("count", "error_count", "hop_events", "latency_hist",
           "win_count", "win_error_count", "win_latency_hist")
RUN_EXACT = ("latency_min", "latency_max", "end_max", "win_lo", "win_hi",
             "utilization", "unstable")
RUN_FLOAT = ("latency_sum", "latency_m2")
METRIC_INT = ("incoming_total", "outgoing_total", "outgoing_size_hist",
              "duration_hist", "response_size_hist")
METRIC_FLOAT = ("outgoing_size_sum", "duration_sum", "response_size_sum")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spacings(got, want) -> float:
    """The largest difference in float32 spacings of the larger value."""
    g = _np(got).astype(np.float64)
    w = _np(want).astype(np.float64)
    same = g == w
    sp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32))
    with np.errstate(invalid="ignore"):
        d = np.abs(g - w) / np.where(sp > 0, sp, 1.0).astype(np.float64)
    return float(np.max(np.where(same, 0.0, d), initial=0.0))


def _equal(got, want, what):
    assert np.array_equal(_np(got), _np(want)), what


# -- the worlds --------------------------------------------------------------


def _jax_run(name, spec):
    graph, params, method, load, n, block, kw, chaos = SCENARIOS[name]
    g = JaxGraph.from_yaml(graph)
    jc = jax_compile_graph(g)
    sh = JaxSharded(
        jc, jax_build_mesh(JaxMeshSpec(*spec)), JaxParams(**params),
        tuple(JaxChaos(**c) for c in chaos),
        lb=jax_compile_lb(g, jc) if graph == LB_CHAIN else None,
    )
    return getattr(sh, method)(JaxLoad(**load), n, KEY, block_size=block,
                               **kw)


class _Worlds:
    """Each world launched on first use, once for the module."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.cache = {}

    def get(self, name):
        if name not in self.cache:
            self.cache[name] = self._launch(name)
        return self.cache[name]

    def _launch(self, name):
        work = self.tmp.mktemp(name)
        arrays = compiled_to_arrays(
            jax_compile_graph(JaxGraph.from_yaml(FORK))
        )
        np.savez(work / "compiled.npz", **arrays)
        store = {}
        twin = twin_runs(name, compiled_from_arrays(arrays),
                         Recording(JaxReplayDraws(KEY), store))
        np.savez(work / "draws.npz", **store)
        t0 = time.monotonic()
        ranks = launch(name, work, WORLD_TIMEOUT_S)
        seconds = time.monotonic() - t0
        spec = WORLDS[name][0]
        return SimpleNamespace(
            name=name, spec=spec, n_shards=int(np.prod(spec)), twin=twin,
            ranks=ranks, seconds=seconds, work=work,
            jax={s: _jax_run(s, mesh_spec_of(name, s))
                 for s in WORLDS[name][1]},
        )


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def shards_of(w, scenario):
    return int(np.prod(mesh_spec_of(w.name, scenario)))


# -- comparisons -------------------------------------------------------------


def assert_run_twin_close(got, want, k, what=""):
    for f in RUN_INT + RUN_EXACT:
        _equal(getattr(got, f), getattr(want, f), what + f)
    for f in RUN_FLOAT:
        assert _spacings(getattr(got, f), getattr(want, f)) <= k, what + f
    for f in METRIC_INT:
        _equal(getattr(got.metrics, f), getattr(want.metrics, f),
               what + f)
    for f in METRIC_FLOAT:
        assert _spacings(getattr(got.metrics, f),
                         getattr(want.metrics, f)) <= k, what + f


def _bucket(x):
    return np.searchsorted(histogram.EDGES, np.asarray(x),
                           side="right") - 1


def assert_run_matches_jax(got, want, what=""):
    for f in ("count", "error_count", "hop_events", "win_count",
              "win_error_count"):
        assert float(getattr(got, f)) == float(getattr(want, f)), what + f
    for f in ("latency_sum", "latency_m2", "latency_min", "latency_max",
              "end_max", "win_lo", "win_hi"):
        np.testing.assert_allclose(
            float(getattr(got, f)), float(getattr(want, f)), rtol=1e-5,
            atol=1e-9, err_msg=what + f,
        )
    qs = (0.5, 0.9, 0.99)
    assert np.all(np.abs(_bucket(got.quantiles_s(qs))
                         - _bucket(want.quantiles_s(qs))) <= 1), what
    assert _np(got.latency_hist).sum() == _np(want.latency_hist).sum()
    _equal(got.unstable, want.unstable, what + "unstable")
    np.testing.assert_allclose(_np(got.utilization),
                               _np(want.utilization), rtol=1e-5)
    gm, wm = got.metrics, want.metrics
    for f in ("incoming_total", "outgoing_total", "outgoing_size_hist",
              "response_size_hist"):
        assert _np(getattr(gm, f)).shape == _np(getattr(wm, f)).shape
        _equal(getattr(gm, f), getattr(wm, f), what + f)
    # a duration within a few ULP of a bucket edge may land one over:
    # each (service, code) row keeps its count
    dh, wdh = _np(gm.duration_hist), _np(wm.duration_hist)
    assert dh.shape == wdh.shape
    _equal(dh.sum(-1), wdh.sum(-1), what + "duration_hist rows")
    assert np.abs(dh - wdh).sum() <= 2e-3 * wdh.sum(), what
    for f in METRIC_FLOAT:
        np.testing.assert_allclose(_np(getattr(gm, f)),
                                   _np(getattr(wm, f)), rtol=1e-5,
                                   atol=1e-9, err_msg=what + f)


def assert_attr_twin_close(got, want, k):
    from isotope_tpu_torch.metrics.attribution import AttributionSummary

    for f in AttributionSummary._fields:
        g, wv = getattr(got, f), getattr(want, f)
        if f == "exemplars":
            for name in g._fields:
                _equal(getattr(g, name), getattr(wv, name), name)
        elif _np(g).dtype.kind in "iub":
            _equal(g, wv, f)
        else:
            assert _spacings(g, wv) <= k, f


def assert_tl_twin_close(got, want, k):
    for f in got._fields:
        g, wv = getattr(got, f), getattr(want, f)
        if _np(g).dtype.kind in "iub" or f == "window_s":
            _equal(g, wv, f)
        else:
            assert _spacings(g, wv) <= k, f


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


ALL = list(WORLDS)


# -- tests -------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_every_rank_returns_the_same_results(worlds, name):
    w = worlds.get(name)
    first = w.ranks[0]
    for r, out in enumerate(w.ranks[1:], 1):
        for key, value in first.items():
            if key == "coordinate" or key.endswith(".telemetry"):
                continue
            a, b = _leaves(value), _leaves(out[key])
            assert len(a) == len(b), key
            for x, y in zip(a, b):
                if key in ("ladder_all", "ladder_one", "dcn_retry",
                           "dcn_silent") and isinstance(x, float):
                    continue  # wall seconds, counters: per rank
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), (r, key)
                else:
                    assert x == y, (r, key)


@pytest.mark.parametrize("name", ALL)
def test_layout_search_resolves_in_the_world(worlds, name):
    """``--mesh auto``'s search on every rank (the world's ranks, the
    hosts its launcher announces: one a slice) equals the port's
    ``choose_layout`` called outside the world."""
    from isotope_tpu_torch.parallel import choose_layout

    w = worlds.get(name)
    services = compiled_from_arrays(dict(np.load(
        w.work / "compiled.npz"))).num_services
    want = choose_layout(w.n_shards, services,
                         max_slices=w.spec[2]).to_dict()
    assert want["mesh"].endswith(",slice=2") == (w.spec[2] == 2)
    for out in w.ranks:
        assert out["layout"] == want


@pytest.mark.parametrize("name", ALL)
def test_global_rank_is_the_row_major_shard_index(worlds, name):
    w = worlds.get(name)
    names = ("data", "svc") if w.spec[2] == 1 else ("slice", "data", "svc")
    sizes = {"data": w.spec[0], "svc": w.spec[1], "slice": w.spec[2]}
    for r, out in enumerate(w.ranks):
        idx = 0
        for a, c in zip(names, out["coordinate"]):
            idx = idx * sizes[a] + int(c)
        assert idx == r


@pytest.mark.parametrize("name", ALL)
def test_plain_runs_match_the_emulated_twin(worlds, name):
    w = worlds.get(name)
    for s in ("open", "closed"):
        got, want = w.ranks[0][s], w.twin[s]
        assert_run_twin_close(got, want, w.n_shards, f"{s}.")
        # the 4 services padded to the svc axis, gathered on every rank
        s_pad = -(-4 // w.spec[1]) * w.spec[1]
        assert got.metrics.duration_hist.shape[0] == s_pad


@pytest.mark.parametrize("name", ALL)
def test_attributed_run_matches_the_emulated_twin(worlds, name):
    w = worlds.get(name)
    (gs, ga), (ws, wa) = w.ranks[0]["attr"], w.twin["attr"]
    assert_run_twin_close(gs, ws, w.n_shards, "attr.")
    assert_attr_twin_close(ga, wa, w.n_shards)
    assert float(ga.tail_cut) == float(wa.tail_cut) < np.inf
    assert int(ga.count) == int(gs.count)


@pytest.mark.parametrize("name", ALL)
def test_recorded_run_matches_the_emulated_twin(worlds, name):
    w = worlds.get(name)
    scen = [s for s in ("tl", "lb") if s in w.twin]
    for s in scen:
        (gs, gt), (ws, wt) = w.ranks[0][s], w.twin[s]
        k = shards_of(w, s)
        assert_run_twin_close(gs, ws, k, f"{s}.")
        assert_tl_twin_close(gt, wt, k)
        assert int(_np(gt.arrivals).sum()) == int(gs.count)


@pytest.mark.parametrize("name", ALL)
def test_overlap_matches_the_plain_path(worlds, name):
    """The reference's ``test_overlap_equivalence`` bounds, and the
    twin (which replays the plain reduction order) within rtol."""
    w = worlds.get(name)
    on, off = w.ranks[0]["overlap"], w.ranks[0]["open"]
    for f in ("count", "error_count", "hop_events", "win_count",
              "win_error_count", "win_lo", "win_hi", "latency_min",
              "latency_max", "end_max"):
        assert float(getattr(on, f)) == float(getattr(off, f)), f
    for f in ("latency_hist", "win_latency_hist", "utilization",
              "unstable"):
        _equal(getattr(on, f), getattr(off, f), f)
    for f in ("latency_sum", "latency_m2"):
        np.testing.assert_allclose(float(getattr(on, f)),
                                   float(getattr(off, f)), rtol=1e-5,
                                   err_msg=f)
    for a, b in zip(on.metrics, off.metrics):
        assert _spacings(a, b) <= 4.0
    twin = w.twin["overlap"]
    assert float(on.count) == float(twin.count)
    _equal(on.latency_hist, twin.latency_hist, "latency_hist")
    np.testing.assert_allclose(float(on.latency_sum),
                               float(twin.latency_sum), rtol=1e-5)


@pytest.mark.parametrize("path", ["collective", "twin"])
@pytest.mark.parametrize("name", ALL)
def test_runs_match_the_jax_sharded_simulator(worlds, name, path):
    """Every scenario of the world against the JAX package's
    ``ShardedSimulator`` on the same draws: the collective path (rank
    0's results) and the port's emulated twin."""
    w = worlds.get(name)
    got_all = w.ranks[0] if path == "collective" else w.twin
    for s, want in w.jax.items():
        got = got_all[s]
        if s == "attr":
            assert_run_matches_jax(got[0], want[0], "attr.")
            assert_attr_match(got[1], want[1], float(want[0].latency_sum))
        elif s in ("tl", "lb"):
            assert_run_matches_jax(got[0], want[0], f"{s}.")
            assert_timeline_match(got[1], want[1], f"{s}.")
        else:
            assert_run_matches_jax(got, want, f"{s}.")


@pytest.mark.parametrize("name", ALL)
def test_open_run_telemetry(worlds, name):
    w = worlds.get(name)
    for out in w.ranks:
        t = out["open.telemetry"]
        assert t["sharded_runs"] == 1.0
        assert t["shard_count"] == w.n_shards
        assert t["imbalance"] == 0.0


def test_gather_oom_degrades_every_rank_to_single_device(worlds):
    """``oom:sharded.gather:2`` on both ranks: the sharded and
    sharded-half-block rungs fail after their merge, the single-device
    rung (every shard replayed on each rank) serves the case within one
    float32 spacing of the clean run (tests/test_resilience.py:251)."""
    w = worlds.get("data2")
    for out in w.ranks:
        got = out["ladder_all"]
        assert got["degraded"] == "single-device"
        assert got["degradations"] == 2.0
        for a, b in zip(_leaves(got["summary"]), _leaves(got["clean"])):
            assert _spacings(a, b) <= 1.0


def test_fault_on_one_rank_moves_every_rank_to_the_same_rung(worlds):
    """The same fault on rank 1 only: rank 0 takes the same rungs (the
    ranks agree on each failure), both end on single-device with equal
    summaries, and no rank waits for a group's timeout."""
    w = worlds.get("data2")
    a, b = (out["ladder_one"] for out in w.ranks)
    assert a["degraded"] == b["degraded"] == "single-device"
    assert a["degradations"] == b["degradations"] == 2.0
    for x, y in zip(_leaves(a["summary"]), _leaves(b["summary"])):
        assert torch.equal(x, y)
    for out in w.ranks:
        assert out["ladder_one"]["seconds"] < 30.0
    assert w.seconds < WORLD_TIMEOUT_S


def test_dcn_transient_retries_to_identical_results(worlds):
    """A dropped cross-slice collective is retried by the supervisor
    (no degradation) and the retried run equals the clean one."""
    w = worlds.get("data2xsvc2xslice2")
    for out in w.ranks:
        got = out["dcn_retry"]
        assert got["degraded"] is None
        assert got["retries"] == 1.0 and got["injected"] == 1.0
        for a, b in zip(_leaves(got["summary"]), _leaves(got["clean"])):
            assert torch.equal(a, b)


def test_dcn_site_fires_only_on_meshes_with_a_slice_axis(worlds):
    w = worlds.get("data2xsvc2")
    for out in w.ranks:
        got = out["dcn_silent"]
        assert got["degraded"] is None
        assert got["retries"] == 0.0 and got["injected"] == 0.0
