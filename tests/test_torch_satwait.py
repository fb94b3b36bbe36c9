"""The finite-population waits of ``-qps max`` on the CPU.

``saturated_wait_reference`` (the plain torch chain, which the CPU path
of ``isotope_tpu_torch.native.satwait.saturated_wait`` runs) is held bit
for bit to the chain ``Simulator._saturated_wait`` ran inline before
the kernel, on each of its four branches; ``saturated_wait_sequential``
(the kernel's order) to a scalar float32 walk of the kernel's row sum;
and ``launch_plan`` to the geometry the kernel assumes.  The CUDA kernel
itself is held to both plain versions on the card by
``tests/test_torch_satwait_cuda.py`` and by ``chip_smoke.py``.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from isotope_tpu_torch.native import satwait as satwait_mod
from isotope_tpu_torch.sim import closed
from isotope_tpu_torch.sim.engine import F32, _const, ndtr
from test_torch_satwait_cuda import tables

SOURCE = pathlib.Path(satwait_mod.__file__).parent / "csrc" / "satwait.cu"


def _former_chain(z, sat_override=None, phase_idx=None, tables=None,
                  closed_tables=None):
    """``Simulator._saturated_wait`` as it stood before the kernel, with
    ``self._closed_tables(sat_conns)`` replaced by ``closed_tables`` (its
    6-tuple: throughput, p0, coef, e, c as float32 numpy, scale)."""
    if sat_override is not None:
        p0_h, coef_h, e_o, c_o, scale_o = sat_override
        zproj = (z * e_o).sum(-1, keepdim=True)
        z = (z - c_o * e_o * zproj) * scale_o
        deg = coef_h.shape[0]

        def coef(ci):
            return coef_h[ci]
    elif phase_idx is None:
        _, p0_r, coef_r, e_r, c_r, scale_r = closed_tables
        p0_h = p0_r[0]
        c_center = float(c_r[0])
        if c_center > 0.0:
            zproj = (z * e_r[0]).sum(-1, keepdim=True)
            z = (z - c_center * e_r[0] * zproj) * scale_r[0]
        coef_0 = coef_r[0]
        deg = coef_0.shape[0]

        def coef(ci):
            return coef_0[ci]
    else:
        if tables is not None:
            p0_r, coef_r, e_r, c_t, scale_r = tables
        else:
            _, p0_r, coef_r, e_r, c_r, scale_r = closed_tables
            c_t = _const(c_r, F32, "cpu")
        p0_h = p0_r[phase_idx]
        e_n = e_r[phase_idx]
        c_n = c_t[:, None][phase_idx]
        scale_n = scale_r[phase_idx]
        zproj = (z * e_n).sum(-1, keepdim=True)
        z = (z - c_n * e_n * zproj) * scale_n
        deg = coef_r.shape[1]

        def coef(ci):
            return coef_r[:, ci, :][phase_idx]
    u_sat = ndtr(z)
    u_c = torch.clamp(
        (u_sat - p0_h) / torch.clamp(1.0 - p0_h, min=1e-9),
        0.0, 1.0 - 1e-7,
    )
    v = -torch.log1p(-u_c)
    w = coef(deg - 1)
    for ci in range(deg - 2, -1, -1):
        w = w * v + coef(ci)
    return torch.where(u_sat < p0_h, 0.0, torch.clamp(w, min=0.0))


def _closed_tuple(t):
    p0, coef, e, c, scale = t
    return (None, p0, coef, e, c.numpy(), scale)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("h", [3, 121, 1000])
def test_reference_is_the_former_chain_unphased(h):
    z, _, t = tables(2048, h, 11, 1, seed=h)
    got = satwait_mod.saturated_wait_reference(z, None, *t, copula=True)
    _same(got, _former_chain(z, closed_tables=_closed_tuple(t)))


def test_reference_is_the_former_chain_uncentred():
    """An unphased row whose centre c is 0 (the engine's ``c <= 0``)
    takes no copula, so the normals are not touched."""
    z, _, t = tables(1024, 121, 11, 1, seed=5)
    p0, coef, e, c, scale = t
    t = (p0, coef, e, torch.zeros_like(c), scale)
    got = satwait_mod.saturated_wait_reference(z, None, *t, copula=False)
    _same(got, _former_chain(z, closed_tables=_closed_tuple(t)))


@pytest.mark.parametrize("h", [3, 121])
def test_reference_is_the_former_chain_phased(h):
    z, rows, t = tables(2048, h, 11, 6, seed=h + 1)
    got = satwait_mod.saturated_wait_reference(z, rows, *t)
    _same(got, _former_chain(z, phase_idx=rows,
                             closed_tables=_closed_tuple(t)))


def test_reference_is_the_former_chain_member_tables():
    """A chaos fleet's members' rows (M x phases, flattened)."""
    z, rows, t = tables(4 * 512, 121, 11, 4 * 3, seed=7)
    got = satwait_mod.saturated_wait_reference(z, rows, *t)
    _same(got, _former_chain(z, phase_idx=rows, tables=t))


@pytest.mark.parametrize("d", [11, 2])
def test_reference_is_the_former_chain_override(d):
    """The fork-join pilots' one row, centred whatever its c."""
    z, _, (p0, coef, e, c, scale) = tables(1024, 121, d, 1, seed=d)
    over = (p0[0], coef[0], e[0], c[0], scale[0])
    got = satwait_mod.saturated_wait_reference(
        z, None, over[0][None], over[1][None], over[2][None],
        over[3].reshape(1), over[4][None],
    )
    _same(got, _former_chain(z, sat_override=over))


def test_cpu_tensors_take_the_plain_version():
    z, rows, t = tables(512, 121, 11, 3, seed=3)
    before = satwait_mod.saturated_wait.launches
    got = satwait_mod.saturated_wait(z, rows, *t)
    _same(got, satwait_mod.saturated_wait_reference(z, rows, *t))
    assert satwait_mod.saturated_wait.launches == before


def _kernel_row_sum(prod: np.ndarray, group: int) -> np.float32:
    """One row's projection summed in float32 scalars exactly as
    ``csrc/satwait.cu`` pass 1 sums it: each lane's elements (``j // 4 %
    group == t``) left to right, then a butterfly over the group's
    lanes."""
    h = len(prod)
    acc = [np.float32(0.0)] * group
    for j in range(h):
        t = (j // 4) % group
        acc[t] = np.float32(acc[t] + prod[j])
    off = group // 2
    while off:
        acc = [np.float32(acc[t] + acc[t ^ off]) for t in range(group)]
        off //= 2
    return acc[0]


@pytest.mark.parametrize("h", [1, 3, 37, 121, 1000, 4099])
def test_sequential_sums_in_the_kernels_order(h):
    rng = np.random.default_rng(h)
    prod = rng.normal(0, 1, (3, h)).astype(np.float32)
    group = satwait_mod.launch_plan(3, h, 11).group
    got = satwait_mod._group_sum(torch.from_numpy(prod), group)
    want = np.array([[_kernel_row_sum(r, group)] for r in prod])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("copula", [True, False])
def test_sequential_is_the_reference_but_for_the_row_sum(copula):
    """The kernel's order moves only the projection: within the port's
    saturated tolerance of the chain, and equal to it without the
    copula (nothing is summed)."""
    z, rows, t = tables(2048, 1000, 11, 4, seed=11)
    seq = satwait_mod.saturated_wait_sequential(z, rows, *t, copula)
    ref = satwait_mod.saturated_wait_reference(z, rows, *t, copula)
    if copula:
        torch.testing.assert_close(seq, ref, rtol=1e-4, atol=1e-5)
    else:
        _same(seq, ref)


# -- the launch plan, on the CPU --------------------------------------------

@pytest.mark.parametrize("h,group", [
    (1, 1),
    (3, 1),              # three hops: a lane a row
    (6, 2),              # canonical.yaml: two lanes a row
    (121, 32),           # the flagship tree: a warp a row
    (1000, 32),          # multitier1k: a warp a row, 8 chunks a lane
    (10_000, 32),
    (100_000, 32),
])
@pytest.mark.parametrize("d", [2, 11])
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_plan(h, group, d, aligned):
    n = 30_000
    plan = satwait_mod.launch_plan(n, h, d, aligned)
    assert plan.group == group and plan.threads == satwait_mod.THREADS
    # the fewest lanes of one warp that give each at most one chunk
    assert plan.group & (plan.group - 1) == 0 and plan.group <= 32
    assert plan.group == 32 or (
        plan.group * satwait_mod.CHUNK >= h
        > plan.group // 2 * satwait_mod.CHUNK)
    assert plan.threads % 32 == 0
    assert plan.rows_per_block * plan.group == plan.threads
    # every row of z has a group, and no block is without a row
    assert (plan.blocks - 1) * plan.rows_per_block < n
    assert plan.blocks * plan.rows_per_block >= n
    # 16-byte loads only where every row starts on a 16-byte boundary
    assert plan.aligned == (aligned and h % 4 == 0)
    assert plan.unrolled == (d == 11)


def test_launch_plan_refuses_empty_rows():
    with pytest.raises(ValueError):
        satwait_mod.launch_plan(8, 0, 11)
    with pytest.raises(ValueError):
        satwait_mod.launch_plan(8, 3, 0)


def test_launch_plan_matches_the_kernels_plan_layout():
    """``LaunchPlan.as_ints`` fills the C ``Plan`` struct field by
    field."""
    body = re.search(r"struct Plan \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    fields = re.findall(r"int32_t (\w+);", body)
    plan = satwait_mod.launch_plan(30_000, 1000, 11)
    assert fields == [
        "group", "threads", "rows_per_block", "blocks", "aligned",
        "unrolled",
    ]
    assert dict(zip(fields, plan.as_ints())) == {
        "group": 32, "threads": 128, "rows_per_block": 4,
        "blocks": 7_500, "aligned": 1, "unrolled": 1,
    }


def test_kernel_constants_are_the_chains():
    """The kernel's float32 constants are those the chain rounds to, and
    its unrolled degree is the tables' own."""
    src = SOURCE.read_text()

    def const(name):
        m = re.search(rf"constexpr float {name} = (0x[0-9a-fp.+-]+)f;", src)
        return np.float32(float.fromhex(m.group(1)))

    assert const("kHalfSqrt2") == np.float32(0.5) * np.sqrt(np.float32(2))
    assert const("kTailMin") == torch.clamp(
        torch.zeros(1), min=1e-9).item()
    assert const("kUMax") == torch.clamp(
        torch.ones(1), 0.0, 1.0 - 1e-7).item()
    degree = int(re.search(r"constexpr int kDegree = (\d+);", src).group(1))
    assert degree == satwait_mod.UNROLLED_DEGREE == (
        closed.DEFAULT_QUANTILE_DEGREE + 1)


def test_library_path_is_keyed_by_source():
    path = satwait_mod.LIBRARY.path()
    assert path.parent.name == "_build"
    assert path.name.startswith("libsatwait-") and path.suffix == ".so"


def test_engine_calls_pass_what_the_kernel_takes(monkeypatch):
    """Every call the engine makes (the unphased ``-qps max`` run's
    blocks and fork-join pilots, a bounced run's phased blocks) hands the
    wrapper contiguous float32 tables and int64 rows, as the kernel
    requires on the card."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws
    from isotope_tpu_torch.sim import engine
    from isotope_tpu_torch.sim.config import bounce_schedule

    seen = []
    real = engine.saturated_wait

    def check(z, rows, *tables, copula=True):
        for t in (z, *tables):
            assert t.dtype == torch.float32 and t.is_contiguous()
        assert rows is None or (rows.dtype == torch.int64
                                and rows.is_contiguous())
        seen.append((tuple(z.shape), rows is not None))
        return real(z, rows, *tables, copula=copula)

    monkeypatch.setattr(engine, "saturated_wait", check)
    topo = pathlib.Path(__file__).parents[1] / "examples" / "topologies"
    load = LoadModel(kind="closed", qps=None, connections=64)
    plain = Simulator(compile_graph(ServiceGraph.from_yaml_file(
        topo / "canonical.yaml")), device="cpu")
    bounced = Simulator(
        compile_graph(ServiceGraph.from_yaml_file(
            topo / "canonical-2-replicas.yaml")),
        chaos=bounce_schedule("b", period_s=60.0, down_s=10.0, count=4,
                              start_s=30.0, replicas_down=1),
        device="cpu")
    for sim in (plain, bounced):
        sim.run_summary(load, 2048, TorchDraws(0, "cpu"), block_size=1024)
    assert (32_768, 6) in [s for s, _ in seen]            # the pilots
    assert ((1024, 6), False) in seen and ((1024, 6), True) in seen
