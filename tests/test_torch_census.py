"""The port's census join against the JAX package's Pallas kernel.

``census_reference`` (the plain torch op chain, which the CPU path of
``isotope_tpu_torch.native.census.census`` runs) is held to
``isotope_tpu.native.census_pallas.census`` in interpret mode, on the
JAX package's own unaligned 13x37x5 fixture, at the realistic
topologies' wide steps (P = 20 with error flags, P = 46) and on a P=1
grid.  The
CUDA kernel itself is held to ``census_reference`` on the card by
``tests/test_torch_census_cuda.py`` and by ``chip_smoke.py``.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.native import census_pallas
from isotope_tpu_torch.native import census as census_mod

# The Pallas kernel (interpret mode) and the torch chain take the same
# float32 max / mask multiplies; only the step-axis prefix sum may
# associate differently (XLA's cumsum vs torch.cumsum), which bounds
# the difference by a few ULP of the running sum: rtol 1e-6, atol 0.
RTOL = 1e-6


def _fixture(n, b, p, with_fail, with_err, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (b, p)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, p)) > 0.3).astype(np.float32)
    agg = rng.uniform(0, 2, (n, b, p)).astype(np.float32)
    fail = (
        rng.integers(0, p + 1, (n, b)).astype(np.int32) if with_fail
        else None
    )
    err = rng.uniform(0, 1, (n, b)) > 0.7 if with_err else None
    return base, mask, agg, fail, err


def _jax(arrs):
    base, mask, agg, fail, err = arrs
    busy, excl = census_pallas.census(
        jnp.asarray(base), jnp.asarray(mask), jnp.asarray(agg),
        None if fail is None else jnp.asarray(fail),
        None if err is None else jnp.asarray(err),
        interpret=True,
    )
    return np.asarray(busy), np.asarray(excl)


def _torch(arrs, fn=census_mod.census_reference, device="cpu"):
    tensors = [
        None if a is None else torch.from_numpy(a).to(device) for a in arrs
    ]
    busy, excl = fn(*tensors)
    return busy.cpu().numpy(), excl.cpu().numpy()


@pytest.mark.parametrize("with_fail", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_reference_matches_pallas_kernel(with_fail, with_err):
    arrs = _fixture(13, 37, 5, with_fail, with_err)
    want_busy, want_excl = _jax(arrs)
    busy, excl = _torch(arrs)
    np.testing.assert_allclose(busy, want_busy, rtol=RTOL, atol=0)
    np.testing.assert_allclose(excl, want_excl, rtol=RTOL, atol=0)


@pytest.mark.parametrize(
    "shape,with_fail,with_err",
    [
        ((16, 25, 20), False, True),   # realistic-powerlaw-100's wide level
        ((16, 1, 46), False, False),   # realistic-star-50's hub
    ],
)
def test_reference_matches_pallas_kernel_wide_steps(shape, with_fail,
                                                     with_err):
    """The step widths of the realistic topologies, whose prefix sums
    run over 20 and 46 steps."""
    arrs = _fixture(*shape, with_fail, with_err, seed=5)
    want_busy, want_excl = _jax(arrs)
    busy, excl = _torch(arrs)
    np.testing.assert_allclose(busy, want_busy, rtol=RTOL, atol=0)
    np.testing.assert_allclose(excl, want_excl, rtol=RTOL, atol=0)


@pytest.mark.parametrize(
    "shape,with_fail,with_err",
    [((13, 37, 5), True, True), ((16, 25, 20), False, True),
     ((8, 3, 300), True, False)],
)
def test_sequential_twin_matches_pallas_kernel(shape, with_fail, with_err):
    """``census_sequential``, the kernel's own order of operations, is
    the same function: it agrees with the Pallas kernel and with the
    plain chain to the prefix sum's rounding."""
    arrs = _fixture(*shape, with_fail, with_err, seed=7)
    want_busy, want_excl = _jax(arrs)
    busy, excl = _torch(arrs, fn=census_mod.census_sequential)
    np.testing.assert_allclose(busy, want_busy, rtol=RTOL, atol=0)
    np.testing.assert_allclose(excl, want_excl, rtol=RTOL, atol=0)


def test_reference_matches_pallas_kernel_single_step():
    """P = 1, the flagship's shape: no prefix sum to reassociate, so the
    two are bit-equal."""
    arrs = _fixture(64, 27, 1, True, True, seed=3)
    want_busy, want_excl = _jax(arrs)
    busy, excl = _torch(arrs)
    np.testing.assert_array_equal(busy, want_busy)
    np.testing.assert_array_equal(excl, want_excl)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper computes the plain version and launches
    nothing."""
    arrs = _fixture(13, 37, 5, True, True)
    before = census_mod.census.launches
    got = _torch(arrs, fn=census_mod.census)
    want = _torch(arrs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert census_mod.census.launches == before


def test_library_path_is_keyed_by_source():
    """The built library lives under native/_build and its name carries
    a digest of the source and flags, so an edited kernel rebuilds."""
    path = census_mod.LIBRARY.path()
    assert path.parent.name == "_build"
    assert path.name.startswith("libcensus-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in census_mod.NVCC_FLAGS


# -- the kernel's launch plan, on the CPU ----------------------------------


def _chip_smoke_shapes():
    """Every census shape ``chip_smoke.py`` holds the kernel at, from
    the same simulators (built here on the CPU), the scenario runs'
    (svc100k-chaos among them) and the lb runs' included."""
    import sys
    from types import SimpleNamespace

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    from isotope_tpu_torch.compiler import compile_graph, compile_lb
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        tree_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
    from isotope_tpu_torch.sim.config import (
        ChaosEvent,
        MtlsSchedule,
        TrafficSplit,
        bounce_schedule,
    )

    port = SimpleNamespace(compile_graph=compile_graph, compile_lb=compile_lb,
                           ServiceGraph=ServiceGraph, LoadModel=LoadModel,
                           Simulator=Simulator,
                           realistic_topology=realistic_topology,
                           with_call_policy=with_call_policy,
                           SimParams=SimParams, ChaosEvent=ChaosEvent,
                           TrafficSplit=TrafficSplit,
                           MtlsSchedule=MtlsSchedule,
                           bounce_schedule=bounce_schedule,
                           DEFAULT_ENVIRONMENTS=DEFAULT_ENVIRONMENTS)
    flagship = ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))
    runs = chip_smoke.main_path_runs(port, flagship, device="cpu")
    runs += [run[:5] for run in
             chip_smoke.scenario_runs(port, {}, device="cpu")
             + chip_smoke.lb_runs(port, device="cpu")]
    return chip_smoke.census_check_shapes(
        runs, chip_smoke.census_only_configs(port, device="cpu"),
    )


_SHAPES = _chip_smoke_shapes()


def _conflict_free(plan, p):
    """The threads of one shared-memory wavefront (32 / V of them, each
    reading V floats of its own row at the same step) hit distinct
    banks."""
    lanes = 32 // plan.vec
    for q in range(0, min(p, plan.chunk), plan.vec):
        for first in (0, lanes):
            words = [(first + i) * plan.pitch + q for i in range(lanes)]
            if len({(w // plan.vec) % lanes for w in words}) != lanes:
                return False
    return True


def test_chip_smoke_covers_the_wide_and_stream_paths():
    paths = {census_mod.launch_plan(n, b, p).path for n, b, p, _, _ in
             _SHAPES}
    assert paths == {"stream", "tile", "wide"}
    assert (335544, 25, 20, False, True) in _SHAPES
    assert (64, 3, 4096, True, True) in _SHAPES


def test_chip_smoke_covers_the_star10k_tiles_and_qps_max():
    """Every census call of one star-10k block (3,355 requests): the
    root's 1 x 5,021 steps, the tiles of level 1 and the dense levels
    below, all with a fail step (30 s timeouts) and no error flags; and
    the -qps max run's calls at its block and at its pilots'."""
    star = [
        (3355, 1, 5021), (3355, 4950, 1), (3355, 23, 3), (3355, 16, 8),
        (3355, 10, 15), (3355, 14, 51), (3355, 4641, 38), (3355, 330, 3),
    ]
    for n, b, p in star:
        assert (n, b, p, True, False) in _SHAPES
    assert census_mod.launch_plan(3355, 1, 5021).path == "wide"
    for n in (524_288, 32_768):
        assert (n, 3, 2, False, False) in _SHAPES
        assert (n, 1, 2, False, False) in _SHAPES


def test_chip_smoke_covers_the_scenario_runs():
    """svc100k-chaos's 31 calls of one block (335 requests), from its
    1 x 46 root to its 13,026 x 19 level, and the canonical-2-replicas
    runs' calls, all with a fail step (a down callee can fail any
    call)."""
    svc100k = [s for s in _SHAPES if s[0] == 335]
    assert len(svc100k) == 31 and all(s[3] and not s[4] for s in svc100k)
    assert (335, 1, 46, True, False) in svc100k
    assert (335, 13026, 19, True, False) in svc100k
    for n in (262_144, 524_288):
        assert (n, 3, 2, True, False) in _SHAPES
        assert (n, 1, 2, True, False) in _SHAPES


def test_chip_smoke_covers_the_lb_runs():
    """The panic run's one call a block carries both a fail step (a
    chaos run) and error flags (the panic coins), with no errorRate
    anywhere in its topology; lb-1000svc-lr makes the fifo 1000-svc
    run's calls."""
    assert (240_000, 1, 1, True, True) in _SHAPES
    for b in (216, 36, 6, 1):
        assert (32_768, b, 1, False, False) in _SHAPES


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(
    map(str, s[:3])) + f"-f{int(s[3])}e{int(s[4])}")
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_plan(shape, aligned):
    n, b, p = shape[:3]
    plan = census_mod.launch_plan(n, b, p, aligned, 132)
    # shared memory: within a block's 227 KB, opted in above 48 KB, and
    # the blocks the grid keeps resident per SM fit its 228 KB
    assert 0 <= plan.smem_bytes <= census_mod.SMEM_BLOCK_MAX
    assert plan.opt_in == (plan.smem_bytes > 48 * 1024)
    assert plan.threads <= 256 and plan.threads % 32 == 0
    assert plan.blocks >= 1
    rows = n * b
    # the grid never asks for more blocks than the SMs hold at once
    assert plan.blocks <= 132 * census_mod._resident(plan.threads,
                                                     plan.smem_bytes)
    assert (plan.threads * census_mod.REGS_THREAD
            * census_mod._resident(plan.threads, plan.smem_bytes)
            <= census_mod.REGS_SM)
    if plan.path == "stream":
        assert p <= census_mod.STREAM_MAX_P
        assert plan.smem_bytes == 0 and not plan.tables_in_smem
        return
    assert p > census_mod.STREAM_MAX_P
    # the very-wide path exactly when a tile of whole rows does not fit
    whole = census_mod.STAGES * (
        census_mod.MIN_TILE_ROWS * census_mod._pitch(p, plan.vec) * 4
        + census_mod.MIN_TILE_ROWS * 5
    )
    assert (plan.path == "wide") == (whole > census_mod.SMEM_BLOCK_MAX)
    assert plan.chunk == (census_mod.WIDE_CHUNK if plan.path == "wide"
                          else p)
    if plan.path == "wide":
        # one row per thread: its running sum stays in a register
        assert plan.tile_rows == plan.threads
    # tiles: whole multiples of 16 rows, so 16-byte boundaries and byte
    # counts in both memories
    assert plan.tile_rows % 16 == 0 and plan.tile_rows % plan.threads == 0
    assert (plan.tile_rows * p * 4) % 16 == 0
    assert (plan.tile_rows * plan.pitch * 4) % 16 == 0
    assert plan.stage_bytes % 16 == 0 and plan.table_bytes % 16 == 0
    assert plan.stage_bytes == (plan.tile_rows * plan.pitch * 4
                                + plan.tile_rows * 4 + plan.tile_rows)
    assert plan.smem_bytes == (census_mod.STAGES * plan.stage_bytes
                               + plan.table_bytes)
    assert plan.tables_in_smem == (plan.table_bytes > 0)
    if plan.tables_in_smem:
        assert plan.table_bytes >= 2 * b * plan.pitch * 4
    per_sm = -(-plan.blocks // 132)
    assert per_sm * (plan.smem_bytes + census_mod.SMEM_RESERVED) <= (
        census_mod.SMEM_SM)
    assert plan.blocks <= -(-rows // plan.tile_rows)
    # vector reads: V divides P and the chunk, rows stay V-aligned, and
    # the pitch makes them free of bank conflicts
    assert p % plan.vec == 0 and plan.chunk % plan.vec == 0
    assert plan.pitch % plan.vec == 0 and plan.pitch >= plan.chunk
    assert (plan.pitch // plan.vec) % 2 == 1
    assert _conflict_free(plan, p)


def test_launch_plan_matches_the_kernels_plan_layout():
    """``LaunchPlan.as_ints`` fills the C ``Plan`` struct field by
    field."""
    src = (pathlib.Path(census_mod.__file__).parent / "csrc" /
           "census.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"int32_t (\w+);", body)
    plan = census_mod.launch_plan(4096, 25, 20)
    assert len(fields) == len(plan.as_ints())
    values = dict(zip(fields, plan.as_ints()))
    assert values["path"] == 1 and values["vec"] == plan.vec
    assert values["stage_bytes"] == plan.stage_bytes
    assert values["opt_in"] == int(plan.smem_bytes > 48 * 1024)
