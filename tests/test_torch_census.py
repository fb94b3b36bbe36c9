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
    (svc100k-chaos among them), the lb runs' and the protected runs'
    included."""
    import sys
    from types import SimpleNamespace

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    from isotope_tpu_torch.compiler import (
        compile_graph,
        compile_lb,
        compile_policies,
        compile_rollouts,
    )
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        tree_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.runner.run import protected_window_block
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
                           DEFAULT_ENVIRONMENTS=DEFAULT_ENVIRONMENTS,
                           compile_policies=compile_policies,
                           compile_rollouts=compile_rollouts,
                           protected_window_block=protected_window_block)
    flagship = ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))
    runs = chip_smoke.main_path_runs(port, flagship, device="cpu")
    runs += [run[:5] for run in
             chip_smoke.scenario_runs(port, {}, device="cpu")
             + chip_smoke.lb_runs(port, device="cpu")
             + chip_smoke.protected_runs(port, device="cpu")]
    chaos_sim = chip_smoke.chaosfleet_sim(port, device="cpu")
    storm = chip_smoke.storm_sim(port, device="cpu")
    runs += chip_smoke.fleet_census_runs(runs, chaos_sim)
    runs += chip_smoke.search_census_runs(
        runs, chip_smoke.planted_sim(port, device="cpu"), storm)
    runs += chip_smoke.runner_census_runs(device="cpu")
    runs += chip_smoke.calibration_census_runs(device="cpu")
    runs += chip_smoke.mesh_census_runs(port, device="cpu")
    runs += chip_smoke.mesh_served_census_runs(runs)
    _MESH_SERVED.extend(chip_smoke.mesh_served_census_runs(runs))
    return chip_smoke.census_check_shapes(
        runs, chip_smoke.census_only_configs(port, device="cpu"),
        chip_smoke.fleet_pilot_shapes(port, runs, chaos_sim, storm,
                                      device="cpu")
        + chip_smoke.mesh_extra_shapes(runs),
    )


_MESH_SERVED = []
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


def test_chip_smoke_covers_the_protected_runs():
    """policies-1000svc-kill's 4 calls a block of 506 requests over its
    66,196 unrolled hops, each with a fail step (timeouts) and error
    flags (breaker sheds); the rollout runs' 12 calls of 6,500 requests,
    with error flags only where the canary can 500; the smoke's one."""
    for b in (5_832, 324, 18, 1):
        assert (506, b, 1, True, True) in _SHAPES
    rollouts = [s for s in _SHAPES if s[0] == 6_500]
    assert len(rollouts) == 24
    assert sum(s[4] for s in rollouts) == 12
    assert (8_192, 1, 1, True, True) in _SHAPES


def test_chip_smoke_covers_the_folded_fleet():
    """ensembleN folded: one census call a level with children of the
    1000-service graph over 32 x 8,192 rows (no fail step, no error
    flags), and svc1000-chaosfleet's members at block 4,096 with the
    retry budget's fail step; each call's plan keeps its int64 row
    offsets inside the grid (``launch_plan`` at 262,144 rows)."""
    folded = [(32 * 8_192, b, 1, False, False) for b in (216, 36, 6, 1)]
    assert set(folded) <= set(_SHAPES)
    for n, b, p, _, _ in folded:
        plan = census_mod.launch_plan(n, b, p)
        assert plan.path == "stream" and plan.blocks >= 1
    assert any(s[0] == 4_096 and s[3] for s in _SHAPES)


def test_chip_smoke_covers_the_folded_chaos_and_protected_fleets():
    """The folded fleets of the chaos, protected and observed kinds:
    svc1000-chaosfleet's 8 x 4,096 rows a level of the 1000-service
    graph with the kill's fail steps, ensembleN-observed's 8 x 8,192,
    and the protected bracket's rungs of 16 and 4 x 2,048 rows (and its
    map twin's 2,048) on the storm topology, its one call a block with
    a fail step (timeouts, the kill) and error flags (errorRate,
    breaker sheds)."""
    assert {(8 * 4_096, b, 1, True, False) for b in (216, 36, 6, 1)} <= \
        set(_SHAPES)
    assert {(8 * 8_192, b, 1, False, False) for b in (216, 36, 6, 1)} <= \
        set(_SHAPES)
    for m in (16, 4, 1):
        assert (m * 2_048, 1, 1, True, True) in _SHAPES, m


def test_chip_smoke_covers_the_fleet_pilots():
    """The folded pilots a fleet's auto chunk is sized from
    (``costmodel.fleet_member_bytes``): one member's blocks of 8 and 16
    requests of the 1000-service graph (ensembleN, search64), of 64 and
    128 at 64 connections (ensembleN-closed), and of the storm's one
    protected call a block with its fail step and error flags."""
    for n in (8, 16, 64, 128):
        assert {(n, b, 1, False, False) for b in (216, 36, 6, 1)} <= \
            set(_SHAPES), n
    for n in (8, 16):
        assert (n, 1, 1, True, True) in _SHAPES, n


def test_chip_smoke_covers_the_search_rungs():
    """The brackets' folded calls: search64's rungs of 64, 16 and 4
    survivors x 4,096 rows a level of the 1000-service graph (rung 0 is
    ensembleN's 262,144 rows), and the planted winner's rungs of 16 and 4
    x 64 rows, whose entry level carries error flags (the entry at 2%
    errors)."""
    for m in (64, 16, 4):
        rows = [(m * 4_096, b, 1, False, False) for b in (216, 36, 6, 1)]
        assert set(rows) <= set(_SHAPES), m
        for n, b, p, _, _ in rows:
            assert census_mod.launch_plan(n, b, p).path == "stream"
    for m in (16, 4):
        planted = [s for s in _SHAPES if s[0] == m * 64]
        assert len(planted) >= 4 and any(s[4] for s in planted), m


def test_chip_smoke_covers_the_mesh_path():
    """Phase 11's census calls: the 1,024-service tree of the
    reference dryrun (5 dense levels with children, no fail step, no
    error flags) at one shard's 32,768 rows, the half-block rung's
    16,384, the tail pilot's 8,192 and the CPU twin's 2,048; a shard of
    a mesh run calls the census at its Simulator's solo shapes."""
    from types import SimpleNamespace

    import chip_smoke
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator

    port = SimpleNamespace(
        compile_graph=compile_graph, ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, SimParams=SimParams, Simulator=Simulator)
    (run,) = chip_smoke.mesh_census_runs(port, device="cpu")
    sim = run[1]
    assert sim.compiled.num_services == sim.compiled.num_hops == 1_024
    for n in (32_768, 16_384, 8_192, 2_048):
        shapes = sim.census_shapes(n)
        assert len(shapes) == 5 and set(shapes) <= set(_SHAPES), n
        assert not any(f or e for _, _, _, f, e in shapes)
    assert chip_smoke._pilot_blocks(2 * 32_768) == (8_192, 8_192)


def test_chip_smoke_covers_the_mesh_auto_sweep():
    """Phase 11's ``--mesh auto`` sweep (``mesh_auto_run``) runs the
    1,024-service tree at the runner's memory-sized block: one shard's
    32,768 rows, the shapes above, in ``MESH_BLOCKS`` blocks."""
    from types import SimpleNamespace

    import chip_smoke
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator

    port = SimpleNamespace(
        compile_graph=compile_graph, ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, SimParams=SimParams, Simulator=Simulator)
    (run,) = chip_smoke.mesh_census_runs(port, device="cpu")
    n = chip_smoke.MESH_BLOCKS * chip_smoke.MESH_BLOCK
    assert min(run[1].default_block_size(), n) == chip_smoke.MESH_BLOCK
    assert set(run[1].census_shapes(chip_smoke.MESH_BLOCK)) <= set(_SHAPES)


def test_chip_smoke_covers_the_mesh_served_paths():
    """Phase 11's mesh-served twins: the 2x2x2 twin folds ensembleN 4
    members a shard (4 x 8,192 rows) and search64's rungs 8 / 2 / 1
    (x 4,096); the 4x1x2 twin runs policies-1000svc-kill and
    rollouts-multitier-1000-bad in a shard's
    ``protected_window_block(..., shards=8)`` (1,250 rows of the
    former's 10,000-request window, capped at its memory-sized block of
    506 rows: 33,554,432 elements over 66,196 hops); phase 3 holds every
    census call
    of each, and of the CPU checks' card runs, with its policy flag.
    The world of one runs the solo shapes."""
    import chip_smoke

    by_name = {r[0]: r for r in _MESH_SERVED}
    assert by_name["mesh twin ensembleN (4 folded)"][4] == 4 * 8_192
    for m in (8, 2, 1):
        assert by_name[f"mesh twin search64 ({m} folded)"][4] == m * 4_096
    kill = by_name["mesh twin policies-1000svc-kill"]
    assert kill[4] == min(kill[1].default_block_size(), 10_000 // 8)
    assert kill[1]._policies is not None
    assert len(_MESH_SERVED) == 11
    for name, sim, _, _, block in _MESH_SERVED:
        shapes = chip_smoke.census_calls(sim, block)
        assert shapes and set(shapes) <= set(_SHAPES), name


def test_chip_smoke_covers_the_runner_suite():
    """The suite's cases: ``canonical.yaml`` closed loops at 16
    connections of cpu_mem.toml (2,400 to 192,000 rows a block, 240 s at
    10 to 800 qps), latency.toml's 240,000 rows and the paced rate
    pilot's 2,048, every census call of one block of each."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator

    root = pathlib.Path(__file__).resolve().parents[1]
    sim = Simulator(compile_graph(ServiceGraph.from_yaml_file(
        root / "examples" / "topologies" / "canonical.yaml")), device="cpu")
    for n in (2_048, 2_400, 24_000, 48_000, 96_000, 192_000, 240_000):
        shapes = sim.census_shapes(n)
        assert shapes and set(shapes) <= set(_SHAPES), n


def test_chip_smoke_covers_the_calibration_path(tmp_path):
    """Phase 9's census calls: ``fidelity``'s paced closed loop on
    ``canonical.yaml`` as the vendored artifact gives it (16 connections,
    262,143 requests in blocks of 65,536, and its 2,048-request rate
    pilot), the closure's source ``1000-svc_2000-end.yaml`` recorded at 8
    x 32,768 and its 16,384-request twin, and the fitted configuration's
    sweep at its default block: the fitted topology's structure, hence
    its census shapes, is the same whatever the recording's size, so a
    fit of another recording (4,096 requests, another seed) makes the
    calls phase 3 checks."""
    import chip_smoke
    from isotope_tpu_torch.runner.config import load_toml
    from isotope_tpu_torch.sim import TorchDraws

    sim, load, n, block = chip_smoke.fidelity_case("cpu")
    assert (load.kind, load.connections, n, block) == (
        "closed", 16, 262_143, 65_536)
    _, src = chip_smoke.calibration_sim("cpu")
    for sim_, rows in ((sim, block), (sim, 2_048), (src, 32_768),
                       (src, 16_384)):
        shapes = sim_.census_shapes(rows)
        assert shapes and set(shapes) <= set(_SHAPES), rows
    _, _, texts, _ = chip_smoke.record_source("cpu", 4_096, 4_096,
                                              TorchDraws(7, "cpu"))
    _, _, fr = chip_smoke.fit_texts(texts, tmp_path / "obs")
    (tmp_path / "fit.yaml").write_text(fr.graph.to_yaml())
    (tmp_path / "fit.toml").write_text(fr.toml_text)
    config = load_toml(tmp_path / "fit.toml")
    fitted = chip_smoke.runner_census_runs(
        device="cpu", configs=(tmp_path / "fit.toml",))
    (run,) = fitted
    default = run[1].default_block_size()
    shapes = run[1].census_shapes(default)
    assert config.load_kind == "open" and shapes
    assert set(shapes) <= set(_SHAPES)


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
