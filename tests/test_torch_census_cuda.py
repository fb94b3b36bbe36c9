"""The CUDA census kernel against its plain torch version, on the card.

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import nothing of JAX, so they also run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_census_cuda.py``.
"""
import pathlib

import numpy as np
import pytest
import torch

from isotope_tpu_torch.native import census as census_mod

# the card's torch.cumsum in the plain version may associate differently
# from the kernel's sequential scan over the step axis
RTOL = 1e-5

SHAPES = [
    (13, 37, 5),      # unaligned, several steps
    (4096, 27, 1),    # the flagship's widest census level, one step
    (240, 3, 2),      # short rows: the stream kernel at P = 2, 3, 4,
    (1001, 3, 3),     # with a ragged last group of rows
    (64, 5, 4),
    (257, 512, 64),   # wide scripts
    (4096, 25, 20),   # realistic-powerlaw-100's wide level
    (4096, 1, 46),    # realistic-star-50's hub
    (64, 3, 4096),    # rows too wide to stage whole: the chunked path
    (64, 1, 5021),    # the star-10k root
    (512, 14, 51),    # a star-10k tile
]


def _fixture(n, b, p, with_fail, with_err, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.uniform(0, 1, (b, p)).astype(np.float32),
        (rng.uniform(0, 1, (b, p)) > 0.3).astype(np.float32),
        rng.uniform(0, 2, (n, b, p)).astype(np.float32),
        rng.integers(0, p + 1, (n, b)).astype(np.int32) if with_fail
        else None,
        rng.uniform(0, 1, (n, b)) > 0.7 if with_err else None,
    ]
    return [None if a is None else torch.from_numpy(a).cuda() for a in arrs]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_fail", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_kernel_matches_reference(card, shape, with_fail, with_err):
    args = _fixture(*shape, with_fail, with_err)
    want_busy, want_excl = census_mod.census_reference(*args)
    before = census_mod.census.launches
    busy, excl = census_mod.census(*args)
    torch.cuda.synchronize()
    assert census_mod.census.launches == before + 1
    torch.testing.assert_close(busy, want_busy, rtol=RTOL, atol=0)
    torch.testing.assert_close(excl, want_excl, rtol=RTOL, atol=0)
    # the kernel's own order of operations: bit for bit
    seq_busy, seq_excl = census_mod.census_sequential(*args)
    assert torch.equal(busy, seq_busy) and torch.equal(excl, seq_excl)


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes (one element for
    float32 and int32, four for bool) past a 16-byte boundary."""
    if t is None:
        return None
    pad = 4 // t.element_size()
    flat = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    out = flat[pad:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4099, 3, 1), (1001, 3, 3), (13, 37, 5),
                                   (515, 7, 20), (5, 3, 300)])
def test_kernel_takes_unaligned_views(card, shape):
    """Inputs off 16-byte boundaries take the kernels' 4-byte copies,
    with the same results."""
    args = _fixture(*shape, True, True, seed=2)
    want = census_mod.census(*args)
    got = census_mod.census(*args[:2], *map(_unaligned, args[2:]))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    base, mask, agg, fail, err = _fixture(8, 4, 2, True, True)
    with pytest.raises(TypeError):
        census_mod.census(base, mask, agg, fail.to(torch.int64), err)
    with pytest.raises(ValueError):
        census_mod.census(base, mask, agg.transpose(0, 1), fail, err)
    with pytest.raises(ValueError):
        census_mod.census(base.cpu(), mask, agg, fail, err)


# a skewed level (one 7-step hub among leaves) that tiles with
# sparse_level_elems=1; w0's timeout fires mid-script
SKEWED = """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{call: hub}, {call: s0}, {call: s1}, {call: s2}]
- name: hub
  errorRate: 30%
  script:
  - sleep: 1ms
  - call: {service: w0, timeout: 3ms}
  - sleep: 2ms
  - call: w1
  - call: w2
  - sleep: 3ms
  - call: w3
- name: s0
- name: s1
- name: s2
- name: w0
  script: [{sleep: 5ms}]
- name: w1
- name: w2
  script: [{sleep: 1ms}]
- name: w3
"""


@pytest.mark.cuda
@pytest.mark.parametrize("tile_pmax", [64, 3])
def test_tiled_level_on_the_kernel_matches_the_cpu(card, tile_pmax):
    """A tiled level's census goes to the kernel on the card, one launch
    per tile that holds calls, and the run equals the CPU run on the
    plain version with the same draws (rtol 1e-5)."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
    from isotope_tpu_torch.sim import TorchDraws

    compiled = compile_graph(ServiceGraph.from_yaml(SKEWED))
    params = SimParams(sparse_level_elems=1, sparse_tile_pmax=tile_pmax)
    card_sim = Simulator(compiled, params, device="cuda")
    assert card_sim._levels[1].join.kind == "tiled"
    load = LoadModel(kind="open", qps=1000.0)
    source = TorchDraws(5, "cuda")
    before = census_mod.census.launches
    got = card_sim.run(load, 1024, source)
    torch.cuda.synchronize()
    assert census_mod.census.launches - before == len(
        card_sim.census_shapes(1024)
    )
    want = Simulator(compiled, params, device="cpu").run(load, 1024, source)
    for name in ("hop_sent", "hop_error", "client_error"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    for name in ("client_latency", "hop_latency", "hop_start"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=RTOL,
                                   atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_pmax", [None, 64, 3])
def test_panic_run_on_the_kernel_matches_the_cpu(card, tile_pmax):
    """Panic routing under chaos (lb laws): the panic coins reach the
    kernel as error flags beside the fail step on dense levels (tiles
    take none), and the run equals the CPU run on the plain version
    with the same draws (rtol 1e-5)."""
    from isotope_tpu_torch.compiler import compile_graph, compile_lb
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
    from isotope_tpu_torch.sim import TorchDraws
    from isotope_tpu_torch.sim.config import ChaosEvent

    graph = ServiceGraph.from_yaml(SKEWED.replace(
        "- name: hub\n", "- name: hub\n  numReplicas: 4\n"
    ) + "policies:\n  defaults:\n"
        "    lb: {policy: least_request, panic_threshold: 50%}\n"
        "  w1:\n    lb: {policy: ring_hash, hash_skew: 1.2}\n")
    compiled = compile_graph(graph)
    params = (
        SimParams() if tile_pmax is None
        else SimParams(sparse_level_elems=1, sparse_tile_pmax=tile_pmax)
    )
    chaos = (ChaosEvent("hub", 0.02, 0.1, replicas_down=3),)

    def make(device):
        return Simulator(compiled, params, chaos,
                         lb=compile_lb(graph, compiled), device=device)

    card_sim = make("cuda")
    assert any(s[3] and s[4] for s in card_sim.census_shapes(1024))
    load = LoadModel(kind="open", qps=10_000.0)
    source = TorchDraws(5, "cuda")
    before = census_mod.census.launches
    got = card_sim.run(load, 1024, source)
    torch.cuda.synchronize()
    assert census_mod.census.launches - before == len(
        card_sim.census_shapes(1024)
    )
    want = make("cpu").run(load, 1024, source)
    assert bool(want.hop_error.any())
    for name in ("hop_sent", "hop_error", "client_error"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    for name in ("client_latency", "hop_latency", "hop_start"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=RTOL,
                                   atol=1e-9)


def _pilot_launches(sim):
    """The census launches of a fresh Simulator's first folded fleet's
    pilots (``analysis/costmodel.fleet_member_bytes``: one fleet kind,
    an unrecorded and two recorded runs of one member for
    ``FLEET_PILOT_BLOCKS`` blocks of 8 and 16 requests)."""
    from isotope_tpu_torch.analysis.oplog import FLEET_PILOT_BLOCKS

    assert len(sim._fleet_pilots) == 1
    return 3 * FLEET_PILOT_BLOCKS * len(sim.census_shapes(8))


@pytest.mark.cuda
def test_folded_fleet_level_on_the_kernel_matches_the_cpu(card):
    """A folded fleet block (``run_ensemble`` in ``"vmap"`` mode) makes
    one census call a level over all M x N rows on the card, and the
    fleet equals the CPU's member-by-member fleet on the same draws:
    counts and histograms exactly, float sums within rtol 1e-5."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    compiled = compile_graph(ServiceGraph.from_yaml(SKEWED))
    card_sim = Simulator(compiled, device="cuda")
    load = LoadModel(kind="open", qps=1000.0)
    source = TorchDraws(5, "cuda")
    kw = dict(qps_jitter=0.1, cpu_jitter=0.05, error_jitter=0.2)
    before = census_mod.census.launches
    got = card_sim.run_ensemble(load, 1024, source, EnsembleSpec.from_jitter(
        4, mode="vmap", **kw), block_size=512)
    torch.cuda.synchronize()
    # two folded blocks, and the pilots the auto chunk is sized from
    assert census_mod.census.launches - before == 2 * len(
        card_sim.census_shapes(512, members=4)
    ) + _pilot_launches(card_sim)
    want = Simulator(compiled, device="cpu").run_ensemble(
        load, 1024, source, EnsembleSpec.from_jitter(4, mode="map", **kw),
        block_size=512)
    for name in ("count", "error_count", "hop_events", "latency_hist"):
        assert torch.equal(getattr(got.summaries, name).cpu(),
                           getattr(want.summaries, name)), name
    for name in ("latency_sum", "latency_max", "end_max"):
        torch.testing.assert_close(getattr(got.summaries, name).cpu(),
                                   getattr(want.summaries, name),
                                   rtol=RTOL, atol=1e-9)


@pytest.mark.cuda
def test_folded_bracket_rung_on_the_kernel_matches_the_cpu(card):
    """A search bracket whose rungs fold their survivors into one block
    (``"vmap"`` on the card: one census call a level over M x N rows)
    against the same bracket member by member on the CPU, on the same
    draws and tie-breaks: the same lineage, counts and histograms
    exactly, float sums within rtol 1e-5."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec

    compiled = compile_graph(ServiceGraph.from_yaml(SKEWED))
    load = LoadModel(kind="open", qps=1000.0)
    source = TorchDraws(6, "cuda")
    kw = dict(qps_jitter=0.1, cpu_jitter=0.05, error_jitter=0.5)
    runs = {}
    for device, mode in (("cuda", "vmap"), ("cpu", "map")):
        sim = Simulator(compiled, device=device)
        spec = SearchSpec(candidates=EnsembleSpec.from_jitter(
            8, mode=mode, **kw), eta=2, rungs=2)
        before = census_mod.census.launches
        runs[device] = sim.run_search(load, 1024, source, spec,
                                      block_size=512)
        if device == "cuda":
            torch.cuda.synchronize()
            # rung 0: 8 folded members, one block; rung 1: 4, one
            # block; and the pilots the auto chunk is sized from
            assert census_mod.census.launches - before == (
                len(sim.census_shapes(512, members=8))
                + len(sim.census_shapes(512, members=4))
                + _pilot_launches(sim)
            )
    got, want = runs["cuda"], runs["cpu"]
    assert got.mode == "vmap" and want.mode == "map"
    assert got.winner == want.winner
    for a, b in zip(got.rungs, want.rungs):
        np.testing.assert_array_equal(a.candidates, b.candidates)
        np.testing.assert_array_equal(a.order, b.order)
        for name in ("count", "error_count", "hop_events", "latency_hist"):
            assert torch.equal(getattr(a.summaries, name),
                               getattr(b.summaries, name)), name
        for name in ("latency_sum", "latency_max", "end_max"):
            torch.testing.assert_close(getattr(a.summaries, name),
                                       getattr(b.summaries, name),
                                       rtol=RTOL, atol=1e-9)


# -- the ragged census: the dense site of a mostly padded level --------------

STAR10K = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
           / "configs" / "star10k.json")


def ragged_level(seed, size=40, pmax=9, empty=0.8, sleep=0.3, calls=3,
                 uniform=None, device="cuda"):
    """A random dense level's tables as the engine holds them, as
    ``(step_base, step_mask, call_seg, call_hop, call_step, child_seg,
    uniform)``: ``size`` hops of at most ``pmax`` steps, a share
    ``empty`` of them without a step, real steps at random places, a
    share ``sleep`` of those pure sleeps and the rest with 1 to
    ``calls`` calls, calls and children (one a call) in shuffled level
    order.  ``uniform``: every step real with that many calls in order
    (the dense site's reshape-reduce path)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (size, pmax)).astype(np.float32)
    if uniform is not None:
        mask = np.ones((size, pmax), bool)
        seg = np.repeat(np.arange(size * pmax), uniform)
        child = seg
    else:
        mask = np.zeros((size, pmax), bool)
        for h in range(size):
            if h == 0 or rng.uniform() >= empty:
                w = int(rng.integers(1, pmax + 1))
                mask[h, rng.choice(pmax, w, replace=False)] = True
        real = np.flatnonzero(mask)
        per = np.where(rng.uniform(size=len(real)) < sleep, 0,
                       rng.integers(1, calls + 1, len(real)))
        per[0] = max(per[0], 1)
        seg = rng.permutation(np.repeat(real, per))
        child = rng.permutation(seg)

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return (t(base, torch.float32), t(mask, torch.float32),
            t(seg, torch.int64), t(seg // pmax, torch.int64),
            t(seg % pmax, torch.int32), t(child, torch.int64), uniform)


def ragged_inputs(plan, n, fail, err, nan=0.0, seed=0):
    """``(dur_call, final_transport, err)`` of ``n`` rows, on the plan's
    device: durations in [0, 2) with a share ``nan`` of NaNs, 5% of the
    calls transport-failed, 20% of the rows 500ing."""
    rng = np.random.default_rng(seed)
    dev = plan.step_base.device
    dur = rng.uniform(0, 2, (n, plan.num_calls)).astype(np.float32)
    dur[rng.uniform(size=dur.shape) < nan] = np.nan
    return (
        torch.from_numpy(dur).to(dev),
        torch.from_numpy(rng.uniform(size=dur.shape) < 0.05).to(dev)
        if fail else None,
        torch.from_numpy(rng.uniform(size=(n, plan.size)) < 0.2).to(dev)
        if err else None,
    )


def same_bits(got, want):
    """Equal bit for bit, NaN where NaN (a NaN's payload aside)."""
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
            continue
        if a.dtype.is_floating_point:
            nan = torch.isnan(a)
            assert torch.equal(nan, torch.isnan(b))
            a = torch.where(nan, 0.0, a).view(torch.int32)
            b = torch.where(nan, 0.0, b).view(torch.int32)
        assert torch.equal(a, b)


def _ragged_against_the_dense_chain(plan, args):
    """The kernel against the dense site's chain on the card, with the
    sequential join and with the dense kernel, bit for bit; each launch
    counts once in both counters."""
    before = (census_mod.census.launches, census_mod.census_ragged.launches)
    got = census_mod.census_ragged(plan, *args)
    torch.cuda.synchronize()
    assert (census_mod.census.launches,
            census_mod.census_ragged.launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = census_mod.census_ragged_reference(
        plan, *args, join=census_mod.census_sequential)
    same_bits(got, want)
    same_bits(got, census_mod.census_ragged_reference(
        plan, *args, join=census_mod.census))
    same_bits(got, census_mod.census_ragged_sequential(
        plan, *args, keep_nan=census_mod._scatter_keeps_nan(
            args[0].device)))
    return got


RAGGED_KINDS = {
    "scatter": dict(),
    # at most one hop in 16 with steps: the kernel walks them apart
    "rare": dict(size=400, empty=0.99),
    "uniform": dict(uniform=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 3355])
@pytest.mark.parametrize("kind", sorted(RAGGED_KINDS))
@pytest.mark.parametrize("fail,err", [(False, False), (True, False),
                                      (False, True), (True, True)])
@pytest.mark.parametrize("nan", [0.0, 0.01])
def test_ragged_kernel_equals_the_dense_chain(card, rows, kind, fail, err,
                                              nan):
    """Random levels (hops without a step, pure sleeps, several calls a
    step; the scatter and the uniform reshape-reduce paths; hops with
    steps rare enough that the kernel walks them apart) with fail steps,
    error flags and NaN durations."""
    plan = census_mod.ragged_plan(*ragged_level(rows, **RAGGED_KINDS[kind]))
    walkers, _ = census_mod.ragged_blocks(rows, plan.size,
                                          len(plan.walk_hops))
    assert (walkers > 0) == (kind == "rare")
    _ragged_against_the_dense_chain(
        plan, ragged_inputs(plan, rows, fail, err, nan, seed=rows))


def star10k_sim(device):
    import json

    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator

    config = json.loads(STAR10K.read_text())
    return Simulator(compile_graph(ServiceGraph.from_yaml(
        json.dumps(config["topology"]))), device=device)


@pytest.mark.cuda
def test_ragged_kernel_on_star10k_levels(card):
    """star10k's levels 2 (4,641 x 38, 330 real steps) and 3 (330 x 3, 7
    real steps) at the cell's 3,355 rows, with fail steps (30 s
    timeouts), error flags and NaNs."""
    sim = star10k_sim("cuda")
    assert [d for d, lvl in enumerate(sim._levels)
            if lvl.join.kind == "ragged"] == [2, 3]
    for d in (2, 3):
        plan = sim._levels[d].join.plan
        _ragged_against_the_dense_chain(
            plan, ragged_inputs(plan, 3355, True, True, 0.001, seed=d))


RAGGED_YAML = SKEWED.replace(
    "  - [{call: hub}, {call: s0}, {call: s1}, {call: s2}]\n",
    "  - [{call: hub}, {call: s0}, {call: s1}, {call: s2}, {call: s3}]\n",
).replace("- name: s2\n", "- name: s2\n- name: s3\n").replace(
    "  - call: w3\n", "  - call: {service: w3, timeout: 4ms, retries: 2}\n")


def _dense_twin(sim):
    """``sim`` with every level on the dense census (a ragged level on
    the dense join of its own tables)."""
    import dataclasses

    from isotope_tpu_torch.sim.joins import DenseJoin

    def dense(join):
        return join if join.kind != "ragged" else DenseJoin(*(
            getattr(join, f.name) for f in dataclasses.fields(DenseJoin)))

    sim._levels = tuple(dataclasses.replace(lvl, join=dense(lvl.join))
                        for lvl in sim._levels)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["star10k", "errors-retries"])
def test_ragged_run_equals_the_dense_run(card, case):
    """A whole block on the card with its padded levels on the ragged
    census equals the same block on the dense census, bit for bit:
    star10k (3,355 rows, 30 s timeouts) and a 5 x 7 level with a 30%
    error rate, a timeout that fires mid-script and retries."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws

    if case == "star10k":
        sims = [star10k_sim("cuda") for _ in range(2)]
        n, qps = 3355, 1000.0
    else:
        compiled = compile_graph(ServiceGraph.from_yaml(RAGGED_YAML))
        sims = [Simulator(compiled, device="cuda") for _ in range(2)]
        n, qps = 4096, 1000.0
    ragged, dense = sims[0], _dense_twin(sims[1])
    assert any(lvl.join.kind == "ragged" for lvl in ragged._levels)
    load = LoadModel(kind="open", qps=qps)
    before = census_mod.census_ragged.launches
    got = ragged.run(load, n, TorchDraws(7, "cuda"))
    assert census_mod.census_ragged.launches > before
    want = dense.run(load, n, TorchDraws(7, "cuda"))
    torch.cuda.synchronize()
    if case != "star10k":
        assert bool(want.hop_error.any())
    for name in ("hop_sent", "hop_error", "client_error", "client_latency",
                 "hop_latency", "hop_start", "client_start"):
        same_bits([getattr(got, name)], [getattr(want, name)])
