"""The CUDA census kernel against its plain torch version, on the card.

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import nothing of JAX, so they also run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_census_cuda.py``.
"""
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
    assert card_sim._levels[1].tiled is not None
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
