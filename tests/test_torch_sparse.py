"""The port's tiled and sparse levels against the JAX package's.

A level whose dense (hops x steps) grid is pathological leaves the
dense encoding: by default it is tiled (hops binned by script width run
the dense census on fixed-width tiles, scripts wider than the tile cap
keep the sparse call-slot encoding as a residual), and with tiling off
the whole level takes the sparse encoding.  Each case runs the same
compiled tables and the same replayed draws through both engines
(``tests/test_torch_replay.py``), with ``sparse_level_elems=1`` forcing
the skewed fixture of ``tests/test_sparse_tiles.py`` off the dense grid.

Tolerances are the engine tests': ``hop_sent``, ``hop_error``,
``client_error`` and ``unstable`` exactly equal, floats within rtol
1e-5, atol 1e-9 s.  Within the port, a fully tiled level equals the
dense grid bit for bit (``torch.equal``): every tile runs the dense
census ops on its rows.
"""
import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.generators import (
    realistic_topology as jax_realistic,
)
from isotope_tpu.models.generators import with_call_policy as jax_policy
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from test_sparse_tiles import SKEWED
from test_torch_replay import (
    JaxReplayDraws,
    assert_results_match,
    port_compiled,
)

QPS = 0.4 / SimParams().cpu_time_s
N = 2048

# the skewed fixture's variants of tests/test_sparse_tiles.py
VARIANTS = {
    "plain": SKEWED,
    "error-rates": SKEWED.replace(
        "- name: hub\n", "- name: hub\n  errorRate: 30%\n"
    ).replace("- name: w1\n", "- name: w1\n  errorRate: 20%\n"),
    "send-probability": SKEWED.replace(
        "  - call: w1\n", "  - call: {service: w1, probability: 60}\n"
    ),
    "retries": SKEWED.replace(
        "  - call: w3\n", "  - call: {service: w3, retries: 2}\n"
    ).replace("- name: w3\n", "- name: w3\n  errorRate: 40%\n"),
    # fires on every request, mid-script: the hub's steps after w0 are
    # truncated and its later children are not sent
    "firing-timeout": SKEWED.replace(
        "  - call: w0\n", "  - call: {service: w0, timeout: 3ms}\n"
    ),
    "timeout-retries": SKEWED.replace(
        "  - call: w1\n",
        "  - call: {service: w1, timeout: 0.2ms, retries: 2}\n",
    ),
    "shared-slot-timeout": SKEWED.replace(
        "  - call: w1\n  - call: w2\n",
        "  - [{call: {service: w1, timeout: 0.1ms}}, {call: w2}]\n",
    ),
}

# a pure-sleep script wider than the tile cap: a residual hop with no
# call slot, beside a firing timeout elsewhere in the level
CALLFREE_WIDE = """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{call: hub}, {call: slow}, {call: s0}, {call: s1}, {call: s2},
     {call: s3}, {call: s4}]
- name: hub
  script:
  - sleep: 1ms
  - call: {service: w0, timeout: 3ms}
  - call: w1
- name: slow
  script:
  - sleep: 1ms
  - sleep: 1ms
  - sleep: 1ms
  - sleep: 1ms
  - sleep: 1ms
  - sleep: 1ms
- name: s0
- name: s1
- name: s2
- name: s3
- name: s4
- name: w0
  script: [{sleep: 5ms}]
- name: w1
"""

# (sparse_level_elems, sparse_tiling, sparse_tile_pmax): tiles only,
# tiles with the hub on the residual (cap 3 < its 7 steps), all sparse
ENCODINGS = {
    "tiled": dict(sparse_level_elems=1),
    "tiled-residual": dict(sparse_level_elems=1, sparse_tile_pmax=3),
    "sparse": dict(sparse_level_elems=1, sparse_tiling=False),
}


def _pair(yaml_text, **kw):
    jc = jax_compile_graph(JaxGraph.from_yaml(yaml_text))
    return (JaxSimulator(jc, JaxParams(**kw)),
            Simulator(port_compiled(jc), SimParams(**kw), device="cpu"))


def _encodings(sim):
    """Each level's join, the ragged census and a leaf as dense."""
    return [
        lvl.join.kind if lvl.join.kind in ("tiled", "sparse") else "dense"
        for lvl in sim._levels
    ]


def _check_against_reference(yaml_text, n=N, seed=7, **kw):
    jax_sim, sim = _pair(yaml_text, **kw)
    key = jax.random.PRNGKey(seed)
    want = jax_sim.run(JaxLoad(kind="open", qps=QPS), n, key)
    got = sim.run(LoadModel(kind="open", qps=QPS), n,
                  JaxReplayDraws(key, jax_sim))
    assert_results_match(got, want)
    return sim, got


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_skewed_level_matches_reference(variant, encoding):
    sim, got = _check_against_reference(
        VARIANTS[variant], **ENCODINGS[encoding]
    )
    enc = _encodings(sim)
    assert enc[1] == ("sparse" if encoding == "sparse" else "tiled")
    if encoding == "tiled-residual":
        tl = sim._levels[1].join
        assert tl.residual is not None and tl.res_size == 1  # the hub
    if variant == "firing-timeout":
        # the timeout fires on every request, mid-script: hub (hop 1)
        # 500s, w0 (hop 5) runs, w1..w3 (hops 6-8) are never sent
        assert bool(got.hop_error[:, 1].all())
        assert bool(got.hop_sent[:, 5].all())
        assert not bool(got.hop_sent[:, 6:9].any())


@pytest.mark.parametrize("encoding", ["tiled-residual", "sparse"])
def test_callfree_wide_hop_in_residual_matches_reference(encoding):
    sim, got = _check_against_reference(CALLFREE_WIDE, **ENCODINGS[encoding])
    if encoding == "tiled-residual":
        tl = sim._levels[1].join
        assert tl.residual is not None and tl.residual.n_slots == 0
    # the hub's timeout fires while 'slow' still runs whole
    assert bool(got.hop_error[:, 1].all())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiled_level_equals_dense_bitwise(variant):
    """A fully tiled level (tile cap 64 above every script width) is
    the dense grid's census on the tiles' rows: every output is equal
    bit for bit."""
    jc = jax_compile_graph(JaxGraph.from_yaml(VARIANTS[variant]))
    dense = Simulator(port_compiled(jc), SimParams(), device="cpu")
    tiled = Simulator(port_compiled(jc), SimParams(sparse_level_elems=1),
                      device="cpu")
    assert _encodings(dense)[1] == "dense"
    assert _encodings(tiled)[1] == "tiled"
    assert tiled._levels[1].join.residual is None
    load = LoadModel(kind="open", qps=QPS)
    a = dense.run(load, N, TorchDraws(3, "cpu"))
    b = tiled.run(load, N, TorchDraws(3, "cpu"))
    for name, x in a._asdict().items():
        y = getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name


def test_summary_through_tiles_matches_reference():
    jax_sim, sim = _pair(VARIANTS["firing-timeout"], **ENCODINGS["tiled"])
    key = jax.random.PRNGKey(2)
    want = jax_sim.run_summary(JaxLoad(kind="open", qps=QPS), 3 * 512, key,
                               block_size=512)
    got = sim.run_summary(LoadModel(kind="open", qps=QPS), 3 * 512,
                          JaxReplayDraws(key, jax_sim), block_size=512)
    for field in ("count", "error_count", "hop_events"):
        assert float(getattr(got, field)) == float(getattr(want, field))
    for field in ("latency_sum", "latency_min", "latency_max", "end_max"):
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=1e-5, err_msg=field,
        )


def test_census_shapes_list_each_tile_with_calls():
    """One census call per tile that holds calls, with the level's fail
    step and no error flags; none for the sparse residual."""
    _, sim = _pair(VARIANTS["error-rates"].replace(
        "  - call: w0\n", "  - call: {service: w0, timeout: 3ms}\n"
    ), sparse_level_elems=1)
    tiled = sim._levels[1].join
    assert tiled.kind == "tiled"
    want = [(8, len(t.hops), t.width, True, False) for t in tiled.tiles
            if t.num_calls]
    assert want and set(want) <= set(sim.census_shapes(8))
    # the entry level stays dense, with the error coins
    assert (8, 1, 1, False, True) in sim.census_shapes(8)


def test_star10k_with_timeouts_matches_reference():
    """BASELINE configs[3]: the 10,000-service star graph with 30 s
    timeouts.  Level 1 (5,021 hops, up to 2,217 steps) tiles, its eight
    widest hubs on the sparse residual, and carries the timeouts."""
    doc = jax_policy(jax_realistic(10_000, archetype="star", seed=0),
                     timeout="30s")
    jc = jax_compile_graph(JaxGraph.decode(doc))
    jax_sim = JaxSimulator(jc)
    sim = Simulator(port_compiled(jc), device="cpu")
    lvl = sim._levels[1]
    assert lvl.size == 5021 and lvl.pmax == 2217 and lvl.finite_timeout
    assert lvl.join.kind == "tiled" and lvl.join.res_size == 8
    assert sorted((len(t.hops), t.width) for t in lvl.join.tiles) == [
        (10, 15), (14, 51), (16, 8), (23, 3), (4950, 1)
    ]
    assert sim.census_shapes(3355)[-1] == (3355, 1, 5021, True, False)
    key = jax.random.PRNGKey(0)
    want = jax_sim.run(JaxLoad(kind="open", qps=6500.0), 64, key)
    got = sim.run(LoadModel(kind="open", qps=6500.0), 64,
                  JaxReplayDraws(key, jax_sim))
    assert_results_match(got, want)
