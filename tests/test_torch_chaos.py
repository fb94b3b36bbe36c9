"""The port's chaos phases against the JAX package's, draw for draw.

Each case runs the same compiled tables, the same chaos schedule and
the same replayed draws (``tests/test_torch_replay.py``) through both
engines: outage windows, script truncation at the failing step, a
concurrent sibling of a failing call, a transport error one level up, a
partial replica kill, an entry that refuses connections and the offered
load that truncation shifts (the fixtures of ``tests/test_chaos.py``);
an overloaded partial kill whose backlog opens a drain window; ungraceful
kills (``drain=False``) of ``LONG_REQUEST`` from
``tests/test_stability.py``, once and as a bounce schedule; the skewed
tiled/sparse fixture of ``tests/test_sparse_tiles.py`` with a down hub
or a down worker; and ``realistic_topology(1000, "multitier")`` with an
outage on ``mock-7``.

Tolerances are the engine tests': ``hop_sent``, ``hop_error``,
``client_error`` and ``unstable`` exactly equal, floats within rtol
1e-5, atol 1e-9 s, except the latency of a request reset by an
ungraceful kill: it is ``t_kill - arrival``, and the arrival clock, a
float32 cumsum that XLA and torch associate differently, carries an
absolute rounding of a few float32 spacings of the clock into that
difference (measured: 9.5e-7 s, one spacing at 10 s, i.e. 3e-4 of a
3 ms reset); those latencies are held to four spacings of the last kill
time.  The static phase tables (cuts, effective replicas,
outage flags, reach multipliers, visits, drain windows, kill tables) are
plain float64 numpy in both packages and must be equal exactly.
"""
import jax
import numpy as np
import pytest

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.generators import (
    realistic_topology as jax_realistic,
)
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu_torch.sim import SimParams
from test_sparse_tiles import SKEWED
from test_stability import LONG_REQUEST
from test_torch_replay import run_both, scenario_pair, summaries_both


def reset_atol(kill_s: float) -> float:
    """Four float32 spacings of the clock at ``kill_s``."""
    return 4.0 * float(np.spacing(np.float32(kill_s)))

MU = 1.0 / SimParams().cpu_time_s
DET = dict(service_time="deterministic")

CHAIN = """
services:
- name: entry
  isEntrypoint: true
  script:
  - sleep: 10ms
  - call: mid
  - sleep: 50ms
- name: mid
"""

SIBLINGS = """
services:
- name: entry
  isEntrypoint: true
  script:
  - - call: down
    - call: slow
- name: down
- name: slow
  script:
  - sleep: 30ms
"""

THREE_LEVELS = """
services:
- name: top
  isEntrypoint: true
  script:
  - call: parent
- name: parent
  script:
  - call: dead
- name: dead
"""

SOLO4 = """
services:
- name: solo
  isEntrypoint: true
  numReplicas: 4
"""

ENTRY_SLEEP = """
services:
- name: entry
  isEntrypoint: true
  script:
  - sleep: 20ms
"""

TRUNCATION = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: flaky, probability: 50}
  - call: leaf
- name: flaky
- name: leaf
"""


def _chaos(service, start, end, down=None, drain=True):
    return dict(service=service, start_s=start, end_s=end,
                replicas_down=down, drain=drain)


# name: (topology, params, chaos, requests, open-loop qps)
FIXTURES = {
    "outage-window": (CHAIN, DET, [_chaos("mid", 50.0, 100.0)], 4000, 20.0),
    "concurrent-sibling": (SIBLINGS, DET, [_chaos("down", 0.0, 1e6)], 2000,
                           20.0),
    "one-level": (THREE_LEVELS, DET, [_chaos("dead", 0.0, 1e6)], 2000, 20.0),
    "partial-kill": (SOLO4, {}, [_chaos("solo", 2.0, 4.0, down=3)], 70_000,
                     0.9 * MU),
    "entry-refusal": (ENTRY_SLEEP, DET, [_chaos("entry", 50.0, 100.0)],
                      4000, 20.0),
    "truncation-load": (TRUNCATION, {}, [_chaos("flaky", 0.05, 0.1)],
                        4000, 0.4 * MU),
}


def _pair(yaml_text, params=None, **scenario):
    return scenario_pair(jax_compile_graph(JaxGraph.from_yaml(yaml_text)),
                         params, **scenario)


def assert_phase_tables_equal(jax_sim, sim):
    """The static (chaos x churn) phase tables, exactly."""
    np.testing.assert_array_equal(
        sim._phase_starts, np.asarray(jax_sim._phase_starts)
    )
    np.testing.assert_array_equal(
        sim._eff_pc_np, np.asarray(jax_sim._eff_replicas_pc)
    )
    np.testing.assert_array_equal(
        sim._down_pc_np, np.asarray(jax_sim._svc_down_pc)
    )
    np.testing.assert_array_equal(sim._mult_pc, jax_sim._mult_pc)
    np.testing.assert_array_equal(sim._visits_pc_np, jax_sim._visits_pc_np)
    np.testing.assert_array_equal(
        sim._visits.cpu().numpy(), np.asarray(jax_sim._visits)
    )
    assert sim._num_kill_events == jax_sim._num_kill_events
    if sim._num_kill_events:
        np.testing.assert_array_equal(
            sim._kill_t.numpy(), np.asarray(jax_sim._kill_t_np, np.float32)
        )
        np.testing.assert_array_equal(
            sim._kill_frac.numpy(),
            np.asarray(jax_sim._kill_frac_np, np.float32),
        )
        np.testing.assert_array_equal(
            sim._back_cum.numpy(),
            np.asarray(jax_sim._back_cum_np, np.float32),
        )


@pytest.mark.parametrize("name", list(FIXTURES))
def test_chaos_fixture_matches_reference(name):
    yaml_text, params, chaos, n, qps = FIXTURES[name]
    jax_sim, sim = _pair(yaml_text, params, chaos=chaos)
    assert_phase_tables_equal(jax_sim, sim)
    got = run_both(jax_sim, sim, n, jax.random.PRNGKey(5), kind="open",
                   qps=qps)
    if name == "outage-window":
        # the down callee fails every request of the window, truncated
        # after the failing step, and nothing outside it
        starts = got.client_start.numpy()
        inside = (starts >= 50.0) & (starts < 100.0)
        err = got.client_error.numpy()
        assert err[inside].all() and not err[~inside].any()
        assert not got.hop_sent[:, 1].numpy()[inside].any()
    if name == "truncation-load":
        # outage phase: flaky serves nothing, leaf only the half of the
        # requests that skipped the flaky call
        names = list(sim.compiled.services.names)
        assert sim._visits_pc_np[1, names.index("flaky")] == 0.0
        assert sim._visits_pc_np[1, names.index("leaf")] == pytest.approx(
            0.5
        )


def test_overloaded_partial_kill_opens_a_drain_window():
    """Three of four replicas down at twice one replica's capacity: the
    kill phase builds a backlog of 2 mu requests that the healthy phase
    drains at its free 2 mu/s, so the congested row stays live for one
    second past the window's end."""
    qps = 2.0 * MU
    jax_sim, sim = _pair(SOLO4, chaos=[_chaos("solo", 2.0, 4.0, down=3)])
    got_w = sim._windows_arg(qps, False).numpy()
    want_w = np.asarray(jax_sim._windows_arg(qps, False))
    np.testing.assert_array_equal(got_w, want_w)
    # (bounds, rows), padded to 2P - 1 windows by repeating the last
    np.testing.assert_allclose(got_w[0], [0.0, 2.0, 4.0, 5.0, 5.0],
                               rtol=1e-6)
    np.testing.assert_array_equal(got_w[1], [0, 1, 1, 2, 2])
    # saturated runs skip drains: the identity windows
    np.testing.assert_array_equal(
        sim._windows_arg(qps, True).numpy(),
        np.asarray(jax_sim._windows_arg(qps, True)),
    )
    got = run_both(jax_sim, sim, 156_000, jax.random.PRNGKey(3),
                   kind="open", qps=qps)
    assert bool(got.unstable.all())


@pytest.mark.parametrize("schedule", ["one-kill", "bounce"])
def test_ungraceful_kill_matches_reference(schedule):
    """``drain=False``: the requests resident on the killed worker
    replicas at each kill instant reset; the kill coins of event ``e``
    replay ``fold_in(block_key, 9_990_000 + e)``."""
    if schedule == "one-kill":
        chaos = [_chaos("worker", 10.0, 30.0, down=2, drain=False)]
    else:
        chaos = [
            _chaos("worker", 5.0 + 10.0 * i, 8.0 + 10.0 * i, down=2,
                   drain=False)
            for i in range(3)
        ]
    jax_sim, sim = _pair(LONG_REQUEST, chaos=chaos)
    assert_phase_tables_equal(jax_sim, sim)
    key = jax.random.PRNGKey(11)
    got = run_both(jax_sim, sim, 2000, key, kind="open", qps=50.0,
                   reset_atol=reset_atol(chaos[-1]["start_s"]))
    assert bool(got.client_error.any())
    # the blocks of a summary draw their own kill coins
    summaries_both(jax_sim, sim, 2048, key, 512, kind="open", qps=50.0,
                   atol=reset_atol(chaos[-1]["start_s"]))


# the skewed level's encodings of tests/test_torch_sparse.py
ENCODINGS = {
    "tiled": dict(sparse_level_elems=1),
    "tiled-residual": dict(sparse_level_elems=1, sparse_tile_pmax=3),
    "sparse": dict(sparse_level_elems=1, sparse_tiling=False),
}


@pytest.mark.parametrize("down", ["hub", "w1"])
@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_down_service_across_tiles_matches_reference(down, encoding):
    """An outage on the tiled level's hub (its caller's call is refused)
    or on one of the hub's workers (the hub's own call is refused and
    its row carries a fail step through the tiles, or through the
    sparse residual when the hub sits there)."""
    jax_sim, sim = _pair(SKEWED, ENCODINGS[encoding],
                         chaos=[_chaos(down, 0.05, 0.1)])
    assert sim._levels[1].join.kind == (
        "sparse" if encoding == "sparse" else "tiled")
    assert all(s[3] for s in sim.census_shapes(8))
    got = run_both(jax_sim, sim, 2048, jax.random.PRNGKey(7), kind="open",
                   qps=0.4 * MU)
    assert bool(got.hop_error[:, 1 if down == "w1" else 0].any())


def test_realistic_multitier_outage_matches_reference():
    """``realistic_topology(1000, "multitier")`` under a total outage of
    ``mock-7`` (the svc100k outage case at a tenth of its services'
    hundredth), Pareto service times, 256 requests at 100 qps."""
    jc = jax_compile_graph(JaxGraph.decode(
        jax_realistic(1000, archetype="multitier", seed=0)
    ))
    jax_sim, sim = scenario_pair(
        jc, dict(service_time="pareto", service_time_param=2.5),
        chaos=[_chaos("mock-7", 0.5, 1.5)],
    )
    assert_phase_tables_equal(jax_sim, sim)
    got = run_both(jax_sim, sim, 256, jax.random.PRNGKey(0), kind="open",
                   qps=100.0)
    starts = got.client_start.numpy()
    inside = (starts >= 0.5) & (starts < 1.5)
    names = list(sim.compiled.services.names)
    mock7 = sim.compiled.hop_service == names.index("mock-7")
    assert not got.hop_sent.numpy()[inside][:, mock7].any()
