"""The port's phased closed loops against the JAX package's.

``-qps max`` under chaos or churn builds one finite-population table row
per (chaos x churn) phase (``Simulator._closed_tables``; a phased
fork-join row keeps the decomposition's cycle, no pilots), averages the
rows' throughputs over the phases a run spans (``_sat_phased_rate``),
places requests by a nominal clock warped piecewise from those rates,
and samples each request's wait from its phase row.  The paced closed
loop places requests by ``(req_offset + k) * C / rate``, with drain
windows after an overloaded phase, and its rate pilots see the same
windows.  Both packages build the tables with the same float64 numpy
code, so the rows and rates must be equal exactly.

Runs are compared draw for draw (``tests/test_torch_replay.py``):
booleans exactly; floats of the saturated runs within rtol 1e-4 plus
atol 1e-5 s (the far tail of the finite-population law, see
``tests/test_torch_closed.py``), of the paced runs within the engine
tests' rtol 1e-5, atol 1e-9 s.
"""
import pathlib

import jax
import numpy as np
import pytest

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim.config import bounce_schedule as jax_bounce
from isotope_tpu_torch.sim import LoadModel
from test_torch_replay import (
    JaxReplayDraws,
    run_both,
    scenario_pair,
    summaries_both,
)

TOPOLOGIES = pathlib.Path(__file__).resolve().parents[1] / "examples" / (
    "topologies"
)
CONNS = 64
SAT_RTOL, SAT_ATOL = 1e-4, 1e-5
MAX = dict(kind="closed", qps=None, connections=CONNS)

# a partial rolling restart of b, shortened from the chip run's 60 s
# period so a CPU-sized run crosses several windows
BOUNCE = [
    dict(service=e.service, start_s=e.start_s, end_s=e.end_s,
         replicas_down=e.replicas_down, drain=e.drain)
    for e in jax_bounce("b", period_s=2.0, down_s=0.5, count=4,
                        start_s=1.0, replicas_down=1)
]
CANARY_ROTATION = [dict(service="c", period_s=0.5,
                        weights=(1.0, 0.7, 0.4, 0.2))]
SCENARIOS = {
    "partial-bounce": dict(chaos=BOUNCE),
    "churn": dict(churn=CANARY_ROTATION),
}


def _pair(**scenario):
    jc = jax_compile_graph(JaxGraph.from_yaml_file(
        TOPOLOGIES / "canonical-2-replicas.yaml"
    ))
    return scenario_pair(jc, **scenario)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_phased_closed_tables_and_rate_match_reference(name):
    jax_sim, sim = _pair(**SCENARIOS[name])
    want = jax_sim._closed_tables(CONNS)
    got = sim._closed_tables(CONNS, JaxReplayDraws(jax.random.PRNGKey(0)))
    rows = len(sim._phase_starts) * sim._num_combos
    assert rows == (9 if name == "partial-bounce" else 4)
    np.testing.assert_array_equal(got[0], want[0])
    for i in (1, 2, 3, 5):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    for n in (1000, 16_384, 60_000, 10**7):
        assert sim._sat_phased_rate(got[0], n) == (
            jax_sim._sat_phased_rate(want[0], n)
        )
    assert sim.solve_closed_rate(
        LoadModel(**MAX), 32_768, JaxReplayDraws(jax.random.PRNGKey(0))
    ) == jax_sim.solve_closed_rate(JaxLoad(**MAX), 32_768,
                                   jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_phased_saturated_run_matches_reference(name):
    """One block of 32,768 requests (~2.8 s of warped nominal time: two
    bounce windows, or five churn cycles), then three blocks whose
    nominal clock carries the request offset."""
    jax_sim, sim = _pair(**SCENARIOS[name])
    key = jax.random.PRNGKey(4)
    got = run_both(jax_sim, sim, 32_768, key, rtol=SAT_RTOL,
                   atol=SAT_ATOL, **MAX)
    if name == "partial-bounce":
        # b is hop 2 of d's concurrent pair (a, c) and c's calls; its
        # down replica halves its capacity but never refuses a call
        assert not bool(got.client_error.any())
    summaries_both(jax_sim, sim, 3 * 8192, key, 8192, rtol=SAT_RTOL,
                   atol=SAT_ATOL, **MAX)


def test_paced_closed_loop_under_chaos_matches_reference():
    """b down to one replica in [0.5, 1.0) at 12,000 qps: its kill phase
    is overloaded (d and c each call b: 24,000 visits/s against one
    replica's 13,000/s), so a drain window
    keeps its row live past the cut; the rate pilots and the blocks see
    the same windows and the nominal clock across blocks."""
    chaos = [dict(service="b", start_s=0.5, end_s=1.0, replicas_down=1)]
    jax_sim, sim = _pair(chaos=chaos)
    load = dict(kind="closed", qps=12_000.0, connections=CONNS)
    key = jax.random.PRNGKey(6)
    lam = sim.solve_closed_rate(LoadModel(**load), 4 * 4096,
                                JaxReplayDraws(key))
    assert lam == jax_sim.solve_closed_rate(JaxLoad(**load), 4 * 4096, key)
    windows = sim._windows_arg(lam, False).numpy()
    np.testing.assert_array_equal(
        windows, np.asarray(jax_sim._windows_arg(lam, False))
    )
    # the kill row (1) stays live from 1.0 s until its backlog drains
    np.testing.assert_array_equal(windows[1], [0, 1, 1, 2, 2])
    assert windows[0][3] > 1.0
    summaries_both(jax_sim, sim, 4 * 4096, key, 4096, **load)
