"""The port's saturated closed loop (``-qps max``) against the JAX package's.

``isotope_tpu_torch/sim/closed.py`` is a copy of the reference's
closed-network model (numpy and scipy), so each of its functions must
give the reference's numbers exactly on the same inputs.  The engine's
tables on top of it (``Simulator._closed_tables``) are plain float64
numpy on chains (CHAIN3: bit for bit).  On fork-join topologies the
cycle is refined by pilot runs of the engine itself (five iterations of
two 32,768-request runs, drawn from the fixed pilot seed), whose float32
mean latencies round differently in XLA and torch: the converged
throughput agrees within rtol 1e-7 (measured: at most 1.5e-8 on TREE13,
STAR9 and ``canonical.yaml``), the tables within atol 1e-7 (p_zero) and
1e-9 (quantile coefficients).

Runs are compared draw for draw with replayed draws: booleans exactly,
floats within rtol 1e-5 except where stated.  The finite-population law
maps a centred normal z through ``u = ndtr(z)``, ``u' = (u - p0) / (1 -
p0)`` and ``v = -log1p(-u')``: in float32 ``u`` near 1 moves in steps of
1.2e-7 (``(2 - erfc) / 2``), and a step, which an ULP of z can cross
(the population copula's ``e . z`` sums over hops in another order in
XLA and torch), moves ``v`` by 1.2e-7 / (1 - u').  Measured: relative
differences up to 4.3e-5 on hop latencies beyond their 99th percentile,
and 2.6e-6 s (3.6e-4 of the request) on a CHAIN3 root whose draw sat at
u' = 1 - 4.5e-6.  Saturated runs are held to rtol 1e-4 plus atol 1e-5 s
on their float fields.
"""
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import closed as jax_closed
from isotope_tpu_torch.metrics.histogram import EDGES
from isotope_tpu_torch.sim import LoadModel, Simulator
from isotope_tpu_torch.sim import closed
from isotope_tpu_torch.sim.draws import SAT_PILOT_SEED
from test_oracle import CHAIN3, STAR9, TREE13
from test_torch_replay import (
    BOOL_FIELDS,
    FLOAT_FIELDS,
    JaxReplayDraws,
    port_compiled,
)

TOPOLOGIES = pathlib.Path(__file__).resolve().parents[1] / "examples" / (
    "topologies"
)
CONNS = 64
# the tail of the finite-population law, see the module docstring
SAT_RTOL, SAT_ATOL = 1e-4, 1e-5

FIXTURES = {
    "chain3": CHAIN3,
    "tree13": TREE13,
    "star9": STAR9,
    "canonical": (TOPOLOGIES / "canonical.yaml").read_text(),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX simulator, port simulator) of a fixture, shared by the tests
    of this file: the saturated tables each builds once do not depend on
    the run's key (their pilots draw from the fixed pilot seed)."""
    jc = jax_compile_graph(JaxGraph.from_yaml(FIXTURES[name]))
    return JaxSimulator(jc), Simulator(port_compiled(jc), device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- sim/closed.py, function by function --------------------------------------


def _model_inputs(name="tree13"):
    """Visits, cycle visits, replicas, mu and delay of a fixture, as the
    JAX engine feeds them to sim/closed.py."""
    jax_sim, _ = _pair(name)
    hs = jax_sim.compiled.hop_service
    visits = jax_sim._visits_pc_np[0]
    reps = np.maximum(
        np.asarray(jax_sim._eff_replicas_pc, np.float64)[0], 1.0
    )
    reach = jax_sim._reach_fj * jax_sim._mult_pc[0]
    cycle_visits = np.bincount(hs, weights=reach,
                               minlength=jax_sim.compiled.num_services)
    delay = float((reach * jax_sim._hop_delay_w).sum())
    return visits, cycle_visits, reps, jax_sim._mu, delay


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn", [
    "convolution_marginals", "mva_load_dependent", "fork_join_decomposition",
    "closed_network_tables",
])
@pytest.mark.parametrize("name", ["chain3", "tree13"])
def test_network_functions_match_reference(fn, name):
    visits, cycle_visits, reps, mu, delay = _model_inputs(name)
    args = {
        "convolution_marginals": (visits, reps, mu, delay, CONNS),
    }.get(fn, (visits, cycle_visits, reps, mu, delay, CONNS))
    _same(getattr(closed, fn)(*args), getattr(jax_closed, fn)(*args))


def test_station_functions_match_reference():
    visits, cycle_visits, reps, mu, delay = _model_inputs("star9")
    _same(closed.repairman_distribution(CONNS, 2, mu, 0.004),
          jax_closed.repairman_distribution(CONNS, 2, mu, 0.004))
    w = np.full(len(visits), 1.0 / mu)
    got = closed.repairman_marginals(visits, reps, mu, 0.005, w, CONNS)
    _same(got, jax_closed.repairman_marginals(visits, reps, mu, 0.005, w,
                                              CONNS))
    pi = got[0]
    _same(closed.census_sigma(pi), jax_closed.census_sigma(pi))
    for scv in (0.0, 0.5, 1.0, 25.0):
        _same(closed.compress_census(pi[1], scv),
              jax_closed.compress_census(pi[1], scv))
        _same(closed.tables_from_pi(pi, reps, mu, scv=scv),
              jax_closed.tables_from_pi(pi, reps, mu, scv=scv))


# -- the engine's tables and rate ---------------------------------------------


@pytest.mark.parametrize("name", list(FIXTURES))
def test_closed_tables_and_rate_match_reference(name):
    jax_sim, sim = _pair(name)
    key = jax.random.PRNGKey(5)
    source = JaxReplayDraws(key, jax_sim)
    want = jax_sim._closed_tables(CONNS)
    got = sim._closed_tables(CONNS, source)
    load = LoadModel(kind="closed", qps=None, connections=CONNS)
    lam = sim.solve_closed_rate(load, 4096, source)
    want_lam = jax_sim.solve_closed_rate(
        JaxLoad(kind="closed", qps=None, connections=CONNS), 4096, key
    )
    assert lam == float(_np(got[0])[0])
    fork_join = bool((jax_sim._fj_factors < 1.0).any())
    assert fork_join == (name != "chain3")
    if not fork_join:
        # plain float64 numpy from visits to tables: bit for bit, up to
        # the float32 cast of the device tables
        assert lam == want_lam
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        return
    np.testing.assert_allclose(lam, want_lam, rtol=1e-7)
    p0, coef, e, c, scale = (_np(x) for x in got[1:])
    np.testing.assert_allclose(p0, np.asarray(want[1]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(coef, np.asarray(want[2]), rtol=0, atol=1e-9)
    # the centering terms of the fork-join empirical target do not
    # depend on the cycle: exact
    np.testing.assert_array_equal(e, np.asarray(want[3]))
    np.testing.assert_array_equal(c, np.asarray(want[4]))
    np.testing.assert_array_equal(scale, np.asarray(want[5]))


def test_pilot_draws_replay_the_reference_keys():
    """Pilot (it, i) of the fork-join fixed point draws from
    ``fold_in(fold_in(PRNGKey(20_260_730), it), i)``, whatever the run's
    key; without a copula the saturated law still takes normals."""
    jax_sim, sim = _pair("chain3")
    spec = sim.draw_spec(64, "closed", saturated=True)
    assert spec.saturated and spec.normal_wait and not spec.copula
    source = JaxReplayDraws(jax.random.PRNGKey(99), jax_sim)
    got = source.with_seed(SAT_PILOT_SEED).draws((3, 1), spec)
    k = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(20_260_730), 3), 1
    )
    _, _, k_wait, _, _ = jax.random.split(k, 5)
    want = np.asarray(jax.random.normal(k_wait, (64, spec.hops)))
    np.testing.assert_array_equal(got.z_h.numpy(), want)
    assert got.u_wait is None


# -- runs, draw for draw --------------------------------------------------------


def _assert_close(got, want, rtol, atol):
    for name in BOOL_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name,
        )
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(
            _np(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )


@pytest.mark.parametrize("name", list(FIXTURES))
def test_saturated_run_matches_reference(name):
    """2,003 requests over 64 connections (the n % c remainder
    included), each engine on its own solved tables."""
    jax_sim, sim = _pair(name)
    key = jax.random.PRNGKey(3)
    want = jax_sim.run(
        JaxLoad(kind="closed", qps=None, connections=CONNS), 2003, key
    )
    got = sim.run(LoadModel(kind="closed", qps=None, connections=CONNS),
                  2003, JaxReplayDraws(key, jax_sim))
    _assert_close(got, want, SAT_RTOL, SAT_ATOL)
    assert not bool(got.hop_sent.logical_not().any())


@pytest.mark.parametrize("name", ["chain3", "canonical"])
def test_saturated_run_summary_matches_reference(name):
    """3 blocks of 1,024: counts exactly; sums, extremes and the run's
    end within the saturated tolerance; each quantile within one
    histogram bucket."""
    jax_sim, sim = _pair(name)
    key = jax.random.PRNGKey(4)
    want = jax_sim.run_summary(
        JaxLoad(kind="closed", qps=None, connections=CONNS), 3 * 1024, key,
        block_size=1024,
    )
    got = sim.run_summary(
        LoadModel(kind="closed", qps=None, connections=CONNS), 3 * 1024,
        JaxReplayDraws(key, jax_sim), block_size=1024,
    )
    for field in ("count", "error_count", "hop_events"):
        assert float(getattr(got, field)) == float(getattr(want, field))
    for field in ("latency_sum", "latency_min", "latency_max", "end_max"):
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=SAT_RTOL, atol=SAT_ATOL, err_msg=field,
        )
    np.testing.assert_array_equal(_np(got.unstable),
                                  np.asarray(want.unstable))
    qs = (0.5, 0.9, 0.99)
    ratio = got.quantiles_s(qs) / np.asarray(want.quantiles_s(qs))
    bucket = EDGES[3] / EDGES[2]
    assert np.all(ratio <= bucket * (1 + 1e-6))
    assert np.all(ratio >= 1 / bucket / (1 + 1e-6))
