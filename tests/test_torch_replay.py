"""The JAX engine's draws, replayed for the port, and tests of the replay.

``JaxReplayDraws`` is a draw source for ``isotope_tpu_torch``'s engine
that rebuilds, from a JAX ``PRNGKey``, exactly the random tensors the
JAX engine draws for the same block (``isotope_tpu/sim/engine.py``:
key splits and static coin elimination at 4761-4880, arrivals at 4885,
service times at 4639-4660, block keys at 4543, pilot keys at 2066,
ungraceful-kill coins at 6104, lb panic coins at 5275-5288, the
protected runs' policy coins at 4775-4800 and version coins at
4805-4815).
Both engines then consume the same numbers, so their outputs can be
compared element by element.  ``test_torch_engine.py``,
``test_torch_summary.py`` and the scenario tests import these helpers
(``scenario_pair`` builds both engines under one chaos / churn / mTLS
scenario); the tests at the end of this file check the replay itself.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import config as jax_config
from isotope_tpu_torch.compiler import compiled_from_arrays, compiled_to_arrays
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
from isotope_tpu_torch.sim import config as port_config
from isotope_tpu_torch.sim.draws import (
    CANARY_INDEX,
    KILL_INDEX_BASE,
    PANIC_INDEX,
    POLICY_INDEX,
    SVC_EXPONENTIAL,
    SVC_NORMAL,
    Draws,
    index_path,
)

#: float tolerance of the engine comparisons: log, ndtr, cumsum and the
#: copula matmul round differently in XLA and torch by a few ULP
RTOL = 1e-5
ATOL = 1e-9  # seconds

BOOL_FIELDS = ("hop_sent", "hop_error", "client_error", "unstable")
FLOAT_FIELDS = (
    "client_start", "client_latency", "hop_latency", "hop_start",
    "utilization",
)


class JaxReplayDraws:
    """Draw source replaying the JAX engine's streams from ``key``.

    An index folds into the key (a tuple folds each of its integers in
    turn), and ``with_seed(s)`` replays from ``PRNGKey(s)``: the
    saturated closed loop's pilots, ``fold_in(fold_in(PRNGKey(
    20_260_730), it), i)`` in the JAX engine."""

    def __init__(self, key, jax_sim=None):
        self.key = key
        self.jax_sim = jax_sim

    def with_seed(self, seed):
        return JaxReplayDraws(jax.random.PRNGKey(seed), self.jax_sim)

    def draws(self, index, spec) -> Draws:
        if self.jax_sim is not None:
            check_spec(spec, self.jax_sim)
        k = self.key
        for i in index_path(index):
            k = jax.random.fold_in(k, i)
        if spec.copula:
            (k_send, k_err, k_wait_u, k_svc, k_arr, k_wait2,
             k_wait3) = jax.random.split(k, 7)
        else:
            k_send, k_err, k_wait_u, k_svc, k_arr = jax.random.split(k, 5)
        n, h = spec.n, spec.hops

        def put(x):
            return torch.from_numpy(np.asarray(x, np.float32).copy())

        out = Draws(
            u_send=(
                put(jax.random.uniform(k_send, (n, h)))
                if spec.need_send else None
            ),
            u_err=(
                put(jax.random.uniform(k_err, (n, h)))
                if spec.need_err else None
            ),
        )
        if spec.normal_wait:
            out = out._replace(z_h=put(jax.random.normal(k_wait_u, (n, h))))
        else:
            out = out._replace(
                u_wait=put(jax.random.uniform(k_wait_u, (n, h)))
            )
        if spec.copula:
            out = out._replace(
                z_small=(
                    put(jax.random.normal(k_wait2, (n, spec.sib_dim)))
                    if spec.sib_dim else None
                ),
                z_call=(
                    put(jax.random.normal(k_wait3, (n, spec.retry_dim)))
                    if spec.retry_dim else None
                ),
            )
        if spec.svc == SVC_EXPONENTIAL:
            out = out._replace(
                svc=put(jax.random.exponential(k_svc, (n, h)))
            )
        elif spec.svc == SVC_NORMAL:
            out = out._replace(svc=put(jax.random.normal(k_svc, (n, h))))
        if spec.arrivals:
            out = out._replace(
                arr=put(jax.random.exponential(k_arr, (n,)))
            )
        if spec.kill_events:
            out = out._replace(u_kill=torch.stack([
                put(jax.random.uniform(
                    jax.random.fold_in(k, KILL_INDEX_BASE + e), (n, h)
                ))
                for e in range(spec.kill_events)
            ]))
        if spec.panic:
            out = out._replace(u_panic=put(jax.random.uniform(
                jax.random.fold_in(k, PANIC_INDEX), (n, h)
            )))
        if spec.policy:
            k_shed, k_retry = jax.random.split(
                jax.random.fold_in(k, POLICY_INDEX)
            )
            if spec.shed:
                out = out._replace(
                    u_shed=put(jax.random.uniform(k_shed, (n, h)))
                )
            if spec.retry:
                out = out._replace(
                    u_retry=put(jax.random.uniform(k_retry, (n, h)))
                )
        if spec.canary:
            out = out._replace(u_canary=put(jax.random.uniform(
                jax.random.fold_in(k, CANARY_INDEX), (n, h)
            )))
        return out


def check_spec(spec, jax_sim) -> None:
    """The port asks for exactly the streams the JAX engine draws."""
    assert spec.hops == jax_sim.compiled.num_hops
    assert spec.need_send == jax_sim._need_send
    assert spec.need_err == jax_sim._need_err
    assert spec.copula == (jax_sim._copula_active or jax_sim._retry_active)
    want_sib = 0
    if jax_sim._copula_active:
        # the saturated law draws the flat (n, G) sibling normals
        want_sib = (
            jax_sim._copula_dim
            if jax_sim._copula_mix is not None and not spec.saturated
            else jax_sim._num_sib_groups
        )
    assert spec.sib_dim == want_sib
    assert spec.retry_dim == (
        jax_sim._num_retry_groups + 1 if jax_sim._retry_active else 0
    )
    assert spec.kill_events == jax_sim._num_kill_events
    # the JAX engine draws panic coins when an active lb table has a
    # panic threshold and chaos (or, in a protected block, the policy
    # state) can unhealth a pool (no -qps max)
    assert spec.panic == (
        jax_sim._lb_dev is not None and jax_sim._lb.any_panic
        and (jax_sim.has_chaos or spec.policy) and not spec.saturated
    )
    # policy coins only in blocks under policy effects, version coins
    # only in blocks under rollout effects
    pol = jax_sim._policies
    assert not spec.policy or pol is not None
    assert spec.shed == (spec.policy and pol.any_breaker)
    assert spec.retry == (
        spec.policy and pol.any_budget and jax_sim._has_retries
    )
    assert not spec.canary or jax_sim._rollouts is not None


def port_compiled(jax_compiled):
    """The JAX package's compiled tables, carried into the port."""
    return compiled_from_arrays(compiled_to_arrays(jax_compiled))


def scenario_pair(jax_compiled, params=None, chaos=(), churn=(),
                  mtls=None, lb=(None, None), policies=(None, None),
                  rollouts=(None, None)):
    """(JAX simulator, port simulator on the CPU) of one compiled graph
    under one scenario.  ``params``: a dict of ``SimParams`` fields, or
    a (JAX params, port params) pair; ``chaos`` and ``churn`` are lists
    of ``ChaosEvent`` / ``TrafficSplit`` keyword dicts and ``mtls`` one
    of ``MtlsSchedule``, each built in both packages; ``lb``,
    ``policies`` and ``rollouts`` are (JAX, port) pairs of
    ``compile_lb`` / ``compile_policies`` / ``compile_rollouts``
    tables."""
    if params is None or isinstance(params, dict):
        jax_params = JaxParams(**(params or {}))
        port_params = SimParams(**(params or {}))
    else:
        jax_params, port_params = params

    def both(kind, kw):
        return (getattr(jax_config, kind)(**kw),
                getattr(port_config, kind)(**kw))

    chaos_pairs = [both("ChaosEvent", kw) for kw in chaos]
    churn_pairs = [both("TrafficSplit", kw) for kw in churn]
    mtls_pair = both("MtlsSchedule", mtls) if mtls else (None, None)
    jax_sim = JaxSimulator(
        jax_compiled, jax_params, tuple(a for a, _ in chaos_pairs),
        tuple(a for a, _ in churn_pairs), mtls_pair[0], lb=lb[0],
        policies=policies[0], rollouts=rollouts[0],
    )
    sim = Simulator(
        port_compiled(jax_compiled), port_params,
        tuple(b for _, b in chaos_pairs), tuple(b for _, b in churn_pairs),
        mtls_pair[1], lb=lb[1], policies=policies[1],
        rollouts=rollouts[1], device="cpu",
    )
    return jax_sim, sim


def run_both(jax_sim, sim, n, key, reset_atol=None, atol=ATOL,
             rtol=RTOL, **load):
    """``run`` of both engines on the same draws; the port's results
    are held to the JAX engine's (``reset_atol``, ``atol``, ``rtol``:
    see :func:`assert_results_match`) and returned."""
    want = jax_sim.run(JaxLoad(**load), n, key)
    got = sim.run(LoadModel(**load), n, JaxReplayDraws(key, jax_sim))
    assert_results_match(got, want, reset_atol, atol, rtol)
    return got


#: summary fields compared exactly, and within rtol
SUMMARY_EXACT = ("count", "error_count", "hop_events")
SUMMARY_CLOSE = ("latency_sum", "latency_min", "latency_max", "end_max")


def summaries_both(jax_sim, sim, n, key, block_size, rtol=1e-5,
                   atol=0.0, **load):
    """``run_summary`` of both engines on the same draws (blocks carry
    the clocks); counts exactly, sums within ``rtol`` / ``atol`` s."""
    want = jax_sim.run_summary(JaxLoad(**load), n, key,
                               block_size=block_size)
    got = sim.run_summary(LoadModel(**load), n,
                          JaxReplayDraws(key, jax_sim),
                          block_size=block_size)
    for field in SUMMARY_EXACT:
        assert float(getattr(got, field)) == float(getattr(want, field)), (
            field
        )
    for field in SUMMARY_CLOSE:
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=rtol, atol=atol, err_msg=field,
        )
    return got


def assert_results_match(port_res, jax_res, reset_atol=None,
                         atol=ATOL, rtol=RTOL) -> None:
    """Booleans exactly; float fields within ``rtol`` / ``atol``.

    ``reset_atol``: the client latency of a failed request is held to
    this absolute tolerance instead.  An ungraceful kill's reset latency
    is ``t_kill - arrival``, a difference of two clock readings; the
    arrival clock is a float32 cumsum that XLA and torch associate
    differently (within RTOL of the clock), so the difference carries
    the clock's absolute rounding, a few float32 spacings of the kill
    time (9.5e-7 s between 8 s and 16 s)."""
    for name in BOOL_FIELDS:
        got = getattr(port_res, name).cpu().numpy()
        want = np.asarray(getattr(jax_res, name))
        assert got.shape == want.shape, name
        bad = np.argwhere(got != want)
        assert bad.size == 0, f"{name} differs at {bad[:10].tolist()}"
    for name in FLOAT_FIELDS:
        got = getattr(port_res, name).cpu().numpy()
        want = np.asarray(getattr(jax_res, name))
        if name == "client_latency" and reset_atol is not None:
            failed = np.asarray(jax_res.client_error)
            np.testing.assert_allclose(
                got[failed], want[failed], rtol=rtol, atol=reset_atol,
                err_msg="client_latency of failed requests",
            )
            got, want = got[~failed], want[~failed]
        np.testing.assert_allclose(
            got, want, rtol=rtol, atol=atol, err_msg=name
        )


# -- the replay itself ---------------------------------------------------------

# a topology that draws every stream: send coins (probability), error
# coins, the sibling copula (concurrent calls) and the retry copula
REPLAY_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - - call: {service: a, retries: 1}
    - call: {service: b, probability: 50}
- name: a
  errorRate: 5%
- name: b
"""


def _replay_pair():
    jc = jax_compile_graph(JaxGraph.from_yaml(REPLAY_YAML))
    return JaxSimulator(jc), Simulator(port_compiled(jc), device="cpu")


@pytest.mark.parametrize("kind", ["open", "closed"])
def test_replay_draws_every_stream_of_the_port_spec(kind):
    """Each stream the port asks for comes back at its shape, and the
    port's spec states the JAX engine's own coin and copula choices."""
    jax_sim, sim = _replay_pair()
    spec = sim.draw_spec(64, kind)
    assert spec.need_send and spec.need_err and spec.copula
    assert spec.sib_dim and spec.retry_dim
    draws = JaxReplayDraws(jax.random.PRNGKey(0), jax_sim).draws(7, spec)
    draws.check(spec)
    for name, t in draws._asdict().items():
        if t is not None:
            assert t.dtype == torch.float32, name
            assert bool(torch.isfinite(t).all()), name


def test_replay_folds_the_index_into_the_key():
    """Index ``None`` is the key itself; each index is its own stream,
    and the same index gives the same numbers."""
    jax_sim, sim = _replay_pair()
    spec = sim.draw_spec(32, "open")
    source = JaxReplayDraws(jax.random.PRNGKey(1), jax_sim)
    a, b, c = source.draws(None, spec), source.draws(3, spec), source.draws(
        3, spec
    )
    assert not torch.equal(a.arr, b.arr)
    for x, y in zip(b, c):
        assert (x is None and y is None) or torch.equal(x, y)


def test_replayed_arrivals_are_the_jax_engine_arrivals():
    """Open loop: the JAX run's request starts are the cumulative sum of
    the replayed unit exponentials over the rate."""
    jax_sim, sim = _replay_pair()
    key = jax.random.PRNGKey(2)
    qps = 250.0
    want = np.asarray(jax_sim.run(JaxLoad(kind="open", qps=qps), 128, key)
                      .client_start)
    arr = JaxReplayDraws(key, jax_sim).draws(
        None, sim.draw_spec(128, "open")
    ).arr
    got = torch.cumsum(arr / qps, 0).numpy()
    # cumsum association: XLA and torch may add in another order
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
