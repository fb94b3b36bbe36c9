"""The port's resilience policies (``isotope_tpu_torch/sim/policies.py``,
``compile_policies``, the policy physics of the engine and
``Simulator.run_policies``) against the JAX package, draw for draw.

Stated tolerances: counts, booleans and the actuation series (replicas,
effective replicas, shed, retry allow, ejections, breaker state, trips,
scale events, completed windows) are equal; the run summaries and the
recorder's series are held as ``test_torch_timeline.py`` states
(``assert_timeline_match``) and the engine's floats at rtol 1e-5,
atol 1e-9 s.

Also pinned here: a Simulator without policy or rollout tables (and
with ``timeline=False``) runs exactly the torch ops, in the same order,
and gives exactly the results it gave before the protected layers were
ported (counted on the CPU with a dispatch mode; the counts and hashes
below were taken on the tree before the port of this layer).
"""
from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.metrics import timeline as jax_tm
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import policies as jax_pol
from isotope_tpu.sim.feedback import RetryFeedback as JaxFeedback
from isotope_tpu_torch.compiler import compile_graph, compile_lb
from isotope_tpu_torch.compiler import compile_policies
from isotope_tpu_torch.metrics import timeline as tm
from isotope_tpu_torch.models.generators import tree_topology
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim import policies as pol_mod
from isotope_tpu_torch.sim.config import ChaosEvent
from test_torch_replay import (
    JaxReplayDraws,
    assert_results_match,
    scenario_pair,
)
from test_torch_timeline import assert_timeline_match
from tools.torch_op_count import OpLog

KEY = jax.random.PRNGKey(0)
MU = 13_000.0

CHAIN = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 4
  script:
  - call: {service: worker, timeout: 850us, retries: 2}
- name: worker
  numReplicas: 4
"""

POLICIES = """
policies:
  defaults:
    retry_budget: {budget_percent: 25%}
  worker:
    breaker: {max_pending: 6, max_connections: 64,
              consecutive_errors: 5, base_ejection: 2s}
    autoscaler: {min_replicas: 2, max_replicas: 8,
                 target_utilization: 60%, sync_period: 1s,
                 stabilization_window: 3s}
"""

# the reference's storm_case (tests/test_policies.py), with the kill and
# the control periods scaled to a run of ~0.8 s
STORM = """
policies:
  worker:
    breaker: {max_pending: 6}
    retry_budget: {budget_percent: 20%, min_retries_concurrent: 2}
    autoscaler: {min_replicas: 4, max_replicas: 12,
                 target_utilization: 50%, sync_period: 100ms,
                 stabilization_window: 1s, scale_up_step: 2}
"""

SUMMARY_EXACT = ("count", "error_count", "hop_events", "win_count",
                 "win_error_count", "latency_hist", "unstable")
SUMMARY_CLOSE = ("latency_sum", "latency_min", "latency_max", "end_max")


def both(yaml_text):
    """(JAX compiled, JAX tables, port compiled, port tables)."""
    jg = JaxGraph.from_yaml(yaml_text)
    jc = jax_compile_graph(jg)
    pg = ServiceGraph.from_yaml(yaml_text)
    pc = compile_graph(pg)
    return jc, jax_compile_policies(jg, jc), pc, compile_policies(pg, pc)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_policy_summary_equal(got, want):
    for name in want._fields:
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        assert g.shape == w.shape, name
        assert np.array_equal(g.astype(np.float64), w.astype(np.float64)), (
            name
        )


def assert_summaries_match(got, want):
    for name in SUMMARY_EXACT:
        assert np.array_equal(_np(getattr(got, name)),
                              _np(getattr(want, name))), name
    for name in SUMMARY_CLOSE:
        np.testing.assert_allclose(
            _np(getattr(got, name)), _np(getattr(want, name)),
            rtol=1e-5, atol=1e-9, err_msg=name,
        )


# -- decode, tables, compile -------------------------------------------------

BAD_BLOCKS = [
    {"ghost": {}},
    {"entry": {"bulkhead": {}}},
    {"entry": {"breaker": {"max_pending": -1}}},
    {"entry": {"breaker": {"consecutive_errors": -2}}},
    {"entry": {"breaker": {"base_ejection": "0s"}}},
    {"entry": {"breaker": {"colour": 1}}},
    {"entry": {"breaker": [1]}},
    {"entry": {"retry_budget": {"min_retries_concurrent": -1}}},
    {"entry": {"retry_budget": {"budget": 1}}},
    {"entry": {"autoscaler": {"min_replicas": 0}}},
    {"entry": {"autoscaler": {"target_utilization": 0}}},
    {"entry": {"autoscaler": {"sync_period": "0s"}}},
    {"entry": {"autoscaler": {"scale_up_step": 0}}},
    {"entry": {"autoscaler": {"speed": 2}}},
    {"entry": 3},
    {"defaults": {"breaker": {"max_connections": 0}}},
    [1, 2],
]


@pytest.mark.parametrize("raw", BAD_BLOCKS, ids=lambda r: str(r)[:40])
def test_decode_errors_match_reference(raw):
    with pytest.raises(ValueError) as want:
        jax_pol.PolicySet.decode(raw, ["entry", "worker"])
    with pytest.raises(ValueError) as got:
        pol_mod.PolicySet.decode(raw, ["entry", "worker"])
    assert str(got.value) == str(want.value)
    assert getattr(got.value, "config_path", None) == getattr(
        want.value, "config_path", None
    )
    assert pol_mod.lint_policies(raw, ["entry", "worker"]) == (
        None, [("decode", str(want.value))]
    )


@pytest.mark.parametrize("extra", [POLICIES, STORM, """
policies:
  defaults:
    retry_budget: {budget_percent: 10%}
  worker:
    retry_budget: null
    autoscaler: {min_replicas: 1, max_replicas: 3}
""", """
policies:
  worker:
    lb: least_request
"""])
def test_compile_policies_tables_equal_reference(extra):
    jc, jt, pc, pt = both(CHAIN + extra)
    if jt is None:
        assert pt is None
        return
    for f in jt.__dataclass_fields__:
        a, b = getattr(pt, f), getattr(jt, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    assert pt.signature() == jt.signature()
    assert (pt.k_max, pt.any_breaker, pt.any_budget, pt.any_hpa,
            pt.any_ejection) == (jt.k_max, jt.any_breaker, jt.any_budget,
                                 jt.any_hpa, jt.any_ejection)


def test_empty_autoscaler_range_raises_like_reference():
    text = CHAIN + (
        "policies:\n  worker:\n"
        "    autoscaler: {min_replicas: 6, max_replicas: 2}\n"
    )
    with pytest.raises(ValueError) as want:
        both(text)
    pg = ServiceGraph.from_yaml(text)
    with pytest.raises(ValueError) as got:
        compile_policies(pg, compile_graph(pg))
    assert str(got.value) == str(want.value)
    no_block = ServiceGraph.from_yaml(CHAIN)
    assert compile_policies(no_block, compile_graph(no_block)) is None


# -- a Simulator without the layers: unchanged ops and results ---------------


def _op_trace(sim, load, n, block):
    src = TorchDraws(0, "cpu")
    sim.run_summary(load, n, src, block_size=block)  # fill the caches
    with OpLog() as ops:
        s = sim.run_summary(load, n, src, block_size=block)
    digest = hashlib.sha256("\n".join(ops.ops).encode()).hexdigest()[:16]
    return len(ops.ops), digest, float(s.latency_sum), float(s.hop_events)


def _op_configs():
    root = "examples/topologies"
    canon = compile_graph(ServiceGraph.from_yaml_file(f"{root}/canonical.yaml"))
    tree = compile_graph(ServiceGraph.decode(tree_topology(3, 3)))
    g10 = ServiceGraph.from_yaml_file(f"{root}/10-svc_1000-end.yaml")
    c10 = compile_graph(g10)
    kill = (ChaosEvent(service="svc-0-2", start_s=0.1, end_s=0.3,
                       replicas_down=60),)
    doc = yaml.safe_load(open(f"{root}/10-svc_1000-end.yaml"))
    doc["policies"] = {"defaults": {"lb": {
        "policy": "least_request", "choices_d": 2, "panic_threshold": 0.5,
    }}}
    glb = ServiceGraph.decode(doc)
    clb = compile_graph(glb)
    open_ = LoadModel(kind="open", qps=1000.0)
    return {
        "canonical-open": (lambda: Simulator(canon, device="cpu"),
                           open_, 512, 256),
        "canonical-closed": (
            lambda: Simulator(canon, device="cpu"),
            LoadModel(kind="closed", qps=1000.0, connections=8), 512, 256,
        ),
        "tree-open": (lambda: Simulator(tree, device="cpu"), open_, 512,
                      256),
        "10svc-chaos": (
            lambda: Simulator(c10, SimParams(), kill, device="cpu"),
            LoadModel(kind="open", qps=3000.0), 1024, 512,
        ),
        "10svc-lb-panic-chaos": (
            lambda: Simulator(c10, SimParams(), kill,
                              lb=compile_lb(glb, clb), device="cpu"),
            LoadModel(kind="open", qps=3000.0), 1024, 512,
        ),
    }


#: (op count, sha256 of the op names, latency sum, hop events) of two
#: run_summary blocks, taken on the tree before this layer was ported
PARENT_OPS = {
    "canonical-open": (398, "fd94e82a5ce57a6b", 1.5113914012908936, 3072.0),
    "canonical-closed": (408, "b15c9b6a7bf527c9", 1.512548804283142, 3072.0),
    "tree-open": (390, "0b9bcda75bdb25ec", 0.9904301762580872, 6656.0),
    "10svc-chaos": (1200, "05a99af59d811472", 1.3262721300125122, 10240.0),
    "10svc-lb-panic-chaos": (
        1458, "be0048921f52ae00", 1.3262721300125122, 10240.0,
    ),
}


@pytest.mark.parametrize("name", sorted(PARENT_OPS))
def test_unprotected_blocks_run_the_parent_ops(name):
    make, load, n, block = _op_configs()[name]
    assert _op_trace(make(), load, n, block) == PARENT_OPS[name]


NO_HPA = """
policies:
  defaults:
    retry_budget: {budget_percent: 25%}
  worker:
    breaker: {max_pending: 6, consecutive_errors: 5}
"""


@pytest.mark.parametrize("extra", [NO_HPA, POLICIES])
def test_carrying_tables_changes_no_result(extra):
    """A Simulator carrying policy tables gives the same results as one
    without, outside ``run_policies`` (at a load where the static
    retry-budget mirror admits every retry, as the reference's pin
    runs), and, unless an autoscaler widens the Erlang recursion to its
    ``max_replicas`` (the reference does the same), runs the same ops."""
    _, _, pc, pt = both(CHAIN + extra)
    load = LoadModel(kind="open", qps=2_000.0)
    plain = Simulator(pc, SimParams(), device="cpu")
    carrying = Simulator(pc, SimParams(), policies=pt, device="cpu")
    ta, tb = _op_trace(plain, load, 512, 256), _op_trace(
        carrying, load, 512, 256
    )
    assert ta[2:] == tb[2:]
    if not pt.any_hpa:
        assert ta == tb
    ra = plain.run(load, 512, TorchDraws(1, "cpu"))
    rb = carrying.run(load, 512, TorchDraws(1, "cpu"))
    for x, y in zip(ra, rb):
        assert (x is None and y is None) or torch.equal(x, y)


# -- the policy physics of one block ----------------------------------------


def _forced_fx(pt, shed=None, allow=None, replicas=None):
    S = pt.num_services
    reps = np.asarray(
        pt.static_replicas if replicas is None else replicas, np.float32
    )
    fx = pol_mod.PolicyFx(
        replicas=torch.tensor(reps),
        shed=torch.tensor(np.zeros(S) if shed is None else shed,
                          dtype=torch.float32),
        retry_allow=torch.tensor(np.ones(S) if allow is None else allow,
                                 dtype=torch.float32),
        total=torch.tensor(reps),
        alive=torch.tensor(reps),
    )
    jfx = jax_pol.PolicyFx(*(
        None if x is None else jnp.asarray(x.numpy()) for x in fx
    ))
    return fx, jfx


def _block_pair(js, ps, n, fx, jfx, qps, compare=True):
    """One block under forced policy effects in both engines, on the
    JAX engine's draws for ``KEY`` (``compare=False``: the port alone,
    on its own draws; the JAX engine's block runs op by op, seconds
    each)."""
    s = ps._scalar
    if not compare:
        got, _, _ = ps._simulate_core(
            n, "open", 0,
            ps._draws(TorchDraws(0, "cpu"), None, n, "open", policy=True),
            s(qps), s(0.0), s(qps), s(0.0), torch.zeros(1),
            visits_pc=ps._vis_arg(qps),
            phase_windows=ps._windows_arg(qps, False), policy_fx=fx,
        )
        return got
    want, _, _ = js._simulate_core(
        n, "open", 0, KEY, jnp.float32(qps), jnp.float32(0.0),
        jnp.float32(qps), jnp.float32(0.0), jnp.float32(0.0),
        jnp.zeros((1,), jnp.float32), jnp.float32(0.0), policy_fx=jfx,
        visits_pc=js._vis_arg(qps), phase_windows=js._windows_arg(qps, False),
    )
    got, _, _ = ps._simulate_core(
        n, "open", 0,
        ps._draws(JaxReplayDraws(KEY, js), None, n, "open", policy=True),
        s(qps), s(0.0), s(qps), s(0.0), torch.zeros(1),
        visits_pc=ps._vis_arg(qps),
        phase_windows=ps._windows_arg(qps, False), policy_fx=fx,
    )
    assert_results_match(got, want)
    return got


def _sim_pair(yaml_text, chaos=(), **params):
    jc, jt, pc, pt = both(yaml_text)
    js, ps = scenario_pair(jc, dict(timeline=True, **params), chaos=chaos,
                           policies=(jt, pt))
    return jc, jt, js, ps, pt


def test_breaker_shed_takes_error_path_not_queue():
    jc, jt, js, ps, pt = _sim_pair(CHAIN + POLICIES,
                                   service_time="deterministic")
    w = list(jc.services.names).index("worker")
    shed = np.zeros(jc.num_services)
    shed[w] = 1.0
    res = _block_pair(js, ps, 512, *_forced_fx(pt, shed=shed), 1000.0)
    worker = jc.hop_service == w
    sent = res.hop_sent[:, worker].numpy()
    err = res.hop_error[:, worker].numpy()
    lat = res.hop_latency[:, worker].numpy()
    assert sent.any() and (err == sent).all()
    # no wait, no script: the deterministic cpu time is the whole latency
    np.testing.assert_allclose(lat[sent], ps.params.cpu_time_s, rtol=1e-5)
    assert (res.hop_wait[:, worker].numpy()[sent] == 0).all()
    assert not res.client_error.any()  # a downstream 500 fails no caller


def test_breaker_shed_on_entry_fails_clients():
    jc, jt, js, ps, pt = _sim_pair(
        CHAIN + "policies:\n  entry:\n    breaker: {max_pending: 1}\n"
    )
    shed = np.zeros(jc.num_services)
    shed[jc.entry_service] = 1.0
    res = _block_pair(js, ps, 256, *_forced_fx(pt, shed=shed), 1000.0,
                      compare=False)
    assert res.client_error.all()


def test_budget_zero_truncates_attempt_fan():
    """3 of 4 workers down: retries fire on nearly every request;
    retry_allow = 0 suppresses every attempt past the first."""
    kill = [dict(service="worker", start_s=0.0, end_s=1e9,
                 replicas_down=3)]
    jc, jt, js, ps, pt = _sim_pair(CHAIN + POLICIES, chaos=kill)
    qps = 0.325 * 4 * MU
    retry_hops = jc.hop_attempt > 0
    free = _block_pair(js, ps, 512, *_forced_fx(pt), qps, compare=False)
    capped = _block_pair(
        js, ps, 512, *_forced_fx(pt, allow=np.zeros(jc.num_services)), qps
    )
    assert free.hop_sent[:, retry_hops].sum() > 0
    assert capped.hop_sent[:, retry_hops].sum() == 0
    assert capped.client_error.sum() >= free.client_error.sum()
    assert capped.client_latency.mean() < free.client_latency.mean()


def test_dynamic_replicas_reach_the_wait_law():
    jc, jt, js, ps, pt = _sim_pair(CHAIN + POLICIES)
    qps = 0.6 * 4 * MU
    full = _block_pair(js, ps, 2048, *_forced_fx(pt), qps, compare=False)
    halved = _block_pair(
        js, ps, 2048, *_forced_fx(pt, replicas=[4.0, 1.0]), qps,
        compare=False,
    )
    assert halved.hop_latency.mean() > full.hop_latency.mean()


def test_panic_split_fed_by_policy_state():
    """Panic routing under a protected run takes the policy state's
    pools: ejected replicas leave the pool below its threshold, with no
    chaos at all."""
    extra = POLICIES + (
        "  entry:\n    lb: {policy: least_request, panic_threshold: 50%}\n"
    )
    jg = JaxGraph.from_yaml(CHAIN + extra)
    jc = jax_compile_graph(jg)
    pg = ServiceGraph.from_yaml(CHAIN + extra)
    pc = compile_graph(pg)
    from isotope_tpu.compiler import compile_lb as jax_compile_lb

    js, ps = scenario_pair(
        jc, dict(timeline=True),
        lb=(jax_compile_lb(jg, jc), compile_lb(pg, pc)),
        policies=(jax_compile_policies(jg, jc), compile_policies(pg, pc)),
    )
    fx, jfx = _forced_fx(ps._policies)
    e = jc.entry_service
    alive = fx.alive.clone()
    alive[e] = 1.0  # 3 of the entry's 4 replicas ejected: 25% healthy
    fx = fx._replace(alive=alive)
    jfx = jfx._replace(alive=jnp.asarray(alive.numpy()))
    res = _block_pair(js, ps, 1024, fx, jfx, 2000.0, compare=False)
    share = float(res.client_error.float().mean())
    assert 0.6 < share < 0.9  # ~75% of the entry's hops fast-fail


# -- the control law -----------------------------------------------------------


def _law_pair(extra):
    jc, jt, pc, pt = both(CHAIN + extra)
    return jt, pt, jax_pol.device_tables(jt), pol_mod.device_tables(pt)


def _tl_pair(W, dt, **series):
    """The same (2, W) recorder series as a JAX and a port summary."""
    jspec = jax_tm.TimelineSpec(num_windows=W, window_s=dt, num_services=2,
                                hop_service=jnp.zeros(1, jnp.int32))
    pspec = tm.TimelineSpec(num_windows=W, window_s=dt, num_services=2,
                            hop_service=torch.zeros(1, dtype=torch.int64))
    jtl = jax_tm.zeros_summary(jspec)
    ptl = tm.zeros_summary(pspec)
    for name, v in series.items():
        v = np.asarray(v, np.float32)
        jtl = jtl._replace(**{name: jnp.asarray(v)})
        ptl = ptl._replace(**{name: torch.from_numpy(v.copy())})
    return jspec, pspec, jtl, ptl


def _advance_both(extra, W, ends, retries=None, downed=None, stuck=False,
                  lag=0, dt=1.0, **series):
    """Advance both laws through blocks ending at ``ends`` (sim
    seconds: blocks completing zero, one or several windows) and hold
    the states and summary deltas equal; returns the port's final
    state and accumulated summary."""
    jt, pt, jd, pd = _law_pair(extra)
    jspec, pspec, jtl, ptl = _tl_pair(W, dt, **series)
    r = np.zeros((2, W), np.float32) if retries is None else np.asarray(
        retries, np.float32
    )
    d = None if downed is None else np.asarray(downed, np.float32)
    js, ps = jax_pol.init_state(jd, lag_periods=lag), pol_mod.init_state(
        pd, lag_periods=lag
    )
    jacc = jax_pol.zeros_summary(jspec, 2)
    pacc = pol_mod.zeros_summary(pspec, 2)
    for t in ends:
        js, jdelta = jax_pol.advance(
            js, jd, jtl, jnp.asarray(r), jnp.float32(t), jspec,
            stuck_breaker=stuck,
            downed_w=None if d is None else jnp.asarray(d),
        )
        ps, pdelta = pol_mod.advance(
            ps, pd, ptl, torch.from_numpy(r.copy()),
            torch.tensor(t, dtype=torch.float32), pspec,
            stuck_breaker=stuck,
            downed_w=None if d is None else torch.from_numpy(d.copy()),
        )
        assert ps.last_window == int(js.last_window)
        for name in jax_pol.PolicyState._fields:
            if name == "last_window":
                continue
            assert np.array_equal(_np(getattr(ps, name)),
                                  _np(getattr(js, name))), name
        assert_policy_summary_equal(pdelta, jdelta)
        jacc = jax_pol.accumulate_summary(jacc, jdelta)
        pacc = pol_mod.accumulate_summary(pacc, pdelta)
    assert_policy_summary_equal(pacc, jacc)
    return ps, pacc


HPA_UP = """
policies:
  worker:
    autoscaler: {min_replicas: 4, max_replicas: 16,
                 target_utilization: 50%, sync_period: 1s,
                 scale_up_step: 2}
"""


def test_hpa_step_limit():
    busy = np.zeros((2, 4))
    busy[1] = 3.6  # util 0.9 at 4 replicas: desired 8, +2 per sync
    s, acc = _advance_both(HPA_UP, 4, [0.5, 1.0, 1.5, 4.0], svc_busy_s=busy)
    assert 4.0 < float(s.replicas[1]) <= 16.0
    assert float(s.scale_events[1]) >= 1
    assert np.all(np.diff(acc.replicas[1].numpy()) <= 2.0)


def test_hpa_stabilization_delays_scale_down():
    extra = """
policies:
  worker:
    autoscaler: {min_replicas: 1, max_replicas: 8,
                 target_utilization: 60%, sync_period: 1s,
                 stabilization_window: 3s, scale_down_step: 1}
"""
    s2, _ = _advance_both(extra, 6, [2.0], svc_busy_s=np.zeros((2, 6)))
    assert float(s2.replicas[1]) == 4.0  # 2 s below target: held
    s6, _ = _advance_both(extra, 6, [2.0, 3.5, 6.0],
                          svc_busy_s=np.zeros((2, 6)))
    assert float(s6.replicas[1]) < 4.0


def test_hpa_uses_alive_capacity_under_chaos():
    extra = """
policies:
  worker:
    autoscaler: {min_replicas: 1, max_replicas: 16,
                 target_utilization: 50%, sync_period: 1s,
                 stabilization_window: 2s, scale_up_step: 2}
"""
    busy = np.zeros((2, 4))
    busy[1] = 1.0  # one alive server fully busy
    downed = np.zeros((2, 4))
    downed[1] = 3.0
    s, _ = _advance_both(extra, 4, [4.0], downed=downed, svc_busy_s=busy)
    assert float(s.replicas[1]) > 4.0
    s_bug, _ = _advance_both(extra, 4, [4.0], svc_busy_s=busy)
    assert float(s_bug.replicas[1]) < 4.0


def test_retry_budget_settles_without_bang_bang():
    extra = """
policies:
  worker:
    retry_budget: {budget_percent: 10%, min_retries_concurrent: 0}
"""
    arr = np.zeros((2, 4))
    arr[1] = 100.0
    retries = np.zeros((2, 4))
    retries[1, 0] = 40.0
    retries[1, 1] = 10.0
    s, _ = _advance_both(extra, 4, [1.0, 2.0], retries=retries,
                         svc_arrivals=arr)
    assert float(s.retry_allow[1]) == pytest.approx(0.25, rel=1e-3)


def test_breaker_trips_and_closes_and_ejection_restores():
    extra = """
policies:
  worker:
    breaker: {max_pending: 2, consecutive_errors: 10, base_ejection: 2s,
              max_ejection_fraction: 50%}
"""
    inflight = np.zeros((2, 8))
    inflight[1, 0] = 8.0
    errors = np.zeros((2, 8))
    errors[1, 2:4] = 6.0
    s, acc = _advance_both(extra, 8, [0.0, 1.0, 2.0, 4.0, 5.5, 8.0],
                           svc_inflight_s=inflight, svc_errors=errors)
    a = acc.breaker_open[1].numpy()
    assert a[0] == 1.0 and a[1] == 0.0  # opens, then closes
    assert float(s.trips[1]) == 1.0
    assert float(s.ejections[1]) == 1.0 and float(s.ejected[1]) == 0.0


def test_shed_errors_do_not_feed_ejection():
    extra = """
policies:
  worker:
    breaker: {max_pending: 2, consecutive_errors: 5, base_ejection: 5s}
"""
    inflight = np.zeros((2, 6))
    inflight[1] = 8.0
    errors = np.zeros((2, 6))
    errors[1, 1:] = 50.0
    s, _ = _advance_both(extra, 6, [6.0], svc_inflight_s=inflight,
                         svc_errors=errors)
    assert float(s.shed[1]) > 0.0 and float(s.ejections[1]) == 0.0


def test_stuck_breaker_and_autoscaler_lag_passed_directly():
    extra = """
policies:
  worker:
    breaker: {max_pending: 2}
    autoscaler: {min_replicas: 1, max_replicas: 8, sync_period: 1s}
"""
    inflight = np.zeros((2, 4))
    inflight[1, 0] = 8.0
    s, _ = _advance_both(extra, 4, [4.0], stuck=True,
                         svc_inflight_s=inflight)
    assert float(s.shed[1]) == pytest.approx(0.75)  # never closes
    s_free, _ = _advance_both(extra, 4, [4.0], svc_inflight_s=inflight)
    assert float(s_free.shed[1]) == 0.0
    busy = np.full((2, 4), 3.9)
    s_lag, acc = _advance_both(extra, 4, [1.0, 2.0, 4.0], lag=2,
                               svc_busy_s=busy)
    assert float(pol_mod.init_state(
        pol_mod.device_tables(_law_pair(extra)[1]), lag_periods=2
    ).next_sync_s[1]) == 3.0
    # the first sync waits for the third window's end
    assert acc.replicas[1, :2].tolist() == [4.0, 4.0]


def test_random_signals_law_equal_reference():
    """Every mechanism at once on seeded random signals, advanced by
    blocks that complete zero, one and several windows."""
    rng = np.random.default_rng(7)
    W = 12
    s, acc = _advance_both(
        POLICIES, W, [0.0, 0.5, 1.0, 1.2, 4.0, 4.0, 7.5, 12.0, 13.0],
        retries=rng.uniform(0, 30, (2, W)),
        downed=rng.integers(0, 3, (2, W)),
        svc_arrivals=rng.integers(50, 150, (2, W)),
        svc_errors=rng.integers(0, 4, (2, W)),
        svc_busy_s=rng.uniform(0.0, 5.0, (2, W)),
        svc_inflight_s=rng.uniform(5.0, 60.0, (2, W)),
    )
    assert float(acc.windows_done.sum()) == W


def test_to_doc_and_format_table_equal_reference():
    s, acc = _advance_both(
        POLICIES, 6, [3.0], svc_busy_s=np.full((2, 6), 4.0),
        svc_inflight_s=np.full((2, 6), 40.0),
    )
    jc, jt, pc, pt = both(CHAIN + POLICIES)
    jacc = jax_pol.PolicySummary(*(_np(x) for x in acc))
    doc = pol_mod.to_doc(pc, acc, pt)
    assert doc == jax_pol.to_doc(jc, jacc, jt)
    assert len(doc["services"]["worker"]["replicas"]) == 3
    assert pol_mod.format_table(doc) == jax_pol.format_table(doc)


# -- the static retry-budget mirror --------------------------------------------


def test_retry_feedback_with_budget_equals_reference():
    jc, jt, pc, pt = both(CHAIN + STORM)
    kill = [dict(service="worker", start_s=0.0, end_s=1e9, replicas_down=2)]
    js, ps = scenario_pair(jc, dict(timeline=True), chaos=kill,
                           policies=(jt, pt))
    plain_j, _ = scenario_pair(jc, dict(timeline=True), chaos=kill)
    assert ps._feedback.budget is not None
    qps = 0.325 * 4 * MU
    for rate in (0.01 * MU, qps, 2 * qps):
        np.testing.assert_array_equal(ps._feedback.visits_pc(rate),
                                      js._feedback.visits_pc(rate))
    w = list(jc.services.names).index("worker")
    assert ps._feedback.visits_pc(qps)[0, w] < plain_j._feedback.visits_pc(
        qps
    )[0, w]
    assert isinstance(js._feedback, JaxFeedback)


# -- protected runs, end to end -------------------------------------------------


@pytest.fixture(scope="module")
def storm_runs():
    """The storm case open (window 0.1 s, worker 3 of 4 down in
    [0.2 s, 0.5 s)) and paced closed, run by both engines."""
    jc, jt, pc, pt = both(CHAIN + STORM)
    kill = [dict(service="worker", start_s=0.2, end_s=0.5,
                 replicas_down=3)]
    out = {}
    js, ps = scenario_pair(jc, dict(timeline=True, timeline_window_s=0.1),
                           chaos=kill, policies=(jt, pt))
    load = dict(kind="open", qps=0.325 * 4 * MU)
    out["open"] = (
        ps.run_policies(LoadModel(**load), 10_000, JaxReplayDraws(KEY, js),
                        block_size=1024, window_s=0.1),
        js.run_policies(JaxLoad(**load), 10_000, KEY, block_size=1024,
                        window_s=0.1),
    )
    js2, ps2 = scenario_pair(jc, dict(timeline=True, timeline_window_s=0.5),
                             policies=(jt, pt))
    load = dict(kind="closed", qps=2_000.0, connections=8)
    out["closed"] = (
        ps2.run_policies(LoadModel(**load), 4096, JaxReplayDraws(KEY, js2),
                         block_size=1024, window_s=0.5),
        js2.run_policies(JaxLoad(**load), 4096, KEY, block_size=1024,
                         window_s=0.5),
    )
    return jc, jt, pc, pt, out


@pytest.mark.parametrize("kind", ["open", "closed"])
def test_run_policies_matches_reference(storm_runs, kind):
    jc, jt, pc, pt, out = storm_runs
    (s, tl, pol), (js, jtl, jpol) = out[kind]
    assert_summaries_match(s, js)
    assert_timeline_match(tl, jtl)
    assert_policy_summary_equal(pol, jpol)
    doc = pol_mod.to_doc(pc, pol, pt)
    assert doc == jax_pol.to_doc(jc, jpol, jt)
    if kind == "open":
        w = doc["services"]["worker"]
        # the kill trips the breaker inside it, the budget caps retries,
        # the autoscaler scales up
        assert 0.2 <= w["breaker_trip_onset_s"] <= 0.5
        assert min(w["retry_allow"]) < 1.0
        assert w["peak_replicas"] > 4


def test_run_policies_refusals():
    jc, jt, pc, pt = both(CHAIN + POLICIES)
    load = LoadModel(kind="open", qps=1000.0)
    src = TorchDraws(0, "cpu")
    with pytest.raises(ValueError, match="policy tables"):
        Simulator(pc, SimParams(timeline=True), device="cpu").run_policies(
            load, 256, src
        )
    with pytest.raises(ValueError, match="timeline"):
        Simulator(pc, SimParams(), policies=pt,
                  device="cpu").run_policies(load, 256, src)
    with pytest.raises(ValueError, match="saturated"):
        Simulator(pc, SimParams(timeline=True), policies=pt,
                  device="cpu").run_policies(
            LoadModel(kind="closed", qps=None, connections=8), 256, src
        )


# -- the policy layer's fault sites ------------------------------------------


#: a breaker and a fast autoscaler on the worker (sync every 50 ms)
FAST_HPA = """
policies:
  worker:
    breaker: {max_pending: 6}
    autoscaler: {min_replicas: 2, max_replicas: 8,
                 target_utilization: 60%, sync_period: 50ms,
                 stabilization_window: 1s}
"""


@pytest.mark.parametrize("spec", ["stuck:policies.stuck_breaker",
                                  "lag:policies.autoscaler_lag:3"])
def test_policy_fault_sites_match_reference(spec, monkeypatch):
    """Armed in both packages, the behavioral policy sites give the
    protected run of the JAX package on the same draws (the reference's
    ``stuck_breaker`` / ``autoscaler_lag`` pins, end to end): the armed
    breaker reaches ``advance`` stuck, and the lagged autoscaler's
    first scale-up comes later than the clean run's."""
    from isotope_tpu.resilience import faults as jax_faults
    from isotope_tpu_torch.resilience import faults

    jc, jt, pc, pt = both(CHAIN + FAST_HPA)
    kill = [dict(service="worker", start_s=0.05, end_s=0.15,
                 replicas_down=3)]
    load = dict(kind="open", qps=0.3 * 4 * MU)
    stuck_seen = []
    advance = pol_mod.advance

    def spy(*a, **kw):
        stuck_seen.append(kw.get("stuck_breaker", False))
        return advance(*a, **kw)

    monkeypatch.setattr(pol_mod, "advance", spy)
    runs = {}
    for armed in (False, True):
        try:
            if armed:
                faults.install(spec)
                jax_faults.install(spec)
            js, ps = scenario_pair(
                jc, dict(timeline=True, timeline_window_s=0.05),
                chaos=kill, policies=(jt, pt),
            )
            runs[armed] = (
                ps.run_policies(LoadModel(**load), 8192,
                                JaxReplayDraws(KEY, js), block_size=1024,
                                window_s=0.05),
                js.run_policies(JaxLoad(**load), 8192, KEY,
                                block_size=1024, window_s=0.05),
            )
        finally:
            faults.clear()
            jax_faults.clear()
    (s, tl, pol), (js_, jtl, jpol) = runs[True]
    assert_summaries_match(s, js_)
    assert_timeline_match(tl, jtl)
    assert_policy_summary_equal(pol, jpol)
    assert pol_mod.to_doc(pc, pol, pt) == jax_pol.to_doc(jc, jpol, jt)
    half = len(stuck_seen) // 2
    assert not any(stuck_seen[:half])
    assert all(stuck_seen[half:]) == spec.startswith("stuck")
    clean = runs[False][0][2]
    w = list(pc.services.names).index("worker")
    up = int((pol.replicas[w] > pol.replicas[w, 0]).nonzero()[0])
    up_clean = int((clean.replicas[w] > clean.replicas[w, 0]).nonzero()[0])
    assert (up > up_clean) == spec.startswith("lag")


def test_policy_fault_sites_raise_classified_and_retry():
    """The standard kinds at the policy sites raise classified faults at
    the protected run's entry, and the supervisor's retry path covers
    them (the reference's ``test_transient_policy_site_is_retried``)."""
    from isotope_tpu_torch.resilience import (
        ResiliencePolicy,
        call_with_retries,
        faults,
    )
    from isotope_tpu_torch.resilience.taxonomy import TRANSIENT, classify

    jc, jt, pc, pt = both(CHAIN + POLICIES)
    sim = Simulator(pc, SimParams(timeline=True), policies=pt,
                    device="cpu")
    load = LoadModel(kind="open", qps=1_000.0)
    try:
        faults.install("transient:policies.stuck_breaker:1")
        with pytest.raises(Exception) as e:
            sim.run_policies(load, 512, TorchDraws(0, "cpu"),
                             block_size=256)
        assert classify(e.value) == TRANSIENT
        faults.install("transient:policies.autoscaler_lag:1")
        out = call_with_retries(
            lambda: sim.run_policies(load, 512, TorchDraws(0, "cpu"),
                                     block_size=256),
            site="policies.run",
            policy=ResiliencePolicy(max_retries=2, sleep=lambda s: None),
        )
        assert float(out[0].count) >= 512
    finally:
        faults.clear()
