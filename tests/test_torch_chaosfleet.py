"""Chaos fleets and protected fleets of the port against the JAX
package's (``tests/test_chaosfleet.py``), on its draws.

- the chaos jitter (``resilience/faults.py``) is the reference's host
  code: the same schedules, seeds and messages;
- a member under its own schedule runs that schedule's planner
  Simulator, so it is bit-equal to the port's solo run of a Simulator
  built with that schedule, on the same source (ungraceful kills, lb
  panic pools, ``-qps max`` and rollouts included);
- a protected fleet's members each carry their own control loops: the
  member on the fleet's own source equals the solo ``run_policies`` /
  ``run_rollouts``, the others the solo runs on ``RootedSource(source,
  seed)``;
- against the JAX package's fleets: counts, histograms and control
  series exactly, float sums at rtol 1e-5 / atol 1e-9 s, the recorder's
  occupancy integrals in ``assert_timeline_match``'s band, the
  saturated law at rtol 1e-4 plus atol 1e-5 s.

The splitting estimator, the sharded fleets and the carry export are
ROADMAP item 9's and 11's remaining work, not tested here.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_lb as jax_compile_lb
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.compiler import compile_rollouts as jax_compile_rollouts
from isotope_tpu.compiler.compile import (
    compile_chaos_members as jax_compile_chaos_members,
)
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.resilience import faults as jax_faults
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import config as jax_config
from isotope_tpu.sim.ensemble import EnsembleSpec as JaxSpec
from isotope_tpu_torch.compiler import (
    compile_chaos_members,
    compile_graph,
    compile_lb,
    compile_policies,
    compile_rollouts,
)
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.resilience import faults
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim.config import ChaosEvent
from isotope_tpu_torch.sim.draws import RootedSource
from isotope_tpu_torch.sim.ensemble import EnsembleSpec
from test_torch_ensemble import assert_stacks
from test_torch_policies import assert_policy_summary_equal
from test_torch_replay import JaxReplayDraws
from test_torch_timeline import assert_timeline_match

KEY = jax.random.PRNGKey(7)
OPEN = dict(kind="open", qps=4_000.0)
SAT = dict(kind="closed", qps=None, connections=8)
N, BLOCK, WIN = 2_048, 1_024, 0.25

STORM = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 4
  script:
  - call: {service: worker, timeout: 850us, retries: 2}
- name: worker
  numReplicas: 4
  errorRate: 0.5%
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
BASE_YAML = STORM.split("policies:")[0]
LB_YAML = """
policies:
  worker:
    lb: {policy: least_request, panic_threshold: 50%}
"""
ROLLOUT_YAML = """
rollouts:
  defaults:
    gates: {min_samples: 20}
  worker:
    steps: [10%, 50%, 100%]
    bake: 2s
    rollback: {cooldown: 4s, max_retries: 1}
    canary: {error_rate: 30%}
"""
CHAOS = dict(service="worker", start_s=0.1, end_s=0.3, replicas_down=3)
UNGRACEFUL = dict(CHAOS, drain=False)
JITTER = dict(time=0.3, magnitude=0.5, seed=11)
REPS = {"entry": 4, "worker": 4}


def _events(*kws):
    return (tuple(jax_config.ChaosEvent(**kw) for kw in kws),
            tuple(ChaosEvent(**kw) for kw in kws))


def _jittered(events, k, spec=None):
    spec = spec or faults.ChaosJitterSpec(**JITTER)
    return faults.jitter_chaos_events(
        events, spec, faults.member_event_seeds(spec, k, len(events)),
        REPS,
    )


def _build(yaml_text, chaos=(), params=None, lb=False, pol=False,
           roll=False):
    """(JAX Simulator, port Simulator on the CPU) of one topology."""
    jg, pg = JaxGraph.from_yaml(yaml_text), ServiceGraph.from_yaml(yaml_text)
    jc, pc = jax_compile_graph(jg), compile_graph(pg)
    from isotope_tpu.sim import SimParams as JaxParams
    from isotope_tpu.sim import Simulator as JaxSimulator

    jchaos, pchaos = _events(*chaos)
    kw = params or {}
    js = JaxSimulator(
        jc, JaxParams(**kw), jchaos,
        lb=jax_compile_lb(jg, jc) if lb else None,
        policies=jax_compile_policies(jg, jc) if pol else None,
        rollouts=jax_compile_rollouts(jg, jc) if roll else None,
    )
    ps = Simulator(
        pc, SimParams(**kw), pchaos,
        lb=compile_lb(pg, pc) if lb else None,
        policies=compile_policies(pg, pc) if pol else None,
        rollouts=compile_rollouts(pg, pc) if roll else None,
        device="cpu",
    )
    return js, ps


# -- the chaos jitter: host code -------------------------------------------


SPECS = [
    dict(), dict(time=0.4, magnitude=0.6, target=0.5, seed=3),
    dict(time=0.3, seed=11), dict(magnitude=1.0, target=1.0, seed=2,
                                  pool=("entry", "worker")),
]


@pytest.mark.parametrize("kw", SPECS)
def test_chaos_jitter_events_match_reference(kw):
    base = (dict(service="worker", start_s=0.05, end_s=0.12,
                 replicas_down=1),
            dict(service="entry", start_s=0.10, end_s=0.20))
    jev, pev = _events(*base)
    jspec, pspec = jax_faults.ChaosJitterSpec(**kw), \
        faults.ChaosJitterSpec(**kw)
    assert pspec.to_dict() == jspec.to_dict()
    assert pspec.identity == jspec.identity
    for member in (0, 5, 6, 123456):
        js = jax_faults.member_event_seeds(jspec, member, 2)
        ps = faults.member_event_seeds(pspec, member, 2)
        np.testing.assert_array_equal(ps, js)
        want = jax_faults.jitter_chaos_events(jev, jspec, js, REPS)
        got = faults.jitter_chaos_events(pev, pspec, ps, REPS)
        assert [dataclasses.asdict(e) for e in got] == \
            [dataclasses.asdict(e) for e in want]
    if pspec.identity:
        assert faults.jitter_chaos_events(pev, pspec, ps, REPS) == pev
    with pytest.raises(ValueError) as want:
        jax_faults.jitter_chaos_events(jev, jspec, [1], REPS)
    with pytest.raises(ValueError) as got:
        faults.jitter_chaos_events(pev, pspec, [1], REPS)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", [
    None, "off", "time=0.2,mag=0.5,target=0.3,seed=7", "magnitude=1",
    "tim=0.2", "time", "time=-1", "target=2",
])
def test_parse_chaos_jitter_matches_reference(text):
    try:
        want = jax_faults.parse_chaos_jitter(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            faults.parse_chaos_jitter(text)
        assert str(got.value) == str(e)
        return
    got = faults.parse_chaos_jitter(text)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()


# -- chaos fleets against solo runs and the JAX package ----------------------


@pytest.fixture(scope="module")
def psim():
    return _build(STORM, chaos=(CHAOS,), params=dict(timeline=True),
                  pol=True)


def test_identity_member_chaos_equals_plain_fleet(psim):
    """Per-member chaos at the identity jitter is the plain fleet, bit
    for bit: every member runs the base schedule."""
    _, sim = psim
    src = TorchDraws(0, "cpu")
    spec = EnsembleSpec.of(2, mode="map")
    plain = sim.run_ensemble(LoadModel(**OPEN), N, src, spec,
                             block_size=BLOCK)
    ident = sim.run_ensemble(LoadModel(**OPEN), N, src, spec,
                             block_size=BLOCK,
                             member_chaos=faults.ChaosJitterSpec())
    for f in plain.summaries._fields:
        a, b = getattr(plain.summaries, f), getattr(ident.summaries, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert ident.member_chaos == [sim._chaos_events] * 2
    assert ident.to_doc()["member_chaos"] is True


def test_member_matches_solo_schedule_and_reference(psim):
    """A member on an explicit jittered schedule equals the solo
    Simulator built with it, and the fleet the JAX package's."""
    js, sim = psim
    jit = _jittered(sim._chaos_events, 1)
    src = JaxReplayDraws(KEY, js)
    fleet = sim.run_ensemble(
        LoadModel(**OPEN), N, src, EnsembleSpec.of(2, mode="map"),
        block_size=BLOCK, member_chaos=[sim._chaos_events, jit],
    )
    solo_sim = Simulator(sim.compiled, SimParams(timeline=True), jit,
                         policies=sim._policies, device="cpu")
    solo = solo_sim.run_summary(LoadModel(**OPEN), N,
                                RootedSource(src, 1), block_size=BLOCK)
    for f in ("latency_hist", "count", "error_count", "latency_sum"):
        assert torch.equal(getattr(fleet.member(1), f),
                           getattr(solo, f)), f
    jjit = tuple(jax_config.ChaosEvent(**dataclasses.asdict(e))
                 for e in jit)
    want = js.run_ensemble(
        JaxLoad(**OPEN), N, KEY, JaxSpec.of(2, mode="map"),
        block_size=BLOCK, member_chaos=[js._chaos_events, jjit],
    )
    assert_stacks(fleet.summaries, want.summaries)


def test_member_chaos_rejections(psim):
    js, sim = psim
    nochaos = Simulator(sim.compiled, SimParams(timeline=True),
                        policies=sim._policies, device="cpu")
    src = TorchDraws(0, "cpu")
    with pytest.raises(ValueError, match="base chaos schedule"):
        nochaos.run_ensemble(LoadModel(**OPEN), N, src,
                             EnsembleSpec.of(2),
                             member_chaos=faults.ChaosJitterSpec(time=0.1))
    with pytest.raises(ValueError, match="1 schedules for 2 members"):
        sim.run_ensemble(LoadModel(**OPEN), N, src, EnsembleSpec.of(2),
                         member_chaos=[()])
    with pytest.raises(ValueError, match="phase-cut structure"):
        sim.run_ensemble(LoadModel(**OPEN), N, src, EnsembleSpec.of(1),
                         member_chaos=[()])
    # the folded mode serves chaos fleets: an explicit "vmap" runs and
    # equals the member-by-member fleet
    jit = faults.ChaosJitterSpec(time=0.1)
    folded, mapped = (
        sim.run_ensemble(LoadModel(**OPEN), N, src,
                         EnsembleSpec.of(2, mode=mode), block_size=BLOCK,
                         member_chaos=jit)
        for mode in ("vmap", "map")
    )
    assert folded.member_chaos == mapped.member_chaos
    assert_stacks(folded.summaries, mapped.summaries)


COMPOSED = {
    "ungraceful": dict(yaml=BASE_YAML, chaos=UNGRACEFUL, load=OPEN),
    "lb-panic": dict(yaml=BASE_YAML + LB_YAML, chaos=CHAOS, load=OPEN,
                     lb=True),
    "saturated": dict(yaml=BASE_YAML, chaos=CHAOS, load=SAT),
}


@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_composed_member_matches_solo_and_reference(name):
    case = COMPOSED[name]
    js, sim = _build(case["yaml"], chaos=(case["chaos"],),
                     lb=case.get("lb", False))
    jit = _jittered(sim._chaos_events, 1)
    src = JaxReplayDraws(KEY, js)
    load = LoadModel(**case["load"])
    fleet = sim.run_ensemble(load, N, src, EnsembleSpec.of(2, mode="map"),
                             block_size=BLOCK,
                             member_chaos=[sim._chaos_events, jit])
    solo = Simulator(sim.compiled, sim.params, jit, lb=sim._lb,
                     device="cpu").run_summary(
        load, N, RootedSource(src, 1), block_size=BLOCK)
    for f in ("latency_hist", "count", "error_count", "latency_sum"):
        assert torch.equal(getattr(fleet.member(1), f),
                           getattr(solo, f)), f
    jjit = tuple(jax_config.ChaosEvent(**dataclasses.asdict(e))
                 for e in jit)
    want = js.run_ensemble(
        JaxLoad(**case["load"]), N, KEY, JaxSpec.of(2, mode="map"),
        block_size=BLOCK, member_chaos=[js._chaos_events, jjit],
    )
    if name == "saturated":
        assert_stacks(fleet.summaries, want.summaries, 1e-4, 1e-5,
                      exact=("count", "error_count", "hop_events"),
                      close=("latency_sum", "latency_max"))
    else:
        assert_stacks(fleet.summaries, want.summaries)


def test_compile_chaos_members_tables_equal_reference():
    """The stacked ChaosFx tables of the all-on composition (policies,
    rollouts, lb panic, an ungraceful kill) are the reference's."""
    all_on = STORM.replace(
        "  worker:\n    breaker:",
        "  worker:\n    lb: {policy: least_request, "
        "panic_threshold: 50%}\n    breaker:",
    ) + ROLLOUT_YAML
    js, sim = _build(all_on, chaos=(UNGRACEFUL,),
                     params=dict(timeline=True), lb=True, pol=True,
                     roll=True)
    jit = _jittered(sim._chaos_events, 1)
    jjit = tuple(jax_config.ChaosEvent(**dataclasses.asdict(e))
                 for e in jit)
    _, got = compile_chaos_members(sim, [sim._chaos_events, jit],
                                   with_pol=True, roll=True)
    _, want = jax_compile_chaos_members(js, [js._chaos_events, jjit],
                                        with_pol=True, roll=True)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(
                a.numpy().astype(np.float64),
                np.asarray(b).astype(np.float64), err_msg=f,
            )
    c_sat, c_js = _build(BASE_YAML, chaos=(CHAOS,))[::-1]
    jit = _jittered(c_sat._chaos_events, 2)
    jjit = tuple(jax_config.ChaosEvent(**dataclasses.asdict(e))
                 for e in jit)
    _, got = compile_chaos_members(c_sat, [jit], sat_conns=8,
                                   source=JaxReplayDraws(KEY, c_js))
    _, want = jax_compile_chaos_members(c_js, [jjit], sat_conns=8)
    for f in ("eff_replicas_pc", "svc_down_pc", "sat_cuts", "sat_breaks"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.float64),
            np.asarray(getattr(want, f)).astype(np.float64), err_msg=f,
        )
    np.testing.assert_allclose(got.sat_lam.numpy(),
                               np.asarray(want.sat_lam), rtol=1e-6)


# -- protected fleets ---------------------------------------------------------


def _member_equals(fleet, k, solo, roll=False):
    s, tl = solo[0], solo[1]
    for f in s._fields:
        if f != "metrics":
            assert torch.equal(getattr(fleet.member(k), f),
                               getattr(s, f)), f
    for f in tl._fields:
        assert torch.equal(getattr(fleet.member_timeline(k), f),
                           getattr(tl, f)), f
    series = fleet.member_rollouts(k) if roll else fleet.member_policies(k)
    for f in series._fields:
        assert torch.equal(getattr(series, f), getattr(solo[2], f)), f


@pytest.mark.parametrize("roll", [False, True])
def test_protected_fleet_members_equal_solo_runs(roll):
    """Member 0 on the fleet's own source is the solo protected run;
    member 1 on ``RootedSource(source, 1)`` its solo run there; under
    a jittered schedule member 1 is the solo run of that schedule."""
    text = STORM + ROLLOUT_YAML if roll else STORM
    _, sim = _build(text, chaos=(CHAOS,), params=dict(timeline=True),
                    pol=True, roll=roll)
    src = TorchDraws(4, "cpu")
    run = sim.run_rollouts_ensemble if roll else sim.run_policies_ensemble
    solo_run = sim.run_rollouts if roll else sim.run_policies
    kw = dict(block_size=BLOCK, trim=True, window_s=WIN)
    fleet = run(LoadModel(**OPEN), N, src, EnsembleSpec.of(2),
                member_keys=[src, RootedSource(src, 1)], **kw)
    _member_equals(fleet, 0, solo_run(LoadModel(**OPEN), N, src, **kw),
                   roll)
    _member_equals(fleet, 1, solo_run(LoadModel(**OPEN), N,
                                      RootedSource(src, 1), **kw), roll)
    jit = _jittered(sim._chaos_events, 1)
    chaos_fleet = run(LoadModel(**OPEN), N, src, EnsembleSpec.of(2),
                      member_chaos=[sim._chaos_events, jit], **kw)
    solo_sim = Simulator(sim.compiled, sim.params, jit,
                         policies=sim._policies, rollouts=sim._rollouts,
                         device="cpu")
    solo = (solo_sim.run_rollouts if roll else solo_sim.run_policies)(
        LoadModel(**OPEN), N, RootedSource(src, 1), **kw)
    _member_equals(chaos_fleet, 1, solo, roll)


@pytest.fixture(scope="module")
def pfleets(psim):
    js, sim = psim
    kw = dict(block_size=BLOCK, trim=True, window_s=WIN)
    got = sim.run_policies_ensemble(
        LoadModel(**OPEN), N, JaxReplayDraws(KEY, js),
        EnsembleSpec.of(3, mode="map"), **kw)
    want = js.run_policies_ensemble(JaxLoad(**OPEN), N, KEY,
                                    JaxSpec.of(3, mode="map"), **kw)
    return got, want


def test_protected_fleet_matches_reference(pfleets):
    got, want = pfleets
    assert_stacks(got.summaries, want.summaries)
    for k in range(3):
        assert_timeline_match(got.member_timeline(k),
                              want.member_timeline(k), f"member {k} ")
        assert_policy_summary_equal(got.member_policies(k),
                                    want.member_policies(k))


def test_protected_fleet_severity_and_doc_match_reference(pfleets):
    got, want = pfleets
    np.testing.assert_array_equal(got.severity(), want.severity())
    a, b = got.to_doc("case", slo_s=10.0), want.to_doc("case", slo_s=10.0)
    assert a["protected"] is True and a["schema"] == "isotope-ensemble/v2"
    for k in ("worst_member", "worst_member_seed", "severity", "slo",
              "member_counts", "member_error_counts", "protected"):
        assert a[k] == b[k], k
    np.testing.assert_allclose(a["member_quantiles_s"],
                               b["member_quantiles_s"], rtol=1e-5)
    split = {"p": 3e-5, "ci_lo": 1e-5, "ci_hi": 9e-5}
    assert got.slo_violation(10.0, splitting=split) == \
        want.slo_violation(10.0, splitting=split)


def test_protected_fleet_refusals(psim):
    _, sim = psim
    src = TorchDraws(0, "cpu")
    # the folded mode serves protected fleets: an explicit "vmap" runs
    # and equals the member-by-member fleet
    folded, mapped = (
        sim.run_policies_ensemble(LoadModel(**OPEN), N, src,
                                  EnsembleSpec.of(2, mode=mode),
                                  block_size=BLOCK, window_s=WIN)
        for mode in ("vmap", "map")
    )
    assert_stacks(folded.summaries, mapped.summaries)
    assert_policy_summary_equal(folded.policies, mapped.policies)
    with pytest.raises(ValueError, match="saturated"):
        sim.run_policies_ensemble(LoadModel(**SAT), N, src,
                                  EnsembleSpec.of(2))
    with pytest.raises(ValueError, match="rollout tables"):
        sim.run_rollouts_ensemble(LoadModel(**OPEN), N, src,
                                  EnsembleSpec.of(2))
    # the carry export runs (tests/test_torch_search.py); with trim it
    # raises the reference's refusal
    with pytest.raises(ValueError, match="carry export .*trim=False"):
        sim.run_policies_ensemble(LoadModel(**OPEN), N, src,
                                  EnsembleSpec.of(2), return_carry=True,
                                  trim=True)
    plain = Simulator(sim.compiled, SimParams(), device="cpu")
    with pytest.raises(ValueError, match="policy tables"):
        plain.run_policies_ensemble(LoadModel(**OPEN), N, src,
                                    EnsembleSpec.of(2))
