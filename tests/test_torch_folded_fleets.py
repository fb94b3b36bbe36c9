"""The folded (``"vmap"``) member axis of chaos, protected and observed
fleets (``Simulator.run_ensemble`` / ``run_policies_ensemble`` /
``run_rollouts_ensemble`` / ``run_search_protected``), on the CPU with
an explicit ``"vmap"``.

Each case is held to its ``"map"`` twin (the members one by one through
the solo block loop) and to the JAX package's fleet on its replayed
draws (``JaxReplayDraws``):

- against the ``"map"`` twin: integers exactly (counts, hop events,
  histograms, the recorder's counts, the control series, trips, blame
  counts), float sums at rtol 1e-5 / atol 1e-9 s (float32 summation
  order), blame histograms within one adjacent bucket;
- against the JAX package's ``"map"`` fleet: the bands its ``"map"``
  fleets already meet (``tests/test_torch_chaosfleet.py``,
  ``tests/test_torch_fleetblame.py``, ``tests/test_torch_search.py``,
  ``tests/test_torch_splitting.py``); the reference's observed fleets
  are not a clean oracle, so an observed fleet is also held to the JAX
  ``fleetblame`` documents of its own stacks.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import fleetblame as jax_fb
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.resilience.faults import ChaosJitterSpec as JaxJitter
from isotope_tpu.runner.run import _splitting_pass as jax_splitting_pass
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import config as jax_config
from isotope_tpu.sim import search as jax_search
from isotope_tpu.sim import splitting as jax_split
from isotope_tpu.sim.ensemble import EnsembleSpec as JaxSpec
from isotope_tpu_torch.compiler import compile_ensemble
from isotope_tpu_torch.metrics import fleetblame
from isotope_tpu_torch.resilience import faults
from isotope_tpu_torch.runner.run import splitting_pass
from isotope_tpu_torch.sim import LoadModel, TorchDraws
from isotope_tpu_torch.sim import ensemble as ens
from isotope_tpu_torch.sim import search
from isotope_tpu_torch.sim import splitting as split
from isotope_tpu_torch.sim import summary as summary_mod
from test_torch_attribution import assert_attr_match
from test_torch_chaosfleet import (
    BASE_YAML,
    CHAOS,
    LB_YAML,
    ROLLOUT_YAML,
    SAT,
    STORM,
    UNGRACEFUL,
    _build,
    _jittered,
)
from test_torch_ensemble import assert_stacks
from test_torch_fleetblame import _docs_equal, _pair, _to_jax
from test_torch_policies import assert_policy_summary_equal
from test_torch_replay import JaxReplayDraws
from test_torch_rollout import assert_rollout_summary_match
from test_torch_timeline import assert_timeline_match

KEY = jax.random.PRNGKey(7)
OPEN = dict(kind="open", qps=4_000.0)
N, BLOCK, WIN = 1_024, 512, 0.1
MEMBERS = 3
JITTER = dict(qps_jitter=0.3, cpu_jitter=0.1, error_jitter=0.3)
#: the storm topology past its breakers' caps: members trip, and their
#: jittered rates give them different live windows a block
STORM_QPS, STORM_N, STORM_BLOCK, STORM_WIN = 8_000.0, 2_048, 256, 0.01


def _specs(members=MEMBERS, jitter=True):
    kw = JITTER if jitter else {}
    return (JaxSpec.from_jitter(members, mode="map", **kw),
            ens.EnsembleSpec.from_jitter(members, mode="vmap", **kw),
            ens.EnsembleSpec.from_jitter(members, mode="map", **kw))


def _jax_events(events):
    return tuple(jax_config.ChaosEvent(**dataclasses.asdict(e))
                 for e in events)


def _member_schedules(sim):
    """The members' explicit schedules: the base one and two jitters."""
    port = [sim._chaos_events] + [_jittered(sim._chaos_events, k)
                                  for k in range(1, MEMBERS)]
    return port, [_jax_events(e) for e in port]


def _same(a, b, what=""):
    """Two stacked NamedTuples equal leaf for leaf."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            _same(x, y, f"{what}.{f}")
        elif x is not None or y is not None:
            assert torch.equal(x, y), f"{what}.{f}"


def _folded_equals_map(folded, mapped):
    """The contract against the ``"map"`` twin."""
    assert folded.member_chaos == mapped.member_chaos
    assert_stacks(folded.summaries, mapped.summaries)
    for name in ("timelines", "policies", "rollouts"):
        a, b = getattr(folded, name), getattr(mapped, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _same(a, b, name)
    a, b = folded.attributions, mapped.attributions
    assert (a is None) == (b is None)
    if a is not None:
        for k in range(folded.spec.members):
            lat = float(mapped.summaries.latency_sum[k])
            assert_attr_match(folded.member_attribution(k),
                              mapped.member_attribution(k), lat)


# -- the cases ------------------------------------------------------------


def _chaos_case(yaml, chaos, load, lb=False):
    js, sim = _build(yaml, chaos=(chaos,), lb=lb)
    pev, jev = _member_schedules(sim)
    jspec, vspec, mspec = _specs(jitter=load is OPEN)
    src = JaxReplayDraws(KEY, js)
    folded, mapped = (
        sim.run_ensemble(LoadModel(**load), N, src, spec, block_size=BLOCK,
                         member_chaos=pev)
        for spec in (vspec, mspec)
    )
    _folded_equals_map(folded, mapped)
    want = js.run_ensemble(JaxLoad(**load), N, KEY, jspec,
                           block_size=BLOCK, member_chaos=jev)
    if load is SAT:
        assert_stacks(folded.summaries, want.summaries, 1e-4, 1e-5,
                      exact=("count", "error_count", "hop_events"),
                      close=("latency_sum", "latency_max"))
    else:
        assert_stacks(folded.summaries, want.summaries)


def _protected_case(roll=False, member_chaos=False, attribution=False):
    text = STORM + ROLLOUT_YAML if roll else STORM
    js, sim = _build(text, chaos=(CHAOS,),
                     params=dict(timeline=True, attribution=attribution),
                     pol=True, roll=roll)
    jspec, vspec, mspec = _specs()
    kw = dict(block_size=BLOCK, trim=True, window_s=WIN)
    pkw, jkw = dict(kw), dict(kw)
    if member_chaos:
        pkw["member_chaos"], jkw["member_chaos"] = _member_schedules(sim)
    if attribution:
        pkw["attribution"] = jkw["attribution"] = True
    src = JaxReplayDraws(KEY, js)
    run = sim.run_rollouts_ensemble if roll else sim.run_policies_ensemble
    folded, mapped = (run(LoadModel(**OPEN), N, src, spec, **pkw)
                      for spec in (vspec, mspec))
    _folded_equals_map(folded, mapped)
    jrun = js.run_rollouts_ensemble if roll else js.run_policies_ensemble
    want = jrun(JaxLoad(**OPEN), N, KEY, jspec, **jkw)
    assert_stacks(folded.summaries, want.summaries)
    for k in range(MEMBERS):
        assert_timeline_match(folded.member_timeline(k),
                              want.member_timeline(k), f"member {k} ")
        assert_policy_summary_equal(folded.member_policies(k),
                                    want.member_policies(k))
        if roll:
            assert_rollout_summary_match(folded.member_rollouts(k),
                                         want.member_rollouts(k))
        if attribution:
            assert_attr_match(
                folded.member_attribution(k), want.member_attribution(k),
                float(np.asarray(want.summaries.latency_sum)[k]))


def _observed_case(attribution=True, tail=False, timeline=False):
    js, sim = _pair()
    jspec, vspec, mspec = _specs(jitter=False)
    kw = dict(block_size=256, attribution=attribution, tail=tail,
              timeline=timeline)
    if timeline:
        kw["window_s"] = 0.05
    src = JaxReplayDraws(KEY, js)
    folded, mapped = (
        sim.run_ensemble(LoadModel(kind="open", qps=2_000.0), 512, src,
                         spec, **kw)
        for spec in (vspec, mspec)
    )
    _folded_equals_map(folded, mapped)
    want = js.run_ensemble(JaxLoad(kind="open", qps=2_000.0), 512, KEY,
                           jspec, **kw)
    for k in range(MEMBERS):
        if attribution:
            assert_attr_match(
                folded.member_attribution(k), want.member_attribution(k),
                float(np.asarray(want.summaries.latency_sum)[k]))
        if timeline:
            assert_timeline_match(folded.member_timeline(k),
                                  want.member_timeline(k), f"member {k} ")
    if attribution:
        # the explainer on the folded fleet's own stacks, in both packages
        got = fleetblame.to_doc(sim.compiled, folded.attributions,
                                folded.timelines, seeds=vspec.seeds)
        ref = jax_fb.to_doc(
            js.compiled, _to_jax(folded.attributions),
            _to_jax(folded.timelines) if timeline else None,
            seeds=vspec.seeds)
        _docs_equal(got, ref)


def _storm():
    from test_torch_search import STORM_YAML  # its breakers, its HPA

    js, sim = _build(STORM_YAML, chaos=(CHAOS,), params=dict(timeline=True),
                     pol=True)
    return js, sim


def _bracket_case():
    js, sim = _storm()
    cands = dict(members=8, **JITTER)
    jspec = jax_search.SearchSpec(
        candidates=JaxSpec.from_jitter(**cands), eta=2, rungs=2,
        rank="trips")
    specs = [search.SearchSpec(
        candidates=ens.EnsembleSpec.from_jitter(mode=mode, **cands), eta=2,
        rungs=2, rank="trips") for mode in ("vmap", "map")]
    tb = torch.from_numpy(np.asarray(jax_search.tiebreak_draws(jspec)).copy())
    real = search.tiebreak_draws
    search.tiebreak_draws = lambda spec, device="cpu": tb.to(device)
    kw = dict(block_size=STORM_BLOCK, window_s=STORM_WIN)
    load = LoadModel(kind="open", qps=STORM_QPS)
    try:
        folded, mapped = (
            sim.run_search_protected(load, STORM_N, JaxReplayDraws(KEY, js),
                                     spec, **kw)
            for spec in specs
        )
    finally:
        search.tiebreak_draws = real
    assert folded.mode == "vmap" and mapped.mode == "map"
    r0 = folded.rungs[0]
    # the members trip their breakers and live through different windows
    assert (r0.severity > 0).any()
    for a, b in zip(folded.rungs, mapped.rungs):
        for f in ("candidates", "severity", "order", "survivors"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert_stacks(a.summaries, b.summaries)
    assert folded.winner == mapped.winner
    want = js.run_search_protected(JaxLoad(kind="open", qps=STORM_QPS),
                                   STORM_N, KEY, jspec, **kw)
    assert folded.winner == want.winner
    for a, b in zip(folded.rungs, want.rungs):
        for f in ("candidates", "severity", "order", "survivors"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert_stacks(a.summaries, b.summaries)
    # the rung-0 windows the members completed differ
    fleet = sim.run_policies_ensemble(
        load, r0.cum_requests, JaxReplayDraws(KEY, js), specs[0].candidates,
        **kw)
    done = fleet.policies.windows_done.sum(-1)
    assert len(set(done.tolist())) > 1
    assert fleet.policies.trips.sum() > 0


def _splitting_case(monkeypatch):
    """A chaos case's splitting pass with its levels folded: the
    document is the reference's."""
    from test_torch_splitting import CHAOS_YAML, JaxChaos, JaxSimulator

    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator
    from isotope_tpu_torch.sim.config import ChaosEvent

    levels = []
    fold = ens.EnsembleSpec.resolved_mode

    def folded_mode(spec, device=None):
        mode = fold(spec, device) if spec.mode is not None else "vmap"
        levels.append(mode)
        return mode

    monkeypatch.setattr(ens.EnsembleSpec, "resolved_mode", folded_mode)
    jc = jax_compile_graph(JaxGraph.from_yaml(CHAOS_YAML))
    jchaos = (JaxChaos("worker", 0.02, 0.08, 1),)
    jsim = JaxSimulator(jc, chaos=jchaos)
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(CHAOS_YAML)),
                    chaos=(ChaosEvent("worker", 0.02, 0.08, 1),),
                    device="cpu")
    spec_kw = dict(levels=3, members=4, keep=0.5, threshold=0.05,
                   severity="err_share", horizon=0.5, seed=2)
    jitter_kw = dict(time=0.4, magnitude=0.5, seed=1)
    want = jax_splitting_pass(
        jsim, None, False, SimpleNamespace(compiled=jc),
        JaxLoad(kind="open", qps=8_000.0), 1_024, KEY, 256,
        SimpleNamespace(chaos=jchaos, timeline_window_s=10.0), None,
        False, None, jax_split.SplitSpec(**spec_kw), JaxJitter(**jitter_kw),
    )
    got = splitting_pass(
        sim, LoadModel(kind="open", qps=8_000.0), 1_024, JaxReplayDraws(KEY),
        256, split.SplitSpec(**spec_kw),
        chaos_jitter=faults.ChaosJitterSpec(**jitter_kw),
    )
    assert levels and set(levels) == {"vmap"}
    assert want is not None and got == want


def _carry_case():
    """Two carried segments of a folded protected fleet on the full
    horizon's window grid equal the unbroken folded fleet: the clocks,
    the recorder and the control laws resume exactly."""
    js, sim = _build(STORM, chaos=(CHAOS,), params=dict(timeline=True),
                     pol=True)
    jspec, vspec, _ = _specs()
    load = LoadModel(**OPEN)
    src = JaxReplayDraws(KEY, js)
    n = 4 * BLOCK
    kw = dict(block_size=BLOCK, window_s=WIN)
    full = sim.run_policies_ensemble(load, n, src, vspec, **kw)
    tables = compile_ensemble(vspec, "cpu")
    args = sim._ensemble_args(load, n, src, vspec, tables,
                              block_size=BLOCK)
    tl_plan = sim.plan_timeline_windows(n, OPEN["qps"], WIN)
    carry = sim.zero_protected_carry(MEMBERS, 0, tl_plan)
    parts = []
    for b0, blocks in ((0, 1), (1, 3)):
        outs, carry = sim._protected_fleet(
            args, tables, range(MEMBERS), False, WIN, tl_plan, carry,
            start_block=b0, num_blocks=blocks, chunk_sz=2)
        parts.append(outs)
    for k in range(MEMBERS):
        first, second = ([ens.member_summary(c, k) for c in cols]
                         for cols in parts)
        joined = summary_mod.summary_accumulate(first[0], second[0])
        for f in ("count", "error_count", "hop_events", "latency_hist",
                  "latency_min", "latency_max", "end_max"):
            assert torch.equal(getattr(joined, f),
                               getattr(full.member(k), f)), (k, f)
        _same(second[1], full.member_timeline(k), "timeline")
        _same(second[2], full.member_policies(k), "policies")
    assert carry.pstate.last_window.shape == (MEMBERS,)
    want = js.run_policies_ensemble(JaxLoad(**OPEN), n, KEY, jspec, **kw)
    assert_stacks(full.summaries, want.summaries)
    for k in range(MEMBERS):
        assert_timeline_match(full.member_timeline(k),
                              want.member_timeline(k), f"member {k} ")
        assert_policy_summary_equal(full.member_policies(k),
                                    want.member_policies(k))


CASES = {
    "chaos-plain": lambda mp: _chaos_case(BASE_YAML, CHAOS, OPEN),
    "chaos-ungraceful": lambda mp: _chaos_case(BASE_YAML, UNGRACEFUL, OPEN),
    "chaos-lb-panic": lambda mp: _chaos_case(BASE_YAML + LB_YAML, CHAOS,
                                             OPEN, lb=True),
    "chaos-saturated": lambda mp: _chaos_case(BASE_YAML, CHAOS, SAT),
    "protected-policies": lambda mp: _protected_case(),
    "protected-rollouts": lambda mp: _protected_case(roll=True),
    "protected-member-chaos": lambda mp: _protected_case(member_chaos=True),
    "observed-mean-blame": lambda mp: _observed_case(),
    "observed-tail-blame": lambda mp: _observed_case(tail=True),
    "observed-timeline": lambda mp: _observed_case(attribution=False,
                                                   timeline=True),
    "observed-protected-attributed":
        lambda mp: _protected_case(attribution=True),
    "protected-bracket-trips": lambda mp: _bracket_case(),
    "splitting-level": _splitting_case,
    "protected-carry-resume": lambda mp: _carry_case(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_fleet_equals_map_and_reference(case, monkeypatch):
    CASES[case](monkeypatch)


def test_folded_block_census_call_takes_every_member():
    """A folded chaos fleet's block makes one census call a level over
    all M x N rows, with fail steps (down callees)."""
    from isotope_tpu_torch.sim import joins

    _, sim = _build(BASE_YAML, chaos=(CHAOS,))
    pev, _ = _member_schedules(sim)
    rows = []
    real = joins.census

    def spy(step_base, step_mask, agg, fail_step=None, err=None):
        rows.append((agg.shape[0], fail_step is not None))
        return real(step_base, step_mask, agg, fail_step, err)

    joins.census = spy
    try:
        sim.run_ensemble(LoadModel(**OPEN), BLOCK, TorchDraws(0, "cpu"),
                         ens.EnsembleSpec.of(MEMBERS, mode="vmap"),
                         block_size=BLOCK, member_chaos=pev)
    finally:
        joins.census = real
    assert rows and all(r == (MEMBERS * BLOCK, True) for r in rows)
