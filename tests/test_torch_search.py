"""The search brackets and the fleets' carry export of the port
(``sim/search.py``, ``Simulator.run_search`` / ``run_search_protected``,
``run_ensemble(carry_in=, return_carry=, block_offset=)``) against the
JAX package's, on its draws.

The port's candidates draw from ``RootedSource(source, seed)``, which
``JaxReplayDraws`` replays as the reference's ``fold_in(key, seed)``;
the tie-break uniforms are the reference's (``tiebreak_draws`` of the
port replaced by the JAX one's values, as ``test_torch_controlplane.py``
does for the push's normals).  Tolerances: lineages (candidates,
severity, order, survivors) and the winner exactly; summaries with
integers exactly and float sums at rtol 1e-5 / atol 1e-9 s; carried
segments against the unbroken fleet on the exact fields (counts, hop
events, histograms, minima and maxima, ``end_max``) bit for bit.
The sizes are the reference's tests' (``tests/test_search.py``).
"""
from __future__ import annotations

import io
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.compiler.compile import ensemble_take as jax_take
from isotope_tpu.compiler.compile import rung_bucket as jax_rung_bucket
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.runner import load_toml as jax_load_toml
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import ensemble as jax_ens
from isotope_tpu.sim import search as jax_search
from isotope_tpu.sim import summary as jax_summary
from isotope_tpu_torch import cli
from isotope_tpu_torch.analysis import costmodel
from isotope_tpu_torch.compiler import compile_graph, compile_policies
from isotope_tpu_torch.compiler.compile import ensemble_take, rung_bucket
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.runner.config import load_toml
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim import ensemble as ens
from isotope_tpu_torch.sim import search
from isotope_tpu_torch.sim import summary as summary_mod
from isotope_tpu_torch.sim.summary import RunSummary
from test_torch_replay import JaxReplayDraws, scenario_pair

YAML = """
defaults:
  responseSize: 1 KiB
services:
- name: entry
  isEntrypoint: true
  errorRate: 1%
  script:
  - - call: x
    - call: y
  - call: z
- name: x
  numReplicas: 2
- name: y
  script:
  - call: z
- name: z
"""

# the reference's protected bracket topology (tests/test_search.py)
STORM_YAML = """
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

KEY = jax.random.PRNGKey(7)
N, BLOCK = 512, 128  # 4 blocks: rungs screen at 1, then continue to 4
P_N, P_BLOCK, P_WIN = 2_048, 1_024, 0.25
RTOL, ATOL = 1e-5, 1e-9
OPEN = dict(kind="open", qps=2000.0)
PACED = dict(kind="closed", qps=1500.0, connections=8)
P_OPEN = dict(kind="open", qps=4_000.0)
JITTER = dict(qps_jitter=0.2, cpu_jitter=0.1, error_jitter=0.3)
EXACT = ("count", "error_count", "hop_events", "latency_min",
         "latency_max", "latency_hist", "end_max")
INTS = ("count", "error_count", "hop_events", "latency_hist",
        "win_count", "win_error_count", "win_latency_hist", "unstable")
FLOATS = ("latency_sum", "latency_m2", "latency_min", "latency_max",
          "end_max", "utilization")
# the document keys with no torch meaning: the reference's engine
# traces, compile wall and its mode
NO_TORCH_MEANING = ("traces", "mode")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _specs(members=16, eta=4, rungs=2, **kw):
    return (
        jax_search.SearchSpec(
            candidates=jax_ens.EnsembleSpec.from_jitter(members, **JITTER),
            eta=eta, rungs=rungs, **kw),
        search.SearchSpec(
            candidates=ens.EnsembleSpec.from_jitter(members, **JITTER),
            eta=eta, rungs=rungs, **kw),
    )


@pytest.fixture
def ref_tiebreak(monkeypatch):
    """The port's tie-break uniforms replaced by the reference's."""
    def draws(spec, device="cpu"):
        jspec = jax_search.SearchSpec.from_dict(spec.to_dict())
        return torch.from_numpy(
            np.asarray(jax_search.tiebreak_draws(jspec)).copy()
        ).to(device)

    monkeypatch.setattr(search, "tiebreak_draws", draws)


@pytest.fixture(scope="module")
def pair():
    return scenario_pair(jax_compile_graph(JaxGraph.from_yaml(YAML)))


@pytest.fixture(scope="module")
def ppair():
    """The storm topology with its policy tables, in both packages."""
    jg = JaxGraph.from_yaml(STORM_YAML)
    jc = jax_compile_graph(jg)
    jax_sim = JaxSimulator(jc, JaxParams(timeline=True),
                           policies=jax_compile_policies(jg, jc))
    g = ServiceGraph.from_yaml(STORM_YAML)
    c = compile_graph(g)
    sim = Simulator(c, SimParams(timeline=True),
                    policies=compile_policies(g, c), device="cpu")
    return jax_sim, sim


def assert_stacks(got, want, ints=INTS, floats=FLOATS):
    for f in ints:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    for f in floats:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def assert_equal_fields(got, want, fields, what=""):
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)


def assert_same_summaries(got, want):
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or torch.equal(a, b), f


# -- host code: buckets, plans, specs ---------------------------------------


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 16, 17, 63, 64, 65, 1000])
def test_rung_bucket_matches_reference(width):
    assert rung_bucket(width) == jax_rung_bucket(width)


@pytest.mark.parametrize("members,eta,rungs,growth,n,block", [
    (16, 4, 2, None, N, BLOCK), (64, 4, 3, 2, 16_384, 4_096),
    (10, 3, 3, None, 10_000, 100), (16, 4, 2, None, 256, 64),
    (8, 2, 3, 3, 9_000, 1_000),
])
def test_plan_bracket_matches_reference(members, eta, rungs, growth, n,
                                        block):
    jspec, pspec = _specs(members, eta, rungs, growth=growth)
    want = jax_search.plan_bracket(jspec, n, block)
    got = search.plan_bracket(pspec, n, block)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert pspec.rung_widths() == jspec.rung_widths()


def test_plan_bracket_rejects_a_flat_horizon_like_reference():
    jspec, pspec = _specs()
    with pytest.raises(ValueError) as want:
        jax_search.plan_bracket(jspec, BLOCK, BLOCK)
    with pytest.raises(ValueError) as got:
        search.plan_bracket(pspec, BLOCK, BLOCK)
    assert str(got.value) == str(want.value) and "VET-T026" in str(got.value)


@pytest.mark.parametrize("kw", [
    dict(eta=1), dict(rungs=0), dict(growth=1), dict(rank="latency_hist"),
    dict(rank="p99"), dict(chunk=0),
])
def test_spec_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jax_search.SearchSpec(candidates=jax_ens.EnsembleSpec.of(8), **kw)
    with pytest.raises(ValueError) as got:
        search.SearchSpec(candidates=ens.EnsembleSpec.of(8), **kw)
    assert str(got.value) == str(want.value)


def test_spec_check_and_dict_round_trip_match_reference():
    with pytest.raises(ValueError) as want:
        jax_search.SearchSpec(candidates=jax_ens.EnsembleSpec.of(4), eta=4,
                              rungs=3).check()
    with pytest.raises(ValueError) as got:
        search.SearchSpec(candidates=ens.EnsembleSpec.of(4), eta=4,
                          rungs=3).check()
    assert str(got.value) == str(want.value)
    jspec, pspec = _specs(rank="p99", slo_s=0.25, seed=3, chunk=4)
    assert pspec.to_dict() == jspec.to_dict()
    back = search.SearchSpec.from_dict(json.loads(json.dumps(
        jspec.to_dict())))
    assert back.to_dict() == jspec.to_dict()
    assert back.members == 16 and back.resolved_growth() == 4


def test_search_carry_bytes_and_auto_chunk_match_reference(pair,
                                                           monkeypatch):
    from isotope_tpu.analysis import costmodel as jax_costmodel

    jax_sim, sim = pair
    for c in (0, 1, 8, 64):
        assert costmodel.search_carry_bytes(c) == \
            jax_costmodel.search_carry_bytes(c)
    # the CPU reports no capacity: the whole rung is one chunk
    assert search.search_auto_chunk(sim, 16, BLOCK, 0) == 16
    monkeypatch.setenv(costmodel.ENV_DEVICE_BYTES, "200000")
    for c in (0, 8):
        assert search.search_auto_chunk(sim, 64, BLOCK, c) == \
            jax_search.search_auto_chunk(jax_sim, 64, BLOCK, c)


def test_ensemble_take_keeps_rows_bit_for_bit():
    """``ensemble_take`` over a NamedTuple, a tuple and a dict: the
    gathered rows are the source rows, as the reference's ``jnp.take``
    gathers them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    y = rng.integers(0, 9, 6).astype(np.int64)
    idx = np.array([4, 0, 4, 2])
    want = jax_take((x, {"y": y}), idx)
    got = ensemble_take((torch.from_numpy(x), {"y": torch.from_numpy(y)},
                         None), torch.from_numpy(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1]["y"].numpy(),
                                  np.asarray(want[1]["y"]))
    assert got[2] is None
    from isotope_tpu_torch.sim.engine import FleetCarry

    c = FleetCarry(torch.from_numpy(x[:, 0]), torch.from_numpy(x),
                   torch.from_numpy(x[:, 1]))
    g = ensemble_take(c, torch.from_numpy(idx))
    assert isinstance(g, FleetCarry)
    assert torch.equal(g.conn_t0, torch.from_numpy(x[idx]))


def test_rank_order_is_the_reference_lexsort():
    rng = np.random.default_rng(5)
    for _ in range(20):
        sev = rng.integers(0, 4, 33).astype(np.float32) / 4
        tb = rng.random(33).astype(np.float32)
        tb[:5] = tb[5]  # ties in both keys keep their row order
        sev[:6] = sev[0]
        want = np.asarray(jax.numpy.lexsort((tb, sev)))
        got = search.rank_order(torch.from_numpy(sev), torch.from_numpy(tb))
        np.testing.assert_array_equal(got.numpy(), want)


def test_tiebreak_draws_are_a_function_of_the_spec():
    _, pspec = _specs(seed=3)
    a = search.tiebreak_draws(pspec)
    b = search.tiebreak_draws(pspec, "cpu")
    assert a.dtype == torch.float32 and a.shape == (16,)
    assert torch.equal(a, b) and len(set(a.tolist())) == 16
    _, other = _specs(seed=4)
    assert not torch.equal(a, search.tiebreak_draws(other))


def test_summary_accumulate_matches_reference(pair):
    """The streaming merge of two member rows of a JAX fleet, in both
    packages on the same numbers."""
    jax_sim, _ = pair
    fleet = jax_sim.run_ensemble(JaxLoad(**OPEN), N, KEY,
                                 jax_ens.EnsembleSpec.of(2),
                                 block_size=BLOCK)
    rows = [jax.tree.map(lambda x: x[k], fleet.summaries) for k in (0, 1)]
    want = jax_summary.summary_accumulate(*rows)
    got = summary_mod.summary_accumulate(*(
        RunSummary(*(None if x is None
                     else torch.from_numpy(np.asarray(x).copy())
                     for x in r)) for r in rows
    ))
    for f in got._fields:
        if f != "metrics":
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


# -- the plain fleets' carry export -------------------------------------------


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_zero_carry_at_offset_zero_is_the_plain_fleet(pair, mode):
    _, sim = pair
    src = TorchDraws(3, "cpu")
    spec = ens.EnsembleSpec.from_jitter(5, mode=mode, **JITTER)
    plain = sim.run_ensemble(LoadModel(**PACED), N, src, spec,
                             block_size=BLOCK)
    carried, carry = sim.run_ensemble(
        LoadModel(**PACED), N, src, spec, block_size=BLOCK,
        carry_in=sim.zero_ensemble_carry(5, 8), return_carry=True,
    )
    assert_same_summaries(carried.summaries, plain.summaries)
    t0, conn_t0, req_off = carry
    assert t0.shape == (5,) and conn_t0.shape == (5, 8)
    assert req_off.tolist() == [float(N // 8)] * 5


@pytest.mark.parametrize("mode", ["map", "vmap"])
@pytest.mark.parametrize("load", ["open", "paced"])
def test_two_carried_segments_equal_the_unbroken_fleet(pair, mode, load):
    _, sim = pair
    lm = LoadModel(**(OPEN if load == "open" else PACED))
    src = TorchDraws(4, "cpu")
    spec = ens.EnsembleSpec.from_jitter(4, mode=mode, **JITTER)
    full = sim.run_ensemble(lm, N, src, spec, block_size=BLOCK)
    first, carry = sim.run_ensemble(lm, BLOCK, src, spec, block_size=BLOCK,
                                    return_carry=True)
    rest, end = sim.run_ensemble(lm, N - BLOCK, src, spec,
                                 block_size=BLOCK, carry_in=carry,
                                 block_offset=1, return_carry=True)
    for k in range(4):
        joined = summary_mod.summary_accumulate(first.member(k),
                                                rest.member(k))
        assert_equal_fields(joined, full.member(k), EXACT, (mode, load, k))
        torch.testing.assert_close(joined.latency_sum,
                                   full.member(k).latency_sum, rtol=RTOL,
                                   atol=ATOL)
    _, unbroken = sim.run_ensemble(lm, N, src, spec, block_size=BLOCK,
                                   return_carry=True)
    for a, b in zip(end, unbroken):
        assert torch.equal(a, b)


def test_carry_export_matches_reference(pair):
    """The carried segment and its carry, against the JAX fleet's on the
    same draws."""
    jax_sim, sim = pair
    jspec = jax_ens.EnsembleSpec.from_jitter(3, mode="map", **JITTER)
    pspec = ens.EnsembleSpec.from_jitter(3, mode="map", **JITTER)
    jfirst, jcarry = jax_sim.run_ensemble(
        JaxLoad(**PACED), BLOCK, KEY, jspec, block_size=BLOCK,
        return_carry=True)
    want, wcarry = jax_sim.run_ensemble(
        JaxLoad(**PACED), 2 * BLOCK, KEY, jspec, block_size=BLOCK,
        carry_in=jcarry, block_offset=1, return_carry=True)
    src = JaxReplayDraws(KEY, jax_sim)
    first, carry = sim.run_ensemble(LoadModel(**PACED), BLOCK, src, pspec,
                                    block_size=BLOCK, return_carry=True)
    got, gcarry = sim.run_ensemble(LoadModel(**PACED), 2 * BLOCK, src,
                                   pspec, block_size=BLOCK, carry_in=carry,
                                   block_offset=1, return_carry=True)
    assert_stacks(got.summaries, want.summaries)
    for a, b in zip(gcarry, wcarry):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("kw", [dict(return_carry=True),
                                dict(block_offset=2),
                                dict(carry_in="zero")])
@pytest.mark.parametrize("bad", ["trim", "member_chaos", "timeline"])
def test_carry_export_refusals_match_reference(pair, kw, bad):
    from isotope_tpu.sim.config import ChaosEvent as JaxChaos
    from isotope_tpu_torch.sim.config import ChaosEvent

    jax_sim, sim = pair
    jc = jax_sim.compiled
    jsim = JaxSimulator(jc, JaxParams(timeline=True),
                         chaos=(JaxChaos("x", 0.05, 0.1, 1),))
    from test_torch_replay import port_compiled

    psim = Simulator(port_compiled(jc), SimParams(timeline=True),
                     chaos=(ChaosEvent("x", 0.05, 0.1, 1),), device="cpu")
    extra = {"trim": dict(trim=True), "timeline": dict(timeline=True)}
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("carry_in") == "zero":
        jkw["carry_in"] = jsim.zero_ensemble_carry(2, 0)
        pkw["carry_in"] = psim.zero_ensemble_carry(2, 0)
    if bad == "member_chaos":
        jkw["member_chaos"] = [(JaxChaos("x", 0.05, 0.1, 1),)] * 2
        pkw["member_chaos"] = [(ChaosEvent("x", 0.05, 0.1, 1),)] * 2
    else:
        jkw.update(extra[bad])
        pkw.update(extra[bad])
    with pytest.raises(ValueError) as want:
        jsim.run_ensemble(JaxLoad(**OPEN), 64, KEY,
                          jax_ens.EnsembleSpec.of(2), block_size=64, **jkw)
    with pytest.raises(ValueError) as got:
        psim.run_ensemble(LoadModel(**OPEN), 64, TorchDraws(0, "cpu"),
                          ens.EnsembleSpec.of(2), block_size=64, **pkw)
    assert str(got.value) == str(want.value)


# -- the protected fleets' carry export ---------------------------------------


def test_protected_zero_carry_is_the_protected_fleet(ppair):
    _, sim = ppair
    src = TorchDraws(5, "cpu")
    spec = ens.EnsembleSpec.from_jitter(3, **JITTER)
    lm = LoadModel(**P_OPEN)
    plain = sim.run_policies_ensemble(lm, P_N, src, spec,
                                      block_size=P_BLOCK, window_s=P_WIN)
    carried, carry = sim.run_policies_ensemble(
        lm, P_N, src, spec, block_size=P_BLOCK, window_s=P_WIN,
        return_carry=True)
    assert_same_summaries(carried.summaries, plain.summaries)
    for name in ("timelines", "policies"):
        assert_same_summaries(getattr(carried, name), getattr(plain, name))
    assert carry.pstate.last_window.dtype == torch.int64
    assert carry.pacc.trips.shape == plain.policies.trips.shape


def test_protected_segments_equal_the_unbroken_fleet(ppair):
    """Two carried segments of a protected fleet (the members run
    ``"map"``: the folded block serves no protected member) on the full
    horizon's window grid, as a protected bracket runs them
    (``Simulator._protected_fleet``), equal the unbroken fleet: the
    summaries on the exact fields, the recorder and the policy series
    (carried, so the whole run's) bit for bit."""
    from isotope_tpu_torch.compiler import compile_ensemble

    _, sim = ppair
    src = TorchDraws(6, "cpu")
    spec = ens.EnsembleSpec.from_jitter(3, **JITTER)
    lm = LoadModel(**P_OPEN)
    full = sim.run_policies_ensemble(lm, P_N, src, spec,
                                     block_size=P_BLOCK, window_s=P_WIN)
    tables = compile_ensemble(spec, "cpu")
    args = sim._ensemble_args(lm, P_N, src, spec, tables,
                              block_size=P_BLOCK)
    tl_plan = sim.plan_timeline_windows(P_N, 4_000.0, P_WIN)
    carry = sim.zero_protected_carry(3, 0, tl_plan)
    parts = []
    for b0 in (0, 1):
        outs, carry = sim._protected_fleet(args, tables, range(3), False,
                                           P_WIN, tl_plan, carry,
                                           start_block=b0, num_blocks=1)
        parts.append(outs)
    for k in range(3):
        first, second = ([ens.member_summary(c, k) for c in cols]
                         for cols in parts)
        joined = summary_mod.summary_accumulate(first[0], second[0])
        assert_equal_fields(joined, full.member(k), EXACT, k)
        assert_same_summaries(second[1], full.member_timeline(k))
        assert_same_summaries(second[2], full.member_policies(k))
    # resuming from a gathered carry row continues that member alone
    from isotope_tpu_torch.compiler.compile import ensemble_take

    first, _ = sim._protected_fleet(
        args, tables, range(3), False, P_WIN, tl_plan,
        sim.zero_protected_carry(3, 0, tl_plan), num_blocks=1)
    _, mid = sim._protected_fleet(
        args, tables, range(3), False, P_WIN, tl_plan,
        sim.zero_protected_carry(3, 0, tl_plan), num_blocks=1)
    outs, _ = sim._protected_fleet(
        args, tables, [2], False, P_WIN, tl_plan,
        ensemble_take(mid, torch.tensor([2])), start_block=1,
        num_blocks=1)
    assert_same_summaries(ens.member_summary(outs[2], 0),
                          full.member_policies(2))


def test_protected_carry_refusals_match_reference(ppair):
    jax_sim, sim = ppair
    for kw in (dict(trim=True, return_carry=True),
               dict(attribution=True, block_offset=1)):
        with pytest.raises(ValueError) as want:
            jax_sim.run_policies_ensemble(
                JaxLoad(**P_OPEN), P_N, KEY, jax_ens.EnsembleSpec.of(2),
                block_size=P_BLOCK, window_s=P_WIN, **kw)
        with pytest.raises(ValueError) as got:
            sim.run_policies_ensemble(
                LoadModel(**P_OPEN), P_N, TorchDraws(0, "cpu"),
                ens.EnsembleSpec.of(2), block_size=P_BLOCK, window_s=P_WIN,
                **kw)
        assert str(got.value) == str(want.value)


# -- the plain bracket -----------------------------------------------------


@pytest.fixture(scope="module")
def brackets(pair):
    """The canonical bracket (16 -> 4 -> winner over 1 then 4 blocks) in
    both packages on the same draws and tie-breaks."""
    jax_sim, sim = pair
    jspec, pspec = _specs()
    want = jax_sim.run_search(JaxLoad(**OPEN), N, KEY, jspec,
                              block_size=BLOCK)
    tb = torch.from_numpy(np.asarray(jax_search.tiebreak_draws(jspec)).copy())
    real = search.tiebreak_draws
    search.tiebreak_draws = lambda spec, device="cpu": tb.to(device)
    try:
        got = sim.run_search(LoadModel(**OPEN), N,
                             JaxReplayDraws(KEY, jax_sim), pspec,
                             block_size=BLOCK)
    finally:
        search.tiebreak_draws = real
    return got, want, pspec


def assert_lineage_equal(got, want):
    assert got.winner == want.winner
    assert got.winner_severity == want.winner_severity
    assert len(got.rungs) == len(want.rungs)
    for a, b in zip(got.rungs, want.rungs):
        for f in ("rung", "width", "chunk", "start_block", "num_blocks",
                  "cum_requests"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("candidates", "severity", "order", "survivors"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert_stacks(a.summaries, b.summaries)


def test_search_matches_reference(brackets):
    got, want, _ = brackets
    assert_lineage_equal(got, want)
    assert got.mode == "map" and got.traces == 0
    np.testing.assert_array_equal(got.offered_qps, want.offered_qps)
    w, jw = got.winner_summary(), want.winner_summary()
    assert_stacks(w, jw)
    p, jp = got.pooled(), want.pooled()
    assert_stacks(p, jp)


def test_search_document_matches_reference(brackets, tmp_path):
    got, want, _ = brackets
    doc, wdoc = got.to_doc("svc.search"), want.to_doc("svc.search")
    assert doc.keys() == wdoc.keys()
    for k in doc:
        if k in NO_TORCH_MEANING:
            continue
        if k == "lineage":
            for a, b in zip(doc[k], wdoc[k]):
                ev_a, ev_b = a.pop("evidence"), b.pop("evidence")
                assert a == b
                assert ev_a.keys() == ev_b.keys()
                assert ev_a["rank_order"] == ev_b["rank_order"]
                assert ev_a["traces"] == 0 and ev_a["compile_s"] == 0.0
            continue
        assert doc[k] == wdoc[k], k
    assert doc["traces"] == 0 and doc["mode"] == "map"
    wire = json.loads(json.dumps(got.to_doc("svc.search")))
    assert search.check_doc(wire) is wire
    path = tmp_path / "x.search.json"
    path.write_text(json.dumps(wire))
    assert search.load_doc(str(path))["winner"]["candidate"] == got.winner
    with pytest.raises(ValueError) as w:
        jax_search.check_doc({"schema": "isotope-ensemble/v1"})
    with pytest.raises(ValueError) as g:
        search.check_doc({"schema": "isotope-ensemble/v1"})
    assert str(g.value) == str(w.value)


def test_rung0_bit_equals_run_ensemble(pair, brackets):
    jax_sim, sim = pair
    got, _, pspec = brackets
    fleet = sim.run_ensemble(LoadModel(**OPEN), BLOCK,
                             JaxReplayDraws(KEY, jax_sim), pspec.candidates,
                             block_size=BLOCK)
    assert list(got.rungs[0].candidates) == list(range(16))
    assert_same_summaries(got.rungs[0].summaries, fleet.summaries)


def test_every_survivor_continuation_matches_its_unbroken_member(
        pair, brackets):
    jax_sim, sim = pair
    got, _, pspec = brackets
    full = sim.run_ensemble(LoadModel(**OPEN), N,
                            JaxReplayDraws(KEY, jax_sim), pspec.candidates,
                            block_size=BLOCK)
    r0, r1 = got.rungs
    for row, c in enumerate(r1.candidates):
        joined = summary_mod.summary_accumulate(
            ens.member_summary(r0.summaries, int(c)),
            ens.member_summary(r1.summaries, row),
        )
        assert_equal_fields(joined, full.member(int(c)), EXACT, int(c))
    assert_equal_fields(got.winner_summary(), full.member(got.winner),
                        EXACT, "winner")


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_chunked_bracket_equals_unchunked(pair, mode):
    _, sim = pair
    src = TorchDraws(8, "cpu")
    spec = search.SearchSpec(
        candidates=ens.EnsembleSpec.from_jitter(16, mode=mode, **JITTER),
        eta=4, rungs=2)
    whole = sim.run_search(LoadModel(**OPEN), N, src, spec,
                           block_size=BLOCK)
    chunked = sim.run_search(LoadModel(**OPEN), N, src, spec,
                             block_size=BLOCK, chunk=3)
    assert whole.mode == mode and whole.rungs[0].chunk == 16
    assert [r.chunk for r in chunked.rungs] == [2, 2]  # floor_pow2(3)
    assert chunked.winner == whole.winner
    for a, b in zip(chunked.rungs, whole.rungs):
        np.testing.assert_array_equal(a.candidates, b.candidates)
        np.testing.assert_array_equal(a.survivors, b.survivors)
        assert_same_summaries(a.summaries, b.summaries)


def test_folded_bracket_matches_the_map_bracket(pair):
    """The folded rungs (one block of M x N rows) against the members
    one by one: the same lineage, integers exactly, sums in band."""
    _, sim = pair
    src = TorchDraws(9, "cpu")
    runs = [
        sim.run_search(LoadModel(**PACED), N, src, search.SearchSpec(
            candidates=ens.EnsembleSpec.from_jitter(16, mode=mode,
                                                    **JITTER),
            eta=4, rungs=2), block_size=BLOCK)
        for mode in ("map", "vmap")
    ]
    for a, b in zip(runs[1].rungs, runs[0].rungs):
        np.testing.assert_array_equal(a.candidates, b.candidates)
        np.testing.assert_array_equal(a.order, b.order)
        assert_stacks(a.summaries, b.summaries)
    assert runs[1].winner == runs[0].winner


def test_rank_ties_resolve_by_the_tiebreak_draws():
    """No error anywhere: every severity is 0 and the tie-break alone
    decides the lineage, whatever the run's draws."""
    g = ServiceGraph.from_yaml("""
defaults:
  responseSize: 1 KiB
services:
- name: entry
  isEntrypoint: true
  script:
  - call: z
- name: z
""")
    sim = Simulator(compile_graph(g), device="cpu")
    spec = search.SearchSpec(candidates=ens.EnsembleSpec.of(8), eta=2,
                             rungs=2, seed=3)
    a = sim.run_search(LoadModel(**OPEN), 256, TorchDraws(7, "cpu"), spec,
                       block_size=128)
    assert np.all(a.rungs[0].severity == 0.0)
    expected = np.argsort(search.tiebreak_draws(spec).numpy(),
                          kind="stable")
    assert list(a.rungs[0].survivors) == list(expected[:4])
    assert a.winner == int(expected[0])
    b = sim.run_search(LoadModel(**OPEN), 256, TorchDraws(99, "cpu"), spec,
                       block_size=128)
    assert b.winner == a.winner
    assert list(b.rungs[1].candidates) == list(a.rungs[1].candidates)


def test_p99_rank_matches_reference(pair, ref_tiebreak):
    jax_sim, sim = pair
    jspec, pspec = _specs(rank="p99", slo_s=0.002)
    want = jax_sim.run_search(JaxLoad(**OPEN), N, KEY, jspec,
                              block_size=BLOCK)
    got = sim.run_search(LoadModel(**OPEN), N, JaxReplayDraws(KEY, jax_sim),
                         pspec, block_size=BLOCK)
    assert_lineage_equal(got, want)


# -- the protected bracket ----------------------------------------------------


@pytest.fixture(scope="module")
def pbrackets(ppair):
    jax_sim, sim = ppair
    out = {}
    for rank in ("err_share", "trips"):
        jspec, pspec = _specs(8, rank=rank)
        want = jax_sim.run_search_protected(
            JaxLoad(**P_OPEN), P_N, KEY, jspec, block_size=P_BLOCK,
            window_s=P_WIN)
        tb = torch.from_numpy(
            np.asarray(jax_search.tiebreak_draws(jspec)).copy())
        real = search.tiebreak_draws
        search.tiebreak_draws = lambda spec, device="cpu": tb.to(device)
        try:
            got = sim.run_search_protected(
                LoadModel(**P_OPEN), P_N, JaxReplayDraws(KEY, jax_sim),
                pspec, block_size=P_BLOCK, window_s=P_WIN)
        finally:
            search.tiebreak_draws = real
        out[rank] = (got, want, pspec)
    return out


@pytest.mark.parametrize("rank", ["err_share", "trips"])
def test_protected_search_matches_reference(pbrackets, rank):
    got, want, _ = pbrackets[rank]
    assert_lineage_equal(got, want)
    doc, wdoc = got.to_doc(), want.to_doc()
    assert doc["rank_effective"] == wdoc["rank_effective"] == rank
    assert doc["winner"] == wdoc["winner"]
    search.check_doc(doc)


def test_protected_rung0_bit_equals_the_protected_fleet(ppair, pbrackets):
    jax_sim, sim = ppair
    got, _, pspec = pbrackets["err_share"]
    r0 = got.rungs[0]
    fleet = sim.run_policies_ensemble(
        LoadModel(**P_OPEN), r0.cum_requests, JaxReplayDraws(KEY, jax_sim),
        pspec.candidates, block_size=P_BLOCK, window_s=P_WIN)
    assert_same_summaries(r0.summaries, fleet.summaries)


def test_protected_winner_resume_equals_the_unbroken_fleet(ppair,
                                                           pbrackets):
    """The winner's rung-0 and rung-1 segments (control state carried
    between rungs) accumulate to the unbroken fleet's member row."""
    jax_sim, sim = ppair
    got, _, pspec = pbrackets["trips"]
    full = sim.run_policies_ensemble(
        LoadModel(**P_OPEN), P_N, JaxReplayDraws(KEY, jax_sim),
        pspec.candidates, block_size=P_BLOCK, window_s=P_WIN)
    assert_equal_fields(got.winner_summary(), full.member(got.winner),
                        EXACT, "winner")


def test_protected_bracket_rejections_match_reference(pair, ppair):
    jax_sim, sim = pair
    jpsim, psim = ppair
    jspec, pspec = _specs(8)
    cases = [
        ((jax_sim, JaxLoad(**OPEN), N, BLOCK),
         (sim, LoadModel(**OPEN), N, BLOCK)),
        ((jpsim, JaxLoad(kind="closed", qps=None, connections=8), P_N,
          P_BLOCK),
         (psim, LoadModel(kind="closed", qps=None, connections=8), P_N,
          P_BLOCK)),
    ]
    for (js, jl, n, b), (ps, pl, _, _) in cases:
        with pytest.raises(ValueError) as want:
            js.run_search_protected(jl, n, KEY, jspec, block_size=b)
        with pytest.raises(ValueError) as got:
            ps.run_search_protected(pl, n, TorchDraws(0, "cpu"), pspec,
                                    block_size=b)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="rollout"):
        psim.run_search_protected(LoadModel(**P_OPEN), P_N,
                                  TorchDraws(0, "cpu"), pspec, roll=True)


# -- the [search] TOML block and the search command ---------------------------


TOML = """
topology_paths = ["{topo}"]
environments = ["NONE"]

[client]
qps = [500]
num_concurrent_connections = [8]
duration = "60s"
load_kind = "open"

[sim]
num_requests = 512
seed = 7

[search]
candidates = 16
eta = 4
rungs = 2
rank = "p99"
slo = "250ms"
jitter = "qps=0.2,cpu=0.1,error=0.3"
seed = 3
"""


def test_toml_search_block_decodes_like_reference(tmp_path):
    topo = tmp_path / "t.yaml"
    topo.write_text(YAML)
    cfg = tmp_path / "exp.toml"
    cfg.write_text(TOML.format(topo=topo))
    got, want = load_toml(cfg), jax_load_toml(cfg)
    for f in ("search_candidates", "search_eta", "search_rungs",
              "search_growth", "search_rank", "search_slo_s",
              "search_jitter", "search_seed"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.search_spec().to_dict() == want.search_spec().to_dict()
    for bad in ("candidats = 16", "eta = 1\ncandidates = 8",
                'jitter = "latency=3"', "candidates = 4\nrungs = 3"):
        cfg.write_text(TOML.format(topo=topo).split("[search]")[0]
                       + "[search]\n" + bad + "\n")
        with pytest.raises(ValueError) as w:
            jax_load_toml(cfg)
        with pytest.raises(ValueError) as g:
            load_toml(cfg)
        assert str(g.value) == str(w.value), bad


CANONICAL = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "topologies" / "canonical.yaml"


def _search_both(monkeypatch, flags, seed=0):
    """The JAX ``search`` command and the port's on its draws
    (``PRNGKey(seed)``) and tie-breaks."""
    import isotope_tpu_torch.sim
    from isotope_tpu import cli as jax_cli

    key = jax.random.PRNGKey(seed)
    monkeypatch.setattr(isotope_tpu_torch.sim, "TorchDraws",
                        lambda seed, device: JaxReplayDraws(key))

    def tiebreak(spec, device="cpu"):
        jspec = jax_search.SearchSpec.from_dict(spec.to_dict())
        return torch.from_numpy(
            np.asarray(jax_search.tiebreak_draws(jspec)).copy()
        ).to(device)

    monkeypatch.setattr(search, "tiebreak_draws", tiebreak)
    out = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            rc = main(["search", str(CANONICAL)] + flags + extra
                      + ["--seed", str(seed)])
        assert rc == 0, err.getvalue()
        out[side] = (buf.getvalue(), err.getvalue())
    return out


def test_search_command_matches_reference(monkeypatch, tmp_path):
    flags = ["--qps", "1000", "--duration", "2s", "--candidates", "8",
             "--eta", "2", "--rungs", "2", "--jitter",
             "qps=0.2,cpu=0.1,error=0.3,seed=1"]
    out = _search_both(monkeypatch, flags + ["--json"])
    doc, wdoc = (json.loads(out[s][0]) for s in ("port", "jax"))
    assert doc["schema"] == "isotope-search/v1"
    for k in doc:
        if k == "lineage":
            for a, b in zip(doc[k], wdoc[k]):
                a.pop("evidence"), b.pop("evidence")
                assert a == b
        elif k not in NO_TORCH_MEANING:
            assert doc[k] == wdoc[k], k
    # the table: every line but the header's trace count and mode
    out = _search_both(monkeypatch, flags[:-2] + ["--rank", "err_share"])
    port_lines = out["port"][0].splitlines()
    jax_lines = out["jax"][0].splitlines()
    assert port_lines[1:] == jax_lines[1:]
    assert port_lines[0].split(", rank=")[0] == \
        jax_lines[0].split(", rank=")[0]
    assert "no --jitter given" in out["port"][1]
    assert "no --jitter given" in out["jax"][1]


def test_search_command_writes_its_document(tmp_path):
    out_file = tmp_path / "s.json"
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = cli.main(["search", str(CANONICAL), "--qps", "500",
                       "--duration", "1s", "--candidates", "4", "--eta",
                       "2", "--rungs", "2", "--device", "cpu", "--out",
                       str(out_file)])
    assert rc == 0
    doc = search.load_doc(str(out_file))
    assert doc["mode"] == "map" and doc["candidates"] == 4
    assert buf.getvalue().splitlines()[-1].startswith("winner: candidate")


def test_planted_winner_wins_on_the_reference_draws(ref_tiebreak):
    """The reference's planted-winner bracket (``tools/search_smoke.py``:
    ``1000-svc_2000-end`` with its entry at 2% errors, 16 candidates,
    candidate 5's error scale 1e-3 against >= 0.8, 256 requests in
    blocks of 64, ``PRNGKey(42)``): on the reference's draws and
    tie-breaks the port crowns candidate 5 through the same lineage."""
    import yaml

    doc = yaml.safe_load((CANONICAL.parent / "1000-svc_2000-end.yaml")
                         .read_text())
    doc["services"][0]["errorRate"] = "2%"
    jc = jax_compile_graph(JaxGraph.decode(doc))
    jax_sim = JaxSimulator(jc)
    from test_torch_replay import port_compiled

    sim = Simulator(port_compiled(jc), device="cpu")
    err = 0.8 + 0.08 * np.arange(16, dtype=np.float64)
    err[5] = 1e-3
    key = jax.random.PRNGKey(42)
    want = jax_sim.run_search(
        JaxLoad(kind="open", qps=10_000.0), 256, key, jax_search.SearchSpec(
            candidates=jax_ens.EnsembleSpec(seeds=tuple(range(16)),
                                            error_scale=err, mode="map"),
            eta=4, rungs=2), block_size=64)
    got = sim.run_search(
        LoadModel(kind="open", qps=10_000.0), 256,
        JaxReplayDraws(key, jax_sim), search.SearchSpec(
            candidates=ens.EnsembleSpec(seeds=tuple(range(16)),
                                        error_scale=err),
            eta=4, rungs=2), block_size=64)
    assert want.winner == 5
    assert_lineage_equal(got, want)
    assert got.winner_config()["error_scale"] == 1e-3
