"""Observed fleets and the fleet-blame explainer of the port
(``Simulator.run_ensemble(attribution=, timeline=)``,
``metrics/fleetblame.py``) against the JAX package's
(``tests/test_fleetblame.py``).

The reference is not a clean oracle here: its own test file fails 4 of
16 tests on the CPU with jax 0.9 (an observed fleet's summaries and a
member's blame are not bit-equal to the plain and solo runs, and its
planted onset lands in window 6).  So the port is held:

- to its own member-equals-solo pins: an observed member (blame and
  the recorder in one block loop) carries the solo ``run_attributed``'s
  AttributionSummary and the solo ``run_timeline``'s TimelineSummary
  bit for bit, and its summary is the plain fleet's;
- to the JAX package's observed fleet on the same draws within the
  attribution bands of ``tests/test_torch_attribution.py``: counts
  exactly, blame seconds at rtol 1e-5 / atol 1e-9 s, residuals within
  16 float32 spacings of the member's latency sum, blame histograms
  within one adjacent bucket for at most 1e-3 of their counts;
- on identical inputs (the JAX fleet's stacks converted), to the JAX
  ``fleetblame``'s documents: integers, names and rankings exactly,
  floats within 2 float32 spacings (rtol 2.4e-7; the reference's
  float32 quantile interpolation rounds the 0.1 / 0.9 band edges one
  spacing apart).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import fleetblame as jax_fb
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim.ensemble import EnsembleSpec as JaxSpec
from isotope_tpu_torch.metrics import fleetblame
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim.config import ChaosEvent
from isotope_tpu_torch.sim.draws import RootedSource
from isotope_tpu_torch.sim.ensemble import EnsembleSpec, tree_map
from test_torch_attribution import assert_attr_match
from test_torch_replay import JaxReplayDraws, scenario_pair
from test_torch_timeline import assert_timeline_match

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
BLAME_YAML = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: worker
- name: worker
  numReplicas: 4
- name: cold
  numReplicas: 2
"""

KEY = jax.random.PRNGKey(7)
OPEN = dict(kind="open", qps=2000.0)
CLOSED = dict(kind="closed", qps=None, connections=8)
N, BLOCK, WIN = 512, 256, 0.05
PARAMS = dict(attribution=True, attribution_top_k=4, timeline=True)
FLOAT_RTOL = 2.4e-7


def _pair(yaml_text=YAML, chaos=()):
    return scenario_pair(jax_compile_graph(JaxGraph.from_yaml(yaml_text)),
                         PARAMS, chaos=chaos)


def _equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            _equal(x, y)
        elif x is not None or y is not None:
            assert torch.equal(x, y), f


# -- the port's own pins: observed member == solo -----------------------------


@pytest.mark.parametrize("load", ["open", "closed"])
def test_observed_member_equals_solo_runs(load):
    _, sim = _pair()
    lm = LoadModel(**(OPEN if load == "open" else CLOSED))
    src = TorchDraws(3, "cpu")
    spec = EnsembleSpec.of(3)
    obs = sim.run_ensemble(lm, N, src, spec, block_size=BLOCK,
                           attribution=True, timeline=True, window_s=WIN)
    plain = sim.run_ensemble(lm, N, src, spec, block_size=BLOCK)
    # arming the observers leaves the fleet's physics as it was
    _equal(obs.summaries, plain.summaries)
    for k in (0, 2):
        mk = RootedSource(src, spec.seeds[k])
        summary, attr = sim.run_attributed(lm, N, mk, block_size=BLOCK)
        _equal(obs.member_attribution(k), attr)
        _equal(obs.member(k), summary)
        _, tl = sim.run_timeline(lm, N, mk, block_size=BLOCK,
                                 window_s=WIN)
        _equal(obs.member_timeline(k), tl)


def test_tail_fleet_cut_is_the_fleet_pilot():
    """``tail=True`` estimates ONE cut on the fleet's source (the
    reference's ``fold_in(key, 777_000)`` pilot); with it, member k is
    the solo tail run at that cut."""
    _, sim = _pair()
    lm = LoadModel(**OPEN)
    src = TorchDraws(9, "cpu")
    obs = sim.run_ensemble(lm, N, src, EnsembleSpec.of(2), block_size=BLOCK,
                           attribution=True, tail=True)
    cut = sim.estimate_tail_cut(lm, N, src, block_size=BLOCK)
    assert float(obs.attributions.tail_cut[0]) == pytest.approx(cut)
    _, attr = sim.run_attributed(lm, N, RootedSource(src, 1),
                                 block_size=BLOCK, tail=True, tail_cut=cut)
    _equal(obs.member_attribution(1), attr)
    assert obs.timelines is None


def test_protected_fleet_blame_equals_solo():
    from isotope_tpu_torch.compiler import compile_graph, compile_policies
    from isotope_tpu_torch.models.graph import ServiceGraph
    from test_torch_chaosfleet import STORM

    g = ServiceGraph.from_yaml(STORM)
    c = compile_graph(g)
    psim = Simulator(c, SimParams(timeline=True, attribution=True),
                     chaos=(ChaosEvent("worker", 0.1, 0.3, 3),),
                     policies=compile_policies(g, c), device="cpu")
    kw = dict(block_size=1_024, trim=True, window_s=0.25)
    src = TorchDraws(1, "cpu")
    lm = LoadModel(kind="open", qps=4_000.0)
    base = psim.run_policies_ensemble(lm, 2_048, src, EnsembleSpec.of(2),
                                      **kw)
    obs = psim.run_policies_ensemble(lm, 2_048, src, EnsembleSpec.of(2),
                                     attribution=True, **kw)
    assert base.attributions is None
    _equal(base.summaries, obs.summaries)
    _equal(base.policies, obs.policies)
    _, solo_tl, _, solo_attr = psim.run_policies(
        lm, 2_048, RootedSource(src, 1), attribution=True, **kw)
    _equal(obs.member_attribution(1), solo_attr)
    _equal(obs.member_timeline(1), solo_tl)


def test_observed_fleet_refusals():
    _, sim = _pair()
    plain = Simulator(sim.compiled, SimParams(), device="cpu")
    src = TorchDraws(0, "cpu")
    lm = LoadModel(**OPEN)
    with pytest.raises(ValueError, match="SimParams\\(attribution=True"):
        plain.run_ensemble(lm, N, src, EnsembleSpec.of(2),
                           attribution=True)
    with pytest.raises(ValueError, match="SimParams\\(timeline=True"):
        plain.run_ensemble(lm, N, src, EnsembleSpec.of(2), timeline=True)
    # the folded mode serves observed fleets: an explicit "vmap" runs
    # and its recorder series equal the member-by-member fleet's
    folded, mapped = (
        sim.run_ensemble(lm, N, src, EnsembleSpec.of(2, mode=mode),
                         block_size=BLOCK, timeline=True, window_s=WIN)
        for mode in ("vmap", "map")
    )
    _equal(folded.timelines, mapped.timelines)
    # the solo loop still reduces one of the two
    from isotope_tpu_torch.sim.engine import _BlockControl

    control = _BlockControl(sim, (4, 0.1), False, False)
    with pytest.raises(ValueError, match="either blame or the timeline"):
        sim._run_summary(lm, N, src, BLOCK, None, False, control,
                         attr=True)


# -- against the JAX package's observed fleet --------------------------------


@pytest.fixture(scope="module")
def obs4():
    js, sim = _pair()
    kw = dict(block_size=BLOCK, attribution=True, timeline=True,
              window_s=WIN)
    want = js.run_ensemble(JaxLoad(**OPEN), N, KEY,
                           JaxSpec.of(4, mode="map"), **kw)
    got = sim.run_ensemble(LoadModel(**OPEN), N, JaxReplayDraws(KEY, js),
                           EnsembleSpec.of(4), **kw)
    return js, sim, got, want


def test_observed_fleet_matches_reference_within_the_attribution_bands(
        obs4):
    _, _, got, want = obs4
    for k in range(4):
        lat_sum = float(np.asarray(want.summaries.latency_sum)[k])
        assert_attr_match(got.member_attribution(k),
                          want.member_attribution(k), lat_sum)
        assert_timeline_match(got.member_timeline(k),
                              want.member_timeline(k), f"member {k} ")
    np.testing.assert_array_equal(
        got.summaries.count.numpy(), np.asarray(want.summaries.count))


def _to_jax(stacked):
    return type(stacked)(*(
        None if x is None
        else _to_jax(x) if isinstance(x, tuple)
        else jnp.asarray(x.numpy()) for x in stacked
    ))


def _docs_equal(got, want, path="doc"):
    """Integers, names, rankings exactly; floats within FLOAT_RTOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _docs_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _docs_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-12,
                                   err_msg=path)
    else:
        assert got == want, path


def test_fleetblame_documents_equal_reference_on_the_same_stacks(obs4):
    """The port's explainer on the JAX fleet's own stacks (converted)
    gives the JAX explainer's document, worst members and report."""
    js, _, _, want = obs4
    attr = tree_map(lambda x: torch.from_numpy(np.asarray(x).copy()),
                    want.attributions)
    tl = tree_map(lambda x: torch.from_numpy(np.asarray(x).copy()),
                  want.timelines)
    kw = dict(label="obs", seeds=(0, 1, 2, 3), window_s=WIN)
    for control in (0, 2):
        doc = fleetblame.to_doc(js.compiled, attr, tl, control=control,
                                **kw)
        ref = jax_fb.to_doc(js.compiled, want.attributions, want.timelines,
                            control=control, **kw)
        _docs_equal(doc, ref)
        assert fleetblame.worst_members(doc, 2) == \
            jax_fb.worst_members(doc, 2)
        assert fleetblame.format_report(doc) == jax_fb.format_report(doc)
    sev = want.severity()
    _docs_equal(fleetblame.to_doc(js.compiled, attr, None, severity=sev),
                jax_fb.to_doc(js.compiled, want.attributions, None,
                              severity=sev))
    host = fleetblame.explain_fleet(attr, tl)
    assert isinstance(host["share"], np.ndarray)
    np.testing.assert_allclose(host["share"].sum(1), 1.0, atol=1e-5)
    assert host["onset_errors"].shape == host["onset_inflight"].shape


def test_fleetblame_on_the_ports_own_run_within_tolerance(obs4):
    js, sim, got, want = obs4
    doc = fleetblame.to_doc(sim.compiled, got.attributions, got.timelines)
    ref = jax_fb.to_doc(js.compiled, want.attributions, want.timelines)
    assert doc["ranking"] == ref["ranking"]
    for a, b in zip(doc["member_blame"], ref["member_blame"]):
        assert [h["hop"] for h in a["top_hops"]] == \
            [h["hop"] for h in b["top_hops"]]
        np.testing.assert_allclose(a["mean_latency_gap_s"],
                                   b["mean_latency_gap_s"], rtol=1e-4,
                                   atol=1e-9)


# -- the planted fleet --------------------------------------------------------


@pytest.fixture(scope="module")
def planted():
    """Member 2 loses 3 of 4 worker replicas from t = 0.3 s while the
    others lose 1: the divergence the explainer must localize."""
    js, sim = _pair(BLAME_YAML, chaos=[
        dict(service="worker", start_s=0.3, end_s=1.0, replicas_down=1)
    ])
    mild = sim._chaos_events
    events = [mild, mild, (ChaosEvent("worker", 0.3, 1.0, 3),), mild]
    spec = EnsembleSpec.of(4)
    obs = sim.run_ensemble(
        LoadModel(kind="open", qps=4000.0), 4_096,
        JaxReplayDraws(KEY, js), spec, block_size=1_024, attribution=True,
        timeline=True, window_s=0.1, member_chaos=events,
    )
    window_s = float(obs.timelines.window_s[0])
    doc = fleetblame.to_doc(sim.compiled, obs.attributions, obs.timelines,
                            label="planted", seeds=spec.seeds,
                            window_s=window_s)
    ref = jax_fb.to_doc(js.compiled, _to_jax(obs.attributions),
                        _to_jax(obs.timelines), label="planted",
                        seeds=spec.seeds, window_s=window_s)
    return obs, doc, ref


def test_explainer_names_planted_member_hop_and_onset(planted):
    _, doc, ref = planted
    assert doc["schema"] == "isotope-fleet-blame/v1"
    assert doc["ranking"][0] == 2
    m = [e for e in doc["member_blame"] if e["member"] == 2][0]
    assert m["gap_ranking"][0]["service"] == "worker"
    assert m["onset"] is not None and m["onset"]["service"] == "worker"
    # the onset window: the reference's own explainer on the same stacks
    r = [e for e in ref["member_blame"] if e["member"] == 2][0]
    assert m["onset"]["window"] == r["onset"]["window"]
    assert m["onset"]["time_s"] == pytest.approx(
        m["onset"]["window"] * 0.1)
    _docs_equal(doc, ref)


def test_explainer_report_and_worst_members(planted):
    _, doc, _ = planted
    worst = fleetblame.worst_members(doc, top=2)
    assert worst[0]["member"] == 2
    assert all(not m["control"] for m in worst)
    report = fleetblame.format_report(doc)
    assert "member 2" in report and "worker" in report
    assert "onset" in report
    hops = {b["hop"] for b in doc["hop_bands"]}
    for m in doc["member_blame"]:
        for r in m["top_hops"] + m["gap_ranking"]:
            assert r["hop"] in hops
