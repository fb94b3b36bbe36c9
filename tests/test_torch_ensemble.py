"""Monte Carlo fleets of the port (``sim/ensemble.py``,
``Simulator.run_ensemble``) against the JAX package's, on its draws.

The port's members draw from ``RootedSource(source, seed)``; with
``JaxReplayDraws`` that is the reference's ``fold_in(key, seed)``, whose
blocks fold ``1_000_000 + b``.  Tolerances: integers and booleans
(counts, histograms, hop events) exactly; float sums at the engine's
standing rtol 1e-5 / atol 1e-9 s; the saturated ``-qps max`` law at its
rtol 1e-4 plus atol 1e-5 s (``tests/test_torch_closed.py``).  A
``"map"`` member is bit-equal to the port's own solo run on the same
source; a ``"vmap"`` (folded) fleet equals the ``"map"`` one in its
integers and within rtol 1e-5 / atol 1e-9 s in its float sums (they are
summed per member over an (M, N) view).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.analysis import costmodel as jax_costmodel
from isotope_tpu.compiler import compile_ensemble as jax_compile_ensemble
from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import ensemble as jax_ens
from isotope_tpu_torch.analysis import costmodel
from isotope_tpu_torch.compiler import compile_ensemble
from isotope_tpu_torch.metrics.histogram import EDGES
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim import ensemble as ens
from isotope_tpu_torch.sim.draws import RootedSource
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
  errorRate: 2%
- name: y
  script:
  - call: z
- name: z
"""

KEY = jax.random.PRNGKey(7)
N, BLOCK = 512, 256  # two blocks: the clocks carry across
RTOL, ATOL = 1e-5, 1e-9
SAT_RTOL, SAT_ATOL = 1e-4, 1e-5
EXACT = ("count", "error_count", "hop_events", "latency_hist",
         "win_count", "win_error_count", "win_latency_hist", "unstable")
CLOSE = ("latency_sum", "latency_m2", "latency_min", "latency_max",
         "end_max", "utilization")

LOADS = {
    "open": dict(kind="open", qps=2000.0),
    "paced": dict(kind="closed", qps=1500.0, connections=8),
    "saturated": dict(kind="closed", qps=None, connections=8),
}
JITTER = dict(qps_jitter=0.1, cpu_jitter=0.2, error_jitter=0.5,
              jitter_seed=3)


@pytest.fixture(scope="module")
def pair():
    return scenario_pair(jax_compile_graph(JaxGraph.from_yaml(YAML)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_stacks(got, want, rtol=RTOL, atol=ATOL, exact=EXACT,
                  close=CLOSE):
    """Member-stacked summaries: integers exactly, floats in band."""
    for f in exact:
        np.testing.assert_array_equal(
            _np(getattr(got, f)), _np(getattr(want, f)), err_msg=f
        )
    for f in close:
        np.testing.assert_allclose(
            _np(getattr(got, f)), _np(getattr(want, f)), rtol=rtol,
            atol=atol, err_msg=f,
        )


def _specs(members, jitter, mode):
    kw = dict(JITTER) if jitter else {}
    return (
        jax_ens.EnsembleSpec.from_jitter(members, mode="map", **kw),
        ens.EnsembleSpec.from_jitter(members, mode=mode, **kw),
    )


# -- host code: the specs, the closed forms, the tables -------------------


@pytest.mark.parametrize("kw", [
    dict(seeds=(0, 1), cpu_scale=np.ones(3)),
    dict(seeds=(0,), qps_scale=np.array([-1.0])),
    dict(seeds=(0,), error_scale=np.array([np.inf])),
    dict(seeds=(0,), mode="tensor"),
    dict(seeds=(0,), chunk=0),
])
def test_spec_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jax_ens.EnsembleSpec(**kw)
    with pytest.raises(ValueError) as got:
        ens.EnsembleSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seeds", [(1, 1, 2), ()])
def test_spec_check_messages_match_reference(seeds):
    with pytest.raises(ValueError) as want:
        jax_ens.EnsembleSpec(seeds=seeds).check()
    with pytest.raises(ValueError) as got:
        ens.EnsembleSpec(seeds=seeds).check()
    assert str(got.value) == str(want.value)
    ens.EnsembleSpec(seeds=(1, 1)).check(allow_duplicate_seeds=True)


@pytest.mark.parametrize("kw", [
    dict(), dict(qps_jitter=0.1), dict(cpu_jitter=0.05, jitter_seed=9),
    dict(qps_jitter=0.1, cpu_jitter=0.05, error_jitter=0.2,
         jitter_seed=4),
])
def test_from_jitter_tables_bit_equal(kw):
    want = jax_ens.EnsembleSpec.from_jitter(6, **kw)
    got = ens.EnsembleSpec.from_jitter(6, **kw)
    assert got.to_dict() == want.to_dict()
    for f in ("qps_scale", "cpu_scale", "error_scale"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.jittered == want.jittered


@pytest.mark.parametrize("text", [
    None, "", "qps=0.1, cpu=0.05,error=0.2,seed=9", "err=0.3",
    "latency=3", "qps",
])
def test_parse_jitter_spec_matches_reference(text):
    try:
        want = jax_ens.parse_jitter_spec(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ens.parse_jitter_spec(text)
        assert str(got.value) == str(e)
        return
    assert ens.parse_jitter_spec(text) == want


@pytest.mark.parametrize("k,n", [(0, 20), (3, 10), (20, 20), (0, 0),
                                 (7, 64)])
def test_wilson_interval_matches_reference(k, n):
    for conf in (0.9, 0.95, 0.99):
        assert ens.wilson_interval(k, n, conf) == \
            jax_ens.wilson_interval(k, n, conf)


def test_norm_ppf_matches_reference():
    for q in (1e-6, 0.001, 0.02, 0.025, 0.2, 0.5, 0.7, 0.975, 0.9999):
        assert ens.norm_ppf(q) == jax_ens.norm_ppf(q)
    with pytest.raises(ValueError, match="q must lie"):
        ens.norm_ppf(1.0)


@pytest.mark.parametrize("jitter", [False, True])
def test_compile_ensemble_tables_equal(jitter):
    want_spec, got_spec = _specs(4, jitter, "map")
    want = jax_compile_ensemble(want_spec)
    got = compile_ensemble(got_spec)
    assert (got.members, got.seeds, got.jittered, got.mode) == (
        want.members, want.seeds, want.jittered, want.mode
    )
    np.testing.assert_array_equal(got.qps_scale, want.qps_scale)
    np.testing.assert_array_equal(got.cpu_scale.numpy(),
                                  np.asarray(want.cpu_scale))
    np.testing.assert_array_equal(got.err_scale.numpy(),
                                  np.asarray(want.err_scale))
    # the automatic mode resolves per device
    auto = ens.EnsembleSpec.of(2)
    assert compile_ensemble(auto, "cpu").mode == "map"
    assert compile_ensemble(auto, "cuda").mode == "vmap"


@pytest.mark.parametrize("members,peak,cap", [
    (33, 1.0, 20.0), (33, 1.0, 15.0 / 0.85 + 1e-9), (8, 1.0, 1e9),
    (8, 1.0, None), (32, 655e6, 80e9), (32, 655e6, 8e9),
])
def test_auto_chunk_matches_reference(members, peak, cap):
    assert costmodel.ensemble_chunk(members, peak, cap) == \
        jax_costmodel.ensemble_chunk(members, peak, cap)


def test_auto_chunk_of_the_simulator_matches_reference(pair, monkeypatch):
    """``ensemble_chunk_size`` at the same capacity override: the
    plan-only peak (ten float32 (block, H) tensors) and the observed
    fleets' carries are the reference's."""
    jax_sim, sim = pair
    monkeypatch.setenv(costmodel.ENV_DEVICE_BYTES, "2000000")
    for attr, windows in ((False, None), (True, None), (True, 12)):
        assert sim.ensemble_chunk_size(64, 256, attr, windows) == \
            jax_sim.ensemble_chunk_size(64, 256, attr, windows)
    assert costmodel.device_capacity_bytes(device="cpu") == 2e6
    monkeypatch.delenv(costmodel.ENV_DEVICE_BYTES)
    assert costmodel.device_capacity_bytes(device="cpu") is None
    assert sim.ensemble_chunk_size(64, 256) == 64


# -- the engine: members against solo runs and the JAX package ------------


@pytest.mark.parametrize("load", sorted(LOADS))
def test_map_member_bit_equals_solo(pair, load):
    _, sim = pair
    src = TorchDraws(5, "cpu")
    lm = LoadModel(**LOADS[load])
    fleet = sim.run_ensemble(lm, N, src, ens.EnsembleSpec(
        seeds=(0, 3, 8), mode="map"), block_size=BLOCK, trim=True)
    for k, seed in enumerate((0, 3, 8)):
        solo = sim.run_summary(lm, N, RootedSource(src, seed),
                               block_size=BLOCK, trim=True)
        member = fleet.member(k)
        assert isinstance(member, RunSummary)
        for f in solo._fields:
            if f != "metrics":
                assert torch.equal(getattr(member, f),
                                   getattr(solo, f)), (k, f)


@pytest.mark.parametrize("load,jitter", [
    ("open", False), ("open", True), ("paced", False), ("paced", True),
    ("saturated", False),
])
def test_fleet_matches_reference(load, jitter):
    # a fresh pair: the saturated tables are cached per connection
    # count, built from the first source's pilots
    jax_sim, sim = scenario_pair(jax_compile_graph(JaxGraph.from_yaml(YAML)))
    jspec, pspec = _specs(3, jitter, "map")
    want = jax_sim.run_ensemble(JaxLoad(**LOADS[load]), N, KEY, jspec,
                                block_size=BLOCK, trim=True)
    got = sim.run_ensemble(LoadModel(**LOADS[load]), N,
                           JaxReplayDraws(KEY, jax_sim), pspec,
                           block_size=BLOCK, trim=True)
    if load != "saturated":
        assert_stacks(got.summaries, want.summaries)
    else:
        # the saturated law's tolerance moves a latency across a
        # bucket edge now and then: counts exactly, each member's
        # quantiles within one histogram bucket (test_torch_closed.py)
        assert_stacks(got.summaries, want.summaries, SAT_RTOL, SAT_ATOL,
                      exact=("count", "error_count", "hop_events",
                             "unstable"),
                      close=("latency_sum", "latency_min", "latency_max",
                             "end_max"))
        ratio = got.member_quantiles(window=False) / \
            want.member_quantiles(window=False)
        bucket = EDGES[3] / EDGES[2]
        assert np.all(ratio <= bucket * (1 + 1e-6))
        assert np.all(ratio >= 1 / bucket / (1 + 1e-6))
    # the saturated rate is the MVA tables' throughput, float32 tables
    np.testing.assert_allclose(
        got.offered_qps, want.offered_qps,
        rtol=SAT_RTOL if load == "saturated" else 1e-12,
    )
    assert got.chunk == want.chunk == 3


@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_chunked_equals_unchunked(pair, mode):
    _, sim = pair
    src = TorchDraws(1, "cpu")
    spec = ens.EnsembleSpec.from_jitter(5, mode=mode, **JITTER)
    whole = sim.run_ensemble(LoadModel(**LOADS["open"]), N, src, spec,
                             block_size=BLOCK)
    for chunk in (2, 3):
        part = sim.run_ensemble(LoadModel(**LOADS["open"]), N, src, spec,
                                block_size=BLOCK, chunk=chunk)
        assert part.chunk == chunk
        for f in whole.summaries._fields:
            a, b = getattr(whole.summaries, f), getattr(part.summaries, f)
            assert (a is None and b is None) or torch.equal(a, b), f


def _vmap_pairs():
    chaos = [dict(service="x", start_s=0.05, end_s=0.15,
                  replicas_down=None),
             dict(service="z", start_s=0.1, end_s=0.2, replicas_down=1,
                  drain=False)]
    churn = [dict(service="y", period_s=0.05, weights=(1.0, 0.3, 0.0))]
    mtls = dict(period_s=0.1, taxes_s=(0.0, 2e-4))
    return {
        "plain": {}, "chaos": dict(chaos=chaos), "churn": dict(churn=churn),
        "mtls": dict(mtls=mtls),
    }


@pytest.mark.parametrize("scenario", sorted(_vmap_pairs()))
@pytest.mark.parametrize("load,jitter", [
    ("open", True), ("paced", True), ("saturated", False),
])
def test_vmap_matches_map(scenario, load, jitter):
    """The folded block against the members run one by one, on the CPU,
    under the Simulator's own chaos (an outage and an ungraceful kill),
    traffic split or mTLS schedule."""
    jc = jax_compile_graph(JaxGraph.from_yaml(YAML))
    _, sim = scenario_pair(jc, **_vmap_pairs()[scenario])
    src = TorchDraws(2, "cpu")
    kw = dict(JITTER) if jitter else {}
    lm = LoadModel(**LOADS[load])
    maps = sim.run_ensemble(lm, N, src, ens.EnsembleSpec.from_jitter(
        3, mode="map", **kw), block_size=BLOCK, trim=True)
    folded = sim.run_ensemble(lm, N, src, ens.EnsembleSpec.from_jitter(
        3, mode="vmap", **kw), block_size=BLOCK, trim=True)
    assert_stacks(folded.summaries, maps.summaries)


def test_folded_lb_fleet_matches_map():
    """lb laws with panic routing under chaos, folded."""
    from isotope_tpu_torch.compiler import compile_graph, compile_lb
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim.config import ChaosEvent

    g = ServiceGraph.from_yaml(YAML + """
policies:
  x:
    lb: {policy: least_request, choices_d: 2, panic_threshold: 60%}
""")
    c = compile_graph(g)
    sim = Simulator(c, chaos=(ChaosEvent("x", 0.05, 0.2, 1),),
                    lb=compile_lb(g, c), device="cpu")
    lm = LoadModel(**LOADS["open"])
    src = TorchDraws(4, "cpu")
    runs = [
        sim.run_ensemble(lm, N, src, ens.EnsembleSpec.from_jitter(
            3, mode=mode, **JITTER), block_size=BLOCK)
        for mode in ("map", "vmap")
    ]
    assert_stacks(runs[1].summaries, runs[0].summaries)


def test_sim_params_ensemble_runs_the_default_fleet(pair):
    """``SimParams(ensemble=N)`` builds a Simulator whose
    ``run_ensemble`` runs a seeds-only fleet of N members."""
    jax_sim, _ = pair
    from test_torch_replay import port_compiled

    sim = Simulator(port_compiled(jax_sim.compiled),
                    SimParams(ensemble=2), device="cpu")
    fleet = sim.run_ensemble(LoadModel(**LOADS["open"]), N,
                             TorchDraws(0, "cpu"), block_size=BLOCK)
    assert fleet.spec.seeds == (0, 1) and fleet.members == 2
    assert _np(fleet.summaries.count).tolist() == [N, N]


def test_run_rejects_bad_specs(pair):
    """The reference's rejections, word for word."""
    jax_sim, sim = pair
    src = TorchDraws(0, "cpu")
    sat = LoadModel(**LOADS["saturated"])
    cases = [
        (LoadModel(**LOADS["open"]), ens.EnsembleSpec(seeds=(1, 1)),
         jax_ens.EnsembleSpec(seeds=(1, 1)), {}),
        (LoadModel(**LOADS["open"]), None, None, {}),
        (sat, ens.EnsembleSpec(seeds=(0, 1), cpu_scale=np.array([1., 2.])),
         jax_ens.EnsembleSpec(seeds=(0, 1), cpu_scale=np.array([1., 2.])),
         {}),
        (LoadModel(**LOADS["open"]), ens.EnsembleSpec.of(2),
         jax_ens.EnsembleSpec.of(2), dict(member_qps=[1.0])),
        (LoadModel(**LOADS["open"]), ens.EnsembleSpec.of(2),
         jax_ens.EnsembleSpec.of(2), dict(member_chaos=[()])),
    ]
    for load, pspec, jspec, kw in cases:
        jload = JaxLoad(kind=load.kind, qps=load.qps,
                        connections=load.connections)
        with pytest.raises(ValueError) as want:
            jax_sim.run_ensemble(jload, 64, KEY, jspec, block_size=64, **kw)
        with pytest.raises(ValueError) as got:
            sim.run_ensemble(load, 64, src, pspec, block_size=64, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="member_keys has 1 entries"):
        sim.run_ensemble(LoadModel(**LOADS["open"]), 64, src,
                         ens.EnsembleSpec.of(2), member_keys=[src])


@pytest.mark.parametrize("kw", [dict(return_carry=True),
                                dict(block_offset=2),
                                dict(carry_in="zero")])
def test_carry_export_raises_naming_its_item(pair, kw):
    """The carry export (the search brackets, ported with them:
    ``tests/test_torch_search.py``) runs; with ``trim`` it raises the
    reference's ``ValueError``, naming what it requires."""
    jax_sim, sim = pair
    pkw, jkw = dict(kw), dict(kw)
    if kw.get("carry_in") == "zero":
        pkw["carry_in"] = sim.zero_ensemble_carry(2, 0)
        jkw["carry_in"] = jax_sim.zero_ensemble_carry(2, 0)
    out = sim.run_ensemble(LoadModel(**LOADS["open"]), 64,
                           TorchDraws(0, "cpu"), ens.EnsembleSpec.of(2),
                           **pkw)
    fleet = out[0] if kw.get("return_carry") else out
    assert _np(fleet.summaries.count).tolist() == [64.0, 64.0]
    with pytest.raises(ValueError) as want:
        jax_sim.run_ensemble(JaxLoad(**LOADS["open"]), 64, KEY,
                             jax_ens.EnsembleSpec.of(2), trim=True, **jkw)
    with pytest.raises(ValueError) as got:
        sim.run_ensemble(LoadModel(**LOADS["open"]), 64,
                         TorchDraws(0, "cpu"), ens.EnsembleSpec.of(2),
                         trim=True, **pkw)
    assert str(got.value) == str(want.value)
    assert "requires trim=False" in str(got.value)


# -- the documents ----------------------------------------------------------


def _converted(stack):
    """A JAX member stack as the port's tensors."""
    return RunSummary(*(
        None if x is None else torch.from_numpy(np.asarray(x).copy())
        for x in stack
    ))


def test_to_doc_equals_reference_on_the_same_stacks(pair):
    jax_sim, _ = pair
    jspec, pspec = _specs(4, True, "map")
    want_ens = jax_sim.run_ensemble(JaxLoad(**LOADS["open"]), N, KEY,
                                    jspec, block_size=BLOCK, trim=True)
    got_ens = ens.EnsembleSummary(
        spec=pspec, summaries=_converted(want_ens.summaries),
        offered_qps=np.asarray(want_ens.offered_qps), chunk=want_ens.chunk,
    )
    slo = float(np.median(want_ens.member_quantiles((0.99,))[:, 0]))
    for kw in (dict(), dict(slo_s=slo), dict(slo_s=10.0, splitting={
            "p": 3e-5, "ci_lo": 1e-5, "ci_hi": 9e-5})):
        assert got_ens.to_doc("case", **kw) == \
            want_ens.to_doc("case", **kw)
    np.testing.assert_array_equal(got_ens.severity("err_share"),
                                  want_ens.severity("err_share"))
    assert got_ens.worst_member() == want_ens.worst_member()
    pooled, want_pooled = got_ens.pooled(), want_ens.pooled()
    for f in ("count", "error_count", "latency_hist", "latency_sum"):
        np.testing.assert_array_equal(_np(getattr(pooled, f)),
                                      np.asarray(getattr(want_pooled, f)))
    doc = got_ens.to_doc("case")
    np.testing.assert_array_equal(ens.doc_member_quantiles(doc),
                                  jax_ens.doc_member_quantiles(doc))
    with pytest.raises(ValueError, match="isotope-ensemble"):
        ens.doc_member_quantiles({"schema": "nope"})


def test_to_doc_within_tolerance_on_each_engines_run(pair):
    jax_sim, sim = pair
    jspec, pspec = _specs(3, True, "map")
    want = jax_sim.run_ensemble(JaxLoad(**LOADS["paced"]), N, KEY, jspec,
                                block_size=BLOCK, trim=True)
    got = sim.run_ensemble(LoadModel(**LOADS["paced"]), N,
                           JaxReplayDraws(KEY, jax_sim), pspec,
                           block_size=BLOCK, trim=True)
    a, b = got.to_doc("c", slo_s=0.002), want.to_doc("c", slo_s=0.002)
    assert a.keys() == b.keys()
    for k in ("schema", "label", "members", "chunk", "spec", "quantiles",
              "member_counts", "member_error_counts", "member_hop_events",
              "slo"):
        assert a[k] == b[k], k
    np.testing.assert_allclose(a["member_quantiles_s"],
                               b["member_quantiles_s"], rtol=RTOL)
    np.testing.assert_allclose(a["offered_qps"], b["offered_qps"],
                               rtol=1e-12)
