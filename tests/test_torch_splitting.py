"""Importance splitting of the port (``sim/splitting.py``,
``runner/run.splitting_pass``, ``simulate --ensemble-split``) against
the JAX package's.

The host layer (``SplitSpec``, ``parse_split_spec``, ``subset_estimate``,
``severity_scores``) is a copy: the same inputs give the same documents,
exactly.  ``severity_scores_device`` is held to the reference's as its
compiled rank step computes it (``jax.jit``), bit for bit.  The fleets
behind a splitting pass draw from ``RootedSource(source, SPLIT_INDEX)``,
the reference's ``fold_in(run_key, 777_000_001)``, so on
``JaxReplayDraws`` the splitting document is the reference's.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.metrics import histogram as jax_histogram
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.resilience.faults import ChaosJitterSpec as JaxJitter
from isotope_tpu.runner import load_toml as jax_load_toml
from isotope_tpu.runner.run import _splitting_pass as jax_splitting_pass
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import ensemble as jax_ens
from isotope_tpu.sim import splitting as jax_split
from isotope_tpu.sim.config import ChaosEvent as JaxChaos
from isotope_tpu_torch import cli
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.metrics import histogram
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
from isotope_tpu_torch.runner.config import load_toml
from isotope_tpu_torch.runner.run import splitting_pass
from isotope_tpu_torch.sim import LoadModel, Simulator
from isotope_tpu_torch.sim import ensemble as ens
from isotope_tpu_torch.sim import splitting as split
from isotope_tpu_torch.sim.config import ChaosEvent
from isotope_tpu_torch.sim.draws import SPLIT_INDEX
from test_torch_replay import JaxReplayDraws
from test_torch_summary import (
    CANONICAL,
    PROTECTED_TOPOLOGY,
    _simulate_both,
    assert_doc_close,
)

KEY = jax.random.PRNGKey(11)

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
"""


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _torch_tree(tree):
    """A JAX NamedTuple stack as the port's tensors."""
    return type(tree)(*(
        None if x is None else torch.from_numpy(np.asarray(x).copy())
        for x in tree
    ))


# -- specs ----------------------------------------------------------------


@pytest.mark.parametrize("text", [
    None, "", "off", "0", "false",
    "levels=4,members=64,keep=0.25,threshold=0.5,sev=err_peak",
    "levels=2, members=8, severity=p99, slo=0.25, horizon=0.5, seed=3",
    "chaos_prob=0.1,work_prob=0.9,sev=trips",
    "levels", "lvls=3", "levels=0", "members=1", "keep=1.0",
    "sev=latency", "horizon=0", "chaos_prob=2", "work_prob=-1",
])
def test_parse_split_spec_matches_reference(text):
    try:
        want = jax_split.parse_split_spec(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            split.parse_split_spec(text)
        assert str(got.value) == str(e)
        return
    got = split.parse_split_spec(text)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()
        assert got.budget == want.budget


def test_split_constants_match_reference():
    assert split.SPLIT_SCHEMA == jax_split.SPLIT_SCHEMA
    assert split.SEVERITIES == jax_split.SEVERITIES
    assert SPLIT_INDEX == 777_000_001
    # one copy of the severity statistics: the fleet summary ranks
    # through the splitting module
    assert not hasattr(ens, "severity_scores")


# -- the estimator --------------------------------------------------------


def _evaluator(kind):
    """A deterministic severity of (chaos seeds, work seeds), numpy
    only: a common event, a rare event, a constant population."""
    def evaluate(chaos, work):
        chaos = np.asarray(chaos, np.int64)
        work = np.asarray(work, np.int64)
        u = ((chaos.sum(axis=1) * 2_654_435_761 + work * 40_503)
             % 1_000_003) / 1_000_003.0
        if kind == "common":
            return u
        if kind == "rare":
            return u ** 6
        return np.full(len(work), 0.25)
    return evaluate


@pytest.mark.parametrize("kind,kw,components", [
    ("common", dict(threshold=0.5), 1),
    ("rare", dict(threshold=0.97, levels=4, members=16), 3),
    ("rare", dict(threshold=0.999, levels=3, members=8, keep=0.5,
                  chaos_prob=0.2, work_prob=0.7, seed=5), 2),
    ("constant", dict(threshold=0.5, levels=3, members=8), 1),
    ("constant", dict(threshold=0.1, levels=3, members=8), 1),
])
def test_subset_estimate_matches_reference(kind, kw, components):
    got = split.subset_estimate(_evaluator(kind), split.SplitSpec(**kw),
                                chaos_components=components)
    want = jax_split.subset_estimate(_evaluator(kind),
                                     jax_split.SplitSpec(**kw),
                                     chaos_components=components)
    assert got == want
    assert got["schema"] == "isotope-splitting/v1"


def test_subset_estimate_rejects_a_bad_shape_like_reference():
    def bad(chaos, work):
        return np.zeros(3)

    with pytest.raises(ValueError) as want:
        jax_split.subset_estimate(bad, jax_split.SplitSpec(members=4))
    with pytest.raises(ValueError) as got:
        split.subset_estimate(bad, split.SplitSpec(members=4))
    assert str(got.value) == str(want.value)


# -- the severity channels ----------------------------------------------------


@pytest.fixture(scope="module")
def pfleet():
    """A JAX protected fleet (recorder and policy series) of the storm
    topology, the stacks both packages' severities read."""
    jg = JaxGraph.from_yaml(STORM_YAML)
    jc = jax_compile_graph(jg)
    sim = JaxSimulator(jc, JaxParams(timeline=True),
                       policies=jax_compile_policies(jg, jc))
    return sim.run_policies_ensemble(
        JaxLoad(kind="open", qps=6_000.0), 2_048, KEY,
        jax_ens.EnsembleSpec.from_jitter(6, error_jitter=0.5,
                                         cpu_jitter=0.3),
        block_size=1_024, window_s=0.05,
    )


@pytest.mark.parametrize("sev", ["err_peak", "err_share", "p99", "trips"])
def test_severity_scores_match_reference(pfleet, sev):
    kw = dict(severity=sev, slo_s=0.001 if sev == "p99" else None)
    summ, tl, pol = (_torch_tree(x) for x in
                     (pfleet.summaries, pfleet.timelines, pfleet.policies))
    for with_obs in (True, False):
        want = jax_split.severity_scores(
            jax_split.SplitSpec(**kw), pfleet.summaries,
            pfleet.timelines if with_obs else None,
            pfleet.policies if with_obs else None)
        got = split.severity_scores(split.SplitSpec(**kw), summ,
                                    tl if with_obs else None,
                                    pol if with_obs else None)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sev", ["err_peak", "err_share", "p99", "trips"])
def test_severity_scores_device_match_reference(pfleet, sev):
    """The torch twin against the reference's as its rank step runs it
    (compiled)."""
    slo = 0.0007 if sev == "p99" else None
    summ, pol = _torch_tree(pfleet.summaries), _torch_tree(pfleet.policies)
    for with_pol in (True, False):
        want = jax.jit(
            lambda s, p: jax_split.severity_scores_device(sev, s, slo, p)
        )(pfleet.summaries, pfleet.policies if with_pol else None)
        got = split.severity_scores_device(sev, summ, slo,
                                           pol if with_pol else None)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError) as w:
        jax_split.severity_scores_device("p99", pfleet.summaries)
    with pytest.raises(ValueError) as g:
        split.severity_scores_device("p99", summ)
    assert str(g.value) == str(w.value)


def test_quantile_from_histogram_device_matches_reference():
    rng = np.random.default_rng(3)
    hists = rng.integers(0, 50, (7, histogram.NUM_BUCKETS)).astype(
        np.float32)
    hists[2] = 0.0                       # empty: 0
    hists[3, :] = 0.0
    hists[3, 17] = 5.0                   # one bucket
    hists[4] *= rng.random(histogram.NUM_BUCKETS) < 0.01   # sparse
    for q in (0.5, 0.9, 0.99, 0.999, 1.0):
        want = jax.jit(
            lambda h: jax_histogram.quantile_from_histogram_device(h, q)
        )(hists)
        got = histogram.quantile_from_histogram_device(
            torch.from_numpy(hists), q)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fleet_severity_ranks_through_the_splitting_module(pfleet):
    got = ens.EnsembleSummary(
        spec=ens.EnsembleSpec.of(6), summaries=_torch_tree(pfleet.summaries),
        offered_qps=np.asarray(pfleet.offered_qps), chunk=6,
        timelines=_torch_tree(pfleet.timelines),
    )
    for sev in ("err_peak", "err_share"):
        np.testing.assert_array_equal(got.severity(sev),
                                      pfleet.severity(sev))
    assert got.worst_member() == pfleet.worst_member()
    with pytest.raises(ValueError) as w:
        pfleet.severity("latency")
    with pytest.raises(ValueError) as g:
        got.severity("latency")
    assert str(g.value) == str(w.value)


# -- the TOML keys and the splitting pass -------------------------------------


def test_toml_ensemble_split_decodes_like_reference(tmp_path):
    cfg = tmp_path / "exp.toml"
    cfg.write_text(
        '[sim]\nensemble = 8\n'
        'ensemble_split = "levels=3,members=16,threshold=0.2,sev=trips"\n'
        'ensemble_split_horizon = 0.5\n'
    )
    got, want = load_toml(cfg), jax_load_toml(cfg)
    assert got.ensemble_split == want.ensemble_split
    assert got.ensemble_split_horizon == want.ensemble_split_horizon == 0.5
    assert got.split_spec().to_dict() == want.split_spec().to_dict()
    assert got.split_spec().horizon == 0.5
    for bad in ('ensemble_split = "lvls=3"', "ensemble_split_horizon = 2"):
        cfg.write_text("[sim]\n" + bad + "\n")
        with pytest.raises(ValueError) as w:
            jax_load_toml(cfg)
        with pytest.raises(ValueError) as g:
            load_toml(cfg)
        assert str(g.value) == str(w.value), bad


CHAOS_YAML = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: worker, timeout: 2ms, retries: 1}
- name: worker
  numReplicas: 2
  errorRate: 1%
"""


def test_splitting_pass_with_chaos_jitter_matches_reference():
    """A chaos case's splitting pass: every member's kill jittered from
    its chaos seeds, the fleets on the splitting lane; the document is
    the reference's ``_splitting_pass``'s."""
    jc = jax_compile_graph(JaxGraph.from_yaml(CHAOS_YAML))
    jchaos = (JaxChaos("worker", 0.02, 0.08, 1),)
    jsim = JaxSimulator(jc, chaos=jchaos)
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(CHAOS_YAML)),
                    chaos=(ChaosEvent("worker", 0.02, 0.08, 1),),
                    device="cpu")
    spec_kw = dict(levels=3, members=4, keep=0.5, threshold=0.05,
                   severity="err_share", horizon=0.5, seed=2)
    jitter_kw = dict(time=0.4, magnitude=0.5, seed=1)
    n, block = 1_024, 256
    want = jax_splitting_pass(
        jsim, None, False, SimpleNamespace(compiled=jc),
        JaxLoad(kind="open", qps=8_000.0), n, KEY, block,
        SimpleNamespace(chaos=jchaos, timeline_window_s=10.0), None,
        False, None, jax_split.SplitSpec(**spec_kw), JaxJitter(**jitter_kw),
    )
    got = splitting_pass(
        sim, LoadModel(kind="open", qps=8_000.0), n,
        JaxReplayDraws(KEY), block, split.SplitSpec(**spec_kw),
        chaos_jitter=ChaosJitterSpec(**jitter_kw),
    )
    assert want is not None and got == want


# -- simulate --ensemble-split ------------------------------------------------


def test_cli_ensemble_split_matches_reference(tmp_path, monkeypatch):
    """``--ensemble 4 --ensemble-split ... --split-horizon`` on
    canonical: the fleet document with its ``splitting`` block against
    the JAX command's on the same draws."""
    got = _simulate_both(tmp_path, monkeypatch, CANONICAL, [
        "--qps", "1000", "--duration", "1s", "--load-kind", "open",
        "--ensemble", "4", "--ensemble-jitter", "error=0.5,seed=2",
        "--ensemble-split",
        "levels=2,members=4,keep=0.5,threshold=0.02,sev=err_share,seed=1",
        "--split-horizon", "0.5", "--ensemble-out", "FILE:ens.json",
    ])
    doc, want = got["ens.json"]
    assert doc["splitting"]["schema"] == "isotope-splitting/v1"
    assert doc["splitting"]["spec"]["horizon"] == 0.5
    assert doc["splitting"] == want["splitting"]
    assert_doc_close(doc, want, path="ens.json")
    assert_doc_close(*got["stdout"])


def test_cli_protected_ensemble_split_matches_reference(tmp_path,
                                                        monkeypatch):
    """A protected fleet's splitting pass (``run_policies_ensemble`` /
    ``run_rollouts_ensemble`` on the case's window and block, severity
    from the recorder's peak window)."""
    topo = tmp_path / "prot.yaml"
    topo.write_text(PROTECTED_TOPOLOGY)
    got = _simulate_both(tmp_path, monkeypatch, topo, [
        "--qps", "2000", "--duration", "2s", "--load-kind", "open",
        "--policies", "--ensemble", "2",
        "--ensemble-split", "levels=2,members=4,keep=0.5,threshold=0.5",
        "--ensemble-out", "FILE:ens.json",
    ])
    doc, want = got["ens.json"]
    assert doc["splitting"] == want["splitting"]
    assert doc["splitting"]["evaluations"] >= 4
    assert_doc_close(doc, want, path="ens.json")


def test_cli_split_flags_fail_fast_like_reference():
    with pytest.raises(ValueError, match="unknown splitting spec key"):
        cli.main(["simulate", str(CANONICAL), "--device", "cpu",
                  "--ensemble-split", "lvls=2"])
    with pytest.raises(SystemExit, match="split-horizon must lie"):
        cli.main(["simulate", str(CANONICAL), "--device", "cpu",
                  "--split-horizon", "1.5"])
    # a split without a fleet parses and has nothing to split
    args = cli.build_parser().parse_args(
        ["simulate", str(CANONICAL), "--ensemble-split", "levels=2",
         "--split-horizon", "0.5"])
    assert cli._fleet_args(args) is None
    args = cli.build_parser().parse_args(
        ["simulate", str(CANONICAL), "--ensemble", "2", "--ensemble-split",
         "levels=2", "--split-horizon", "0.5"])
    spec, _, sp = cli._fleet_args(args)
    assert sp == dataclasses.replace(split.SplitSpec(levels=2), horizon=0.5)
