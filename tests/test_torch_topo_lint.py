"""The port's static analysis (``analysis/findings.py``,
``analysis/topo_lint.py``) and the reference's scan-bucket planner
(``compiler/buckets.py``'s ``plan_segments`` / ``plan_stats``, which
VET-T008 reads) against the JAX package's.

Every lint entry point runs on the same inputs in both packages: each
``examples/topologies/*.yaml`` (``lint_graph`` and ``lint_compiled``
over each package's own ``compile_graph``), the policy, lb and rollout
blocks of the reference's vet tests (``tests/test_lb.py``,
``test_policies.py``, ``test_rollout.py``), sweep configs
(``lint_config`` with the port's ``ExperimentConfig``, whose labels come
from ``runner.run.run_label``), search, splitting and ensemble specs
(``tests/test_search.py``, ``test_chaosfleet.py``) and ingest reports.
Findings are compared as (rule, severity, message, path), exactly; the
bucket plans' segments and statistics exactly.
"""
import pathlib

import pytest

from isotope_tpu.analysis import findings as jax_findings
from isotope_tpu.analysis import topo_lint as jax_lint
from isotope_tpu.compiler import buckets as jax_buckets
from isotope_tpu.compiler import compile_graph as jax_compile
from isotope_tpu.ingest import FitOptions as JaxFitOptions
from isotope_tpu.ingest import fit as jax_fit
from isotope_tpu.ingest import read_path as jax_read_path
from isotope_tpu.ingest import report as jax_report
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.runner import config as jax_config
from isotope_tpu.sim import config as jax_sim_config
from isotope_tpu.sim.ensemble import EnsembleSpec as JaxEnsembleSpec
from isotope_tpu.sim.search import SearchSpec as JaxSearchSpec
from isotope_tpu_torch.analysis import findings
from isotope_tpu_torch.analysis import topo_lint
from isotope_tpu_torch.compiler import buckets
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.ingest import FitOptions, fit, read_path
from isotope_tpu_torch.ingest import report
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.runner import config as port_config
from isotope_tpu_torch.sim import config as port_sim_config
from isotope_tpu_torch.sim.ensemble import EnsembleSpec
from isotope_tpu_torch.sim.search import SearchSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPOLOGIES = sorted((ROOT / "examples" / "topologies").glob("*.yaml"))
DATA = ROOT / "tests" / "data" / "ingest"
MU = 13_000.0

# tests/test_lb.py's chain and tests/test_policies.py's (retried) chain
LB_CHAIN = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 8
  script:
  - call: worker
- name: worker
  numReplicas: 4
"""
RETRY_CHAIN = """
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
GRAPHS = {
    # lb (tests/test_lb.py::test_vet_lb_rules)
    "lb-d9": LB_CHAIN + "policies:\n  worker:\n"
             "    lb: {policy: least_request, choices_d: 9}\n",
    "lb-ring-1-replica": LB_CHAIN.replace("numReplicas: 4", "numReplicas: 1")
                         + "policies:\n  worker:\n    lb: ring_hash\n",
    "lb-panic-100": LB_CHAIN + "policies:\n  worker:\n"
                    "    lb: {policy: fifo, panic_threshold: 100%}\n",
    "lb-panic-ejection": LB_CHAIN + "policies:\n  worker:\n"
                        "    lb: {policy: fifo, panic_threshold: 20%}\n"
                        "    breaker: {consecutive_errors: 5, "
                        "max_ejection_fraction: 50%}\n",
    "lb-bogus": LB_CHAIN + "policies:\n  worker:\n    lb: {policy: bogus}\n",
    "lb-clean": LB_CHAIN + "policies:\n  worker:\n"
                "    lb: {policy: least_request, choices_d: 2}\n",
    # policies (tests/test_policies.py::test_vet_policy_rules)
    "policies-bad": RETRY_CHAIN + """
policies:
  worker:
    retry_budget: {budget_percent: 0, min_retries_concurrent: 0}
    autoscaler: {min_replicas: 6, max_replicas: 2, sync_period: 1s}
""",
    "policies-undecodable": RETRY_CHAIN
                            + "policies:\n  worker:\n"
                              "    breker: {max_pending: 1}\n",
    "policies-clean": RETRY_CHAIN + POLICIES,
    # rollouts (tests/test_rollout.py::test_vet_rollout_*)
    "rollout-steps": RETRY_CHAIN + """
rollouts:
  worker:
    steps: [25%, 10%, 80%]
    bake: 2s
""",
    "rollout-no-steps": RETRY_CHAIN + """
rollouts:
  worker:
    canary: {error_rate: 10%}
""",
    "rollout-clean": RETRY_CHAIN + """
rollouts:
  worker:
    steps: [5%, 50%, 100%]
    bake: 30s
    gates: {min_samples: 10}
""",
    # structure: an undefined entry, a cycle, an idle service
    "cycle": """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{call: a}]
- name: idle
""",
}


def as_rows(found):
    return [(f.rule, f.severity, f.message, f.path) for f in found]


def graph_pair(text):
    return ServiceGraph.from_yaml(text), JaxGraph.from_yaml(text)


def params_pair(**kw):
    return (port_sim_config.SimParams(**kw), jax_sim_config.SimParams(**kw))


def test_rule_catalog_equals_reference():
    assert findings.RULES == jax_findings.RULES
    assert [n for n in dir(findings) if not n.startswith("_")] == [
        n for n in dir(jax_findings) if not n.startswith("_")]


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=lambda p: p.stem)
def test_lint_graph_and_compiled_on_examples(topo):
    g, jg = ServiceGraph.from_yaml_file(topo), JaxGraph.from_yaml_file(topo)
    entry = None if g.entrypoints() else g.services[0].name
    for kw in ({}, dict(timeline_window_s=10.0)):
        p, jp = params_pair(**kw)
        assert as_rows(topo_lint.lint_graph(g, entry=entry, params=p)) == (
            as_rows(jax_lint.lint_graph(jg, entry=entry, params=jp)))
    c, jc = compile_graph(g, entry=entry), jax_compile(jg, entry=entry)
    for kw in ({}, dict(level_bucket_waste=1.05),
               dict(bucket_schedule="greedy"), dict(sparse_tiling=False)):
        p, jp = params_pair(**kw)
        assert as_rows(topo_lint.lint_compiled(c, p)) == as_rows(
            jax_lint.lint_compiled(jc, jp))


@pytest.mark.parametrize("waste", [1.05, 1.6])
def test_vet_t008_names_the_reference_executor(monkeypatch, waste):
    """VET-T008 fires on no example (the planner keeps each bucket in
    its budget), so both packages' ``plan_stats`` report a 90% padded
    plan here: the port's finding is the reference's, its message
    followed by ``T008_NOTE`` (the padding is the reference executor's,
    not work the port does)."""
    def padded(mod):
        real = mod.plan_stats

        def stats(shapes, segs):
            return dict(real(shapes, segs), padded_elems=10,
                        padding_waste_fraction=0.9)
        monkeypatch.setattr(mod, "plan_stats", stats)

    padded(buckets)
    padded(jax_buckets)
    topo = ROOT / "examples" / "topologies" / "canonical.yaml"
    g, jg = ServiceGraph.from_yaml_file(topo), JaxGraph.from_yaml_file(topo)
    p, jp = params_pair(level_bucket_waste=waste)
    got = as_rows(topo_lint.lint_compiled(compile_graph(g), p))
    want = as_rows(jax_lint.lint_compiled(jax_compile(jg), jp))
    (t008,) = [r for r in want if r[0] == "VET-T008"]
    assert "90.0%" in t008[2]
    assert got == [r[:2] + (r[2] + topo_lint.T008_NOTE,) + r[3:]
                   if r[0] == "VET-T008" else r for r in want]


def level_shapes(mod, compiled, params):
    """The ``LevelShape`` list ``lint_compiled`` plans over (its own
    loop, without the findings)."""
    import numpy as np

    shapes, offset = [], 0
    for lvl in compiled.levels:
        pmax = max(int(lvl.step_is_real.sum(1).max(initial=0)), 1)
        sparse, tiles, residual = False, None, 0
        if lvl.num_calls:
            widths = lvl.step_is_real[:, :pmax].sum(1)
            enc, plan = mod.level_encoding(
                lvl.num_hops, pmax, len(np.unique(lvl.call_seg)), widths,
                sparse_level_elems=params.sparse_level_elems,
                tiling=params.sparse_tiling,
                tile_pmax=params.sparse_tile_pmax)
            sparse = enc != "dense"
            if enc == "tiled":
                tiles = plan.shapes()
                residual = len(plan.residual)
        shapes.append(mod.LevelShape(
            size=lvl.num_hops, pmax=pmax, children=lvl.num_children,
            calls=lvl.num_calls, attempts=lvl.max_attempts, sparse=sparse,
            offset=offset, tiles=tiles, residual_slots=residual))
        offset += lvl.num_hops
    return shapes


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=lambda p: p.stem)
@pytest.mark.parametrize("schedule,waste", [("critical-path", 1.6),
                                            ("greedy", 1.6),
                                            ("critical-path", 3.0)])
def test_bucket_plan_equals_reference(topo, schedule, waste):
    g, jg = ServiceGraph.from_yaml_file(topo), JaxGraph.from_yaml_file(topo)
    entry = None if g.entrypoints() else g.services[0].name
    p, jp = params_pair()
    shapes = level_shapes(buckets, compile_graph(g, entry=entry), p)
    jshapes = level_shapes(jax_buckets, jax_compile(jg, entry=entry), jp)
    assert [tuple(vars(s).values()) for s in shapes] == [
        tuple(vars(s).values()) for s in jshapes]
    segs = buckets.plan_segments(shapes, waste=waste, schedule=schedule)
    jsegs = jax_buckets.plan_segments(jshapes, waste=waste,
                                      schedule=schedule)
    assert buckets.plan_signature(segs) == jax_buckets.plan_signature(jsegs)
    assert buckets.plan_stats(shapes, segs) == jax_buckets.plan_stats(
        jshapes, jsegs)
    assert buckets.schedule_table(shapes, segs) == (
        jax_buckets.schedule_table(jshapes, jsegs))
    assert buckets.plan_cp_cost(shapes, segs) == jax_buckets.plan_cp_cost(
        jshapes, jsegs)
    off = buckets.plan_segments(shapes, enabled=False)
    assert buckets.plan_signature(off) == jax_buckets.plan_signature(
        jax_buckets.plan_segments(jshapes, enabled=False))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_lint_graph_policy_blocks(name):
    g, jg = graph_pair(GRAPHS[name])
    for kw in ({}, dict(timeline_window_s=10.0)):
        p, jp = params_pair(**kw)
        got = as_rows(topo_lint.lint_graph(g, params=p))
        assert got == as_rows(jax_lint.lint_graph(jg, params=jp))
    if name == "cycle":
        assert any(r[0] == "VET-T001" for r in got), got
        return
    c, jc = compile_graph(g), jax_compile(jg)
    assert as_rows(topo_lint.lint_compiled(c)) == as_rows(
        jax_lint.lint_compiled(jc))


def test_lint_graph_undecodable_rollout_and_entry():
    g, jg = graph_pair(RETRY_CHAIN)
    g.rollouts = jg.rollouts = {"worker": {"steps": "everything"}}
    got = as_rows(topo_lint.lint_graph(g))
    assert got == as_rows(jax_lint.lint_graph(jg))
    assert any(r[0] == "VET-T015" and r[1] == "error" for r in got)
    g, jg = graph_pair(RETRY_CHAIN)
    assert as_rows(topo_lint.lint_graph(g, entry="nope")) == as_rows(
        jax_lint.lint_graph(jg, entry="nope"))


def config_pair(tmp_path, topo_texts, **kw):
    """An ``ExperimentConfig`` in each package over the same topology
    files; ``chaos`` / ``churn`` / ``mtls`` are keyword dicts."""
    paths = []
    for i, text in enumerate(topo_texts):
        path = tmp_path / (f"t{i}.yaml" if not isinstance(text, tuple)
                           else text[0])
        path.write_text(text if not isinstance(text, tuple) else text[1])
        paths.append(str(path))
    out = []
    for cfg, sim in ((port_config, port_sim_config),
                     (jax_config, jax_sim_config)):
        extra = dict(kw)
        extra["chaos"] = tuple(sim.ChaosEvent(**c)
                               for c in kw.get("chaos", ()))
        extra["churn"] = tuple(sim.TrafficSplit(**c)
                               for c in kw.get("churn", ()))
        if kw.get("mtls"):
            extra["mtls"] = sim.MtlsSchedule(**kw["mtls"])
        envs = extra.pop("envs", ("NONE",))
        out.append(cfg.ExperimentConfig(
            topology_paths=tuple(paths),
            environments=tuple(cfg.DEFAULT_ENVIRONMENTS[e] for e in envs),
            **extra))
    return out


CONFIGS = {
    "tight-breaker": ([LB_CHAIN + """
policies:
  worker:
    breaker: {max_pending: 0.001, max_connections: 0.001}
"""], dict(qps=(0.9 * 4 * MU,), connections=(8,), duration_s=10.0,
           load_kind="open")),
    "rollout-min-samples": ([LB_CHAIN + """
rollouts:
  worker:
    steps: [1%, 100%]
    bake: 2s
    gates: {min_samples: 500}
"""], dict(qps=(100.0,), connections=(8,), duration_s=30.0,
           load_kind="open", rollouts=True)),
    "over-capacity": ([LB_CHAIN], dict(qps=(10.0, 1e6), connections=(8,),
                                       duration_s=10.0, load_kind="open")),
    "schedules": ([LB_CHAIN], dict(
        qps=(100.0,), connections=(8,), duration_s=10.0, load_kind="open",
        chaos=[dict(service="worker", start_s=20.0, end_s=30.0),
               dict(service="ghost", start_s=1.0, end_s=2.0)],
        churn=[dict(service="worker", weights=(1.0, 0.5), period_s=60.0),
               dict(service="phantom", weights=(1.0,), period_s=1.0)],
        mtls=dict(taxes_s=(0.0, 1e-3), period_s=100.0))),
    "label-collision": ([("a.yaml", LB_CHAIN), ("a.yml", LB_CHAIN)],
                        dict(qps=(100.0,), connections=(8,),
                             duration_s=10.0, envs=("NONE", "ISTIO"))),
    "bad-topology": (["services: [", ("missing.yaml", LB_CHAIN)],
                     dict(qps=(100.0,), connections=(8,), duration_s=1.0)),
    "fleet-specs": ([LB_CHAIN], dict(
        qps=(100.0,), connections=(8,), duration_s=10.0, ensemble=4,
        search_candidates=3, search_eta=4, search_rungs=3)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lint_config_equals_reference(tmp_path, name):
    texts, kw = CONFIGS[name]
    cfg, jcfg = config_pair(tmp_path, texts, **kw)
    if name == "bad-topology":
        (tmp_path / "missing.yaml").unlink()
    got, graphs = topo_lint.lint_config(cfg)
    want, jgraphs = jax_lint.lint_config(jcfg)
    assert as_rows(got) == as_rows(want)
    assert set(graphs) == set(jgraphs)
    assert got or name == "fleet-specs"


@pytest.mark.parametrize("preset", ["latency.toml", "cpu_mem.toml"])
def test_lint_config_presets(preset):
    got, graphs = topo_lint.lint_config(
        port_config.load_toml(ROOT / "configs" / preset))
    want, jgraphs = jax_lint.lint_config(
        jax_config.load_toml(ROOT / "configs" / preset))
    assert as_rows(got) == as_rows(want) and set(graphs) == set(jgraphs)


N, BLOCK = 4096, 256


@pytest.mark.parametrize("case", [
    "none", "ok", "bad-table", "small", "flat", "ragged", "peak"])
def test_lint_search_equals_reference(case):
    def spec(mod_search, mod_ens):
        return {
            "none": (None, {}),
            "ok": (mod_search(candidates=mod_ens.of(16), eta=4, rungs=2),
                   dict(num_requests=N, block=BLOCK)),
            "bad-table": ({"eta": "wide"}, {}),
            "small": ({"candidates": {"seeds": [0, 1, 2, 3]}, "eta": 4,
                       "rungs": 3}, {}),
            "flat": (mod_search(candidates=mod_ens.of(16), eta=4, rungs=2),
                     dict(num_requests=BLOCK, block=BLOCK)),
            "ragged": (mod_search(candidates=mod_ens.of(10), eta=4,
                                  rungs=2), {}),
            "peak": (mod_search(candidates=mod_ens.of(16), eta=4, rungs=2,
                                rank="err_peak"), {}),
        }[case]

    s, kw = spec(SearchSpec, EnsembleSpec)
    js, jkw = spec(JaxSearchSpec, JaxEnsembleSpec)
    assert as_rows(topo_lint.lint_search(s, **kw)) == as_rows(
        jax_lint.lint_search(js, **jkw))


@pytest.mark.parametrize("spec", [
    None, "levels=3,members=32,keep=0.25", "levls=3",
    "levels=3,members=2,keep=0.25", "keep=1.5", "levels=1,members=8"])
def test_lint_split_equals_reference(spec):
    assert as_rows(topo_lint.lint_split(spec)) == as_rows(
        jax_lint.lint_split(spec))


@pytest.mark.parametrize("seeds", [None, (), (0, 1, 2), (0, 1, 1, 2, 2)])
def test_lint_ensemble_equals_reference(seeds):
    if seeds is None:
        got, want = topo_lint.lint_ensemble(None), jax_lint.lint_ensemble(
            None)
    else:
        got = topo_lint.lint_ensemble(EnsembleSpec(seeds=seeds))
        want = jax_lint.lint_ensemble(JaxEnsembleSpec(seeds=seeds))
    assert as_rows(got) == as_rows(want)


@pytest.mark.parametrize("variant", ["as-fit", "hot", "degenerate"])
def test_lint_ingest_equals_reference(variant):
    import copy

    obs = read_path(str(DATA / "sample.prom"))
    jobs = jax_read_path(str(DATA / "sample.prom"))
    fr = fit(obs, FitOptions(label="prom", duration_s=60.0))
    jfr = jax_fit(jobs, JaxFitOptions(label="prom", duration_s=60.0))
    doc = copy.deepcopy(report.to_doc(fr, obs))
    assert doc == jax_report.to_doc(jfr, jobs)
    if variant == "hot":
        doc["fit"]["qps_schedule"] = [1000.0]
    elif variant == "degenerate":
        doc["fit"]["services"][0]["observed"]["samples"] = 0.0
    got = as_rows(topo_lint.lint_ingest(fr.graph, doc))
    assert got == as_rows(jax_lint.lint_ingest(jfr.graph, doc))
    assert bool(got) == (variant != "as-fit")
