"""The port's run supervisor (``isotope_tpu_torch/resilience/``) against
the JAX package's.

The taxonomy classifies every exception of the reference's table as the
reference does, plus the torch and CUDA ones (``torch.cuda.
OutOfMemoryError`` degrades; a sticky CUDA error — an illegal memory
access, an unspecified launch failure — fails the case and is never
retried).  ``backoff_seconds`` equals the reference's value for value.
The ladder descends on an out-of-memory error only, on the Simulator's
own device (``scan`` -> ``half-block``), and ``--no-degrade`` stops it.
``nan:segment`` poisons a level and trips the summary sentinel; a
numeric failure fails its case, never the sweep.  These mirror the
single-device tests of ``tests/test_resilience.py``.
"""
import json
import pathlib

import pytest
import torch

from isotope_tpu.resilience import backoff_seconds as jax_backoff
from isotope_tpu.resilience import classify as jax_classify
from isotope_tpu.resilience import faults as jax_faults
from isotope_tpu.resilience import ResiliencePolicy as JaxPolicy
from isotope_tpu_torch import cli, telemetry
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.resilience import (
    DETERMINISTIC,
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    InjectedFault,
    NumericSentinelError,
    ResiliencePolicy,
    backoff_seconds,
    call_with_retries,
    classify,
    execution_rungs,
    faults,
    run_ladder,
    sentinels,
)
from isotope_tpu_torch.runner.config import load_toml
from isotope_tpu_torch.runner.run import run_experiment
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws

ROOT = pathlib.Path(__file__).resolve().parents[1]
CANONICAL = ROOT / "examples" / "topologies" / "canonical.yaml"

CHAIN = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{call: c}]
- name: c
"""

OPEN = LoadModel(kind="open", qps=2000.0)
NOSLEEP = ResiliencePolicy(sleep=lambda s: None)


@pytest.fixture(autouse=True)
def clean_state():
    faults.clear()
    telemetry.reset()
    yield
    faults.clear()
    telemetry.reset()
    telemetry.disable()


def chain_sim():
    return Simulator(compile_graph(ServiceGraph.from_yaml(CHAIN)),
                     device="cpu")


# -- taxonomy ------------------------------------------------------------------

REFERENCE_CASES = [
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating "
                 "268435456 bytes"),
    RuntimeError("Failed to allocate request for 2.0GiB"),
    MemoryError(),
    RuntimeError("UNAVAILABLE: Socket closed"),
    RuntimeError("DEADLINE_EXCEEDED: RPC timed out"),
    ConnectionResetError("peer reset"),
    TimeoutError(),
    ValueError("shapes (3,) and (4,) not aligned"),
    RuntimeError("INVALID_ARGUMENT: bad operand"),
    RuntimeError("Barrier timed out after 30s"),
    RuntimeError("corrupted cache entry: digest mismatch"),
]


@pytest.mark.parametrize("exc", REFERENCE_CASES,
                         ids=[repr(e)[:40] for e in REFERENCE_CASES])
def test_classify_matches_reference(exc):
    assert classify(exc) == jax_classify(exc)


@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB"),
     RESOURCE_EXHAUSTED),
    # torch's OOM type classifies by type, whatever its text says
    (torch.cuda.OutOfMemoryError("allocator gave up"), RESOURCE_EXHAUSTED),
    (RuntimeError("CUDA error: out of memory"), RESOURCE_EXHAUSTED),
    # sticky: the context is lost, no retry and no rung can succeed
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     DETERMINISTIC),
    (RuntimeError("CUDA error: unspecified launch failure"),
     DETERMINISTIC),
    (RuntimeError("CUDA error: device-side assert triggered; UNAVAILABLE"),
     DETERMINISTIC),
    (RuntimeError("CUDA error: misaligned address; out of memory"),
     DETERMINISTIC),
    (NumericSentinelError("NaN"), DETERMINISTIC),
])
def test_classify_torch_and_cuda_errors(exc, want):
    assert classify(exc) == want


def test_sticky_cuda_error_is_never_retried():
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_ladder([("scan", boom), ("half-block", boom)], NOSLEEP)
    assert calls["n"] == 1
    assert telemetry.counter_get("retries_total") == 0.0
    assert telemetry.counter_get("degradations_total") == 0.0


def test_injected_faults_classify_like_their_shape():
    faults.install("oom:engine.run:1,transient:engine.build:1")
    with pytest.raises(InjectedFault) as oom:
        faults.check("engine.run")
    with pytest.raises(InjectedFault) as tr:
        faults.check("engine.build")
    assert classify(oom.value) == RESOURCE_EXHAUSTED
    assert classify(tr.value) == TRANSIENT
    # the budgets are consumed: the sites pass afterwards
    faults.check("engine.run")
    faults.check("engine.build")
    assert telemetry.counter_get("faults_injected") == 2.0


@pytest.mark.parametrize("spec,err", [
    ("explode:engine.run:1", "unknown fault kind"),
    ("nan:engine.run:1", "nan faults target segments"),
    ("oom", "bad fault spec"),
    ("oom:sharded.gater:1", "sharded.gather"),
    ("stuck:engine.run", "stuck faults target the breaker"),
])
def test_fault_spec_validation_matches_reference(spec, err):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match=err):
            mod.install(spec)
    jax_faults.clear()


@pytest.mark.parametrize("spec,item", [
    ("corrupt:cache.load:1", "no compiled-executable cache"),
])
def test_unwired_fault_sites_raise_naming_their_item(spec, item):
    """A plan the port cannot fire raises when installed, never parses
    and silently does nothing."""
    with pytest.raises(NotImplementedError, match=item):
        faults.install(spec)
    assert not faults.active()


@pytest.mark.parametrize("spec", [
    "oom:sharded.args_put:1",
    "oom:sharded.compute:1",
    "transient:sharded.dcn_collective:1",
    "oom:sharded.gather:2",
])
def test_sharded_fault_sites_are_wired(spec):
    """The sharded runner's sites install and fire where the reference
    checks them (``parallel/sharded.py``), as the reference's plan
    reads them."""
    site = spec.split(":")[1]
    try:
        faults.install(spec)
        assert faults.active()
        assert faults.signature() == jax_faults.FaultPlan.parse(
            spec).signature()
        with pytest.raises(InjectedFault):
            faults.check(site)
    finally:
        faults.clear()


@pytest.mark.parametrize("spec", [
    "stuck:policies.stuck_breaker",
    "lag:policies.autoscaler_lag:2",
    "degrade:lb.degraded_backend:1",
])
def test_policy_and_lb_fault_sites_parse_like_reference(spec):
    """The policy and lb layers' behavioral sites install, and read back
    as the reference's plan does (its ``test_fault_spec_policy_sites``):
    the accessors the engine consults and the plan's signature."""
    try:
        faults.install(spec)
        want = jax_faults.FaultPlan.parse(spec)
        assert faults.active()
        assert faults.stuck_breaker() == want.stuck_breaker()
        assert faults.autoscaler_lag() == want.autoscaler_lag()
        assert faults.lb_degraded_backend() == want.lb_degraded_backend()
        assert faults.signature() == want.signature() != ""
    finally:
        faults.clear()


def test_fault_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv("ISOTOPE_FAULT_INJECT", "oom:engine.build:1")
    faults._env_loaded = False
    faults._plan = None
    with pytest.raises(InjectedFault, match="RESOURCE_EXHAUSTED"):
        chain_sim()
    chain_sim()  # budget spent
    assert faults.signature() == ""


# -- retry and backoff ---------------------------------------------------------


def test_backoff_matches_reference_value_for_value():
    ours, ref = ResiliencePolicy(), JaxPolicy()
    for site in ("engine.run", "engine.build", "engine.scan",
                 "engine.half-block", "sharded.gather"):
        for attempt in range(10):
            assert backoff_seconds(site, attempt, ours) == jax_backoff(
                site, attempt, ref)
    seq = [backoff_seconds("engine.run", a, ours) for a in range(8)]
    assert all(0 < s <= ours.backoff_cap_s for s in seq)
    assert seq[1] > seq[0]


def test_transient_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionResetError("blip")
        return "ok"

    slept = []
    p = ResiliencePolicy(max_retries=3, sleep=slept.append)
    assert call_with_retries(flaky, "t.site", p) == "ok"
    assert calls["n"] == 3
    assert slept == [backoff_seconds("t.site", a, p) for a in range(2)]
    assert telemetry.counter_get("retries_total") == 2.0


def test_retry_budget_exhausts():
    def always():
        raise TimeoutError("never")

    with pytest.raises(TimeoutError):
        call_with_retries(always, "t.site",
                          ResiliencePolicy(max_retries=2,
                                           sleep=lambda s: None))
    assert telemetry.counter_get("retries_total") == 2.0


def test_deterministic_error_not_retried():
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise ValueError("bad shape")

    with pytest.raises(ValueError):
        call_with_retries(boom, "t.site", NOSLEEP)
    assert calls["n"] == 1


def test_policy_from_the_environment(monkeypatch):
    monkeypatch.setenv("ISOTOPE_MAX_RETRIES", "5")
    monkeypatch.setenv("ISOTOPE_NO_DEGRADE", "yes")
    p = ResiliencePolicy.from_env()
    assert (p.max_retries, p.degrade) == (5, False)
    assert ResiliencePolicy.from_env(max_retries=1, degrade=True) == \
        ResiliencePolicy(max_retries=1, degrade=True)


# -- the ladder ----------------------------------------------------------------


def test_ladder_descends_on_oom_only():
    seen = []

    def rung(name, fail):
        def thunk():
            seen.append(name)
            if fail:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            return name
        return (name, thunk)

    out, degraded = run_ladder([rung("a", True), rung("b", True),
                                rung("c", False)], NOSLEEP)
    assert (out, degraded) == ("c", "c")
    assert seen == ["a", "b", "c"]
    assert telemetry.counter_get("degradations_total") == 2.0
    assert telemetry.get_meta("degraded_to") == "c"
    assert "isotope_engine_degradations_total 2" in (
        telemetry.prometheus_text()
    )


def test_ladder_respects_no_degrade():
    def oom():
        raise RuntimeError("RESOURCE_EXHAUSTED: no")

    with pytest.raises(RuntimeError):
        run_ladder([("a", oom), ("b", lambda: "b")],
                   ResiliencePolicy(degrade=False, sleep=lambda s: None))


def test_single_device_ladder_halves_block_on_the_same_device():
    """The injected OOM serves the run from ``half-block``: the same
    requests in blocks of half the size, on the Simulator's device, to
    the summary a half-block run gives."""
    sim = chain_sim()
    faults.install("oom:engine.run:1")
    rungs = execution_rungs(sim, OPEN, 2048, TorchDraws(3, "cpu"), 1024)
    assert [name for name, _ in rungs] == ["scan", "half-block"]
    (summary, attr), degraded = run_ladder(rungs, NOSLEEP)
    assert degraded == "half-block" and attr is None
    assert summary.count.device.type == "cpu"
    want = sim.run_summary(OPEN, 2048, TorchDraws(3, "cpu"), block_size=512,
                           trim=True)
    assert torch.equal(summary.latency_hist, want.latency_hist)
    assert float(summary.count) == 2048


def test_ladder_serves_an_attributed_rung():
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(CHAIN)),
                    SimParams(attribution=True), device="cpu")
    rungs = execution_rungs(sim, OPEN, 1024, TorchDraws(3, "cpu"), 512,
                            attribution="on")
    (summary, attr), degraded = run_ladder(rungs, NOSLEEP)
    plain = sim.run_summary(OPEN, 1024, TorchDraws(3, "cpu"),
                            block_size=512, trim=True)
    assert degraded is None
    assert torch.equal(summary.latency_hist, plain.latency_hist)
    assert int(attr.count) == 1024


# -- numeric sentinels ---------------------------------------------------------


def test_nan_injection_trips_summary_sentinel():
    faults.install("nan:segment:0")
    summary = chain_sim().run_summary(OPEN, 512, TorchDraws(0, "cpu"),
                                      block_size=256)
    with pytest.raises(NumericSentinelError, match="NaN"):
        sentinels.check_summary(summary)
    assert telemetry.counter_get("numeric_sentinel_violations") >= 1.0


@pytest.mark.parametrize("segment", [0, 1, 2])
def test_nan_localized_per_segment_in_detail_mode(segment):
    faults.install(f"nan:segment:{segment}")
    telemetry.enable(detail=True)
    chain_sim().run(OPEN, 64, TorchDraws(0, "cpu"))
    hits = [k for k in telemetry.snapshot().gauges
            if k.startswith("numeric_sentinel{")]
    # the poisoned level, and every level above it that sums it
    assert f'numeric_sentinel{{segment="up.lvl[{segment}]"}}' in hits
    assert not any(f"up.lvl[{d}]" in k for k in hits
                   for d in range(segment + 1, 3))


def test_clean_run_passes_sentinels():
    sim = chain_sim()
    sentinels.check_summary(sim.run_summary(OPEN, 512, TorchDraws(0, "cpu"),
                                            block_size=256))
    sentinels.check_results(sim.run(OPEN, 64, TorchDraws(0, "cpu")))
    assert telemetry.counter_get("numeric_sentinel_violations") == 0.0
    assert faults.signature() == ""
    faults.install("nan:segment:2")
    assert faults.signature() == "nan:segment:2"


# -- the runner ----------------------------------------------------------------


def _config(tmp_path, n=1500):
    cfg = tmp_path / "exp.toml"
    cfg.write_text(f"""
topology_paths = ["{CANONICAL}"]
environments = ["NONE"]

[client]
qps = [200, 400]
num_concurrent_connections = [8]
duration = "30s"
load_kind = "open"

[sim]
num_requests = {n}
seed = 7
""")
    return load_toml(cfg)


def test_numeric_failure_fails_case_but_not_sweep(tmp_path):
    faults.install("nan:segment:0")
    results = run_experiment(_config(tmp_path), out_dir=str(tmp_path / "o"),
                             policy=NOSLEEP, device="cpu")
    faults.clear()
    assert len(results) == 2
    assert all(r.failed and "sentinel" in r.error for r in results)
    recs = [json.loads(ln) for ln in
            (tmp_path / "o" / "checkpoint.jsonl").read_text()
            .splitlines()[1:]]
    assert all(r["failed"] and r["error_class"] == DETERMINISTIC
               for r in recs)
    assert len((tmp_path / "o" / "benchmark.csv").read_text()
               .splitlines()) == 1
    # resume with the fault gone: both cases retry and complete
    ran = []
    results = run_experiment(_config(tmp_path), out_dir=str(tmp_path / "o"),
                             progress=ran.append, policy=NOSLEEP,
                             device="cpu")
    assert len(ran) == 2 and not any(r.failed for r in results)


def test_injected_oom_degrades_one_case_and_reports_it(tmp_path, capsys):
    """``oom:engine.run:1``: the first case is served by ``half-block``,
    reported (``degraded_to`` in its row and its checkpoint record, the
    sweep's DEGRADED line) and passes the sentinels; the other case is
    undegraded."""
    cfg = tmp_path / "exp.toml"
    cfg.write_text(f"""
topology_paths = ["{CANONICAL}"]
environments = ["NONE"]

[client]
qps = [200, 400]
num_concurrent_connections = [8]
duration = "30s"
load_kind = "open"

[sim]
num_requests = 1500
seed = 7
""")
    faults.install("oom:engine.run:1")
    rc = cli.main(["sweep", str(cfg), "-o", str(tmp_path / "o"),
                   "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "1 run(s) completed DEGRADED: canonical_none_200qps_8c" in err
    rows = [json.loads(ln) for ln in
            (tmp_path / "o" / "results.jsonl").read_text().splitlines()]
    assert [r.get("degraded_to") for r in rows] == ["half-block", None]
    recs = [json.loads(ln) for ln in
            (tmp_path / "o" / "checkpoint.jsonl").read_text()
            .splitlines()[1:]]
    assert recs[0]["degraded_to"] == "half-block"
    assert "degraded_to" not in recs[1]


def test_no_degrade_fails_the_case(tmp_path, capsys):
    faults.install("oom:engine.run:1")
    rc = cli.main(["sweep", str(_write(tmp_path)), "-o",
                   str(tmp_path / "o"), "--no-degrade", "--max-retries",
                   "0", "--device", "cpu"])
    assert rc == 1
    assert "1 run(s) FAILED" in capsys.readouterr().err


def _write(tmp_path):
    cfg = tmp_path / "exp.toml"
    cfg.write_text(f"""
topology_paths = ["{CANONICAL}"]
environments = ["NONE"]

[client]
qps = [300]
num_concurrent_connections = [8]
duration = "30s"
load_kind = "open"

[sim]
num_requests = 1000
""")
    return cfg


def test_transient_build_fault_retries_to_the_same_row(tmp_path):
    clean = run_experiment(load_toml(_write(tmp_path)), device="cpu")
    faults.install("transient:engine.build:2")
    (r,) = run_experiment(load_toml(_write(tmp_path)), policy=NOSLEEP,
                          device="cpu")
    assert telemetry.counter_get("retries_total") == 2.0
    assert not r.failed and r.degraded_to is None
    assert {k: v for k, v in r.flat.items() if k != "StartTime"} == {
        k: v for k, v in clean[0].flat.items() if k != "StartTime"}


def test_cli_resilience_flags_match_reference():
    """``--max-retries`` and ``--no-degrade`` parse as the JAX command's
    on ``simulate`` and ``sweep``."""
    import argparse

    from isotope_tpu.commands import simulate_cmd

    ref = argparse.ArgumentParser()
    simulate_cmd.register(ref.add_subparsers())
    for cmd in ("simulate", "sweep"):
        argv = [cmd, "x", "--max-retries", "2", "--no-degrade"]
        want = vars(ref.parse_args(argv))
        got = vars(cli.build_parser().parse_args(argv))
        assert (got["max_retries"], got["no_degrade"]) == (
            want["max_retries"], want["no_degrade"]) == (2, True)
