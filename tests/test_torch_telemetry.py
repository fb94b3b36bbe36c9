"""The port's engine self-telemetry (``isotope_tpu_torch/telemetry``)
against the JAX package's.

The registry's expositions are the reference's on the same registry
(the Prometheus text and ``summary_block`` byte for byte), the jsonl
records round-trip, heal a torn tail and quarantine a corrupt line; the
runner writes its artifacts with telemetry on and none with it off.
With telemetry off the block loop gains no torch op and no card fence
(a ``TorchDispatchMode`` count over a run with telemetry off and on);
``detail`` fences every level of the upward and start-time sweeps.
These mirror ``tests/test_telemetry.py`` (less its XLA hooks, which
have no counterpart in the port).  The port's spans (``span``, no
counterpart in the reference) dispatch nothing with no profiler
running, nest as documented under one, and never stay open across a
block loop's ``yield``.
"""
import contextlib
import json
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isotope_tpu import telemetry as jax_telemetry
from isotope_tpu_torch import cli, telemetry
from isotope_tpu_torch.commands.common import arm_telemetry
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.runner.config import (
    DEFAULT_ENVIRONMENTS,
    ExperimentConfig,
)
from isotope_tpu_torch.runner.run import run_experiment
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from tools.torch_op_count import OpLog

ROOT = pathlib.Path(__file__).resolve().parents[1]
CANONICAL = ROOT / "examples" / "topologies" / "canonical.yaml"
PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.eE+-]+(inf)?$'
)


@pytest.fixture(autouse=True)
def clean_state():
    for mod in (telemetry, jax_telemetry):
        mod.reset()
        mod.disable()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.reset()
        mod.disable()


def _fill(mod):
    mod.counter_inc("probe_events", 3)
    mod.counter_inc("retries_total", 2)
    mod.counter_inc("degradations_total")
    mod.counter_inc("executable_cache_hits", 3)
    mod.counter_inc("executable_cache_misses", 1)
    mod.gauge_set("probe_gauge", 1.5)
    mod.gauge_set("probe_labeled", 2.0, device="0")
    mod.gauge_max("hw", 3.0)
    mod.gauge_max("hw", 1.0)
    mod.phase_add("probe.phase", 0.25)
    mod.phase_add("compile.trace", 1.0)
    mod.set_meta("degraded_to", "half-block")


def test_prometheus_text_and_summary_match_reference():
    _fill(telemetry)
    _fill(jax_telemetry)
    assert telemetry.prometheus_text() == jax_telemetry.prometheus_text()
    assert telemetry.summary_block() == jax_telemetry.summary_block()
    assert telemetry.summary_line() == jax_telemetry.summary_line()
    assert telemetry.gauge_get("hw") == 3.0
    text = telemetry.prometheus_text()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert PROM_LINE.match(line), line
    assert "isotope_engine_retries_total 2" in text
    assert 'events_total{event="retries_total"}' not in text
    assert 'isotope_engine_probe_labeled{device="0"} 2' in text


def test_phase_timers_nest_and_sum():
    with telemetry.phase("outer"):
        with telemetry.phase("inner"):
            pass
        with telemetry.phase("inner"):
            pass
    assert telemetry.phase_seconds("outer") >= telemetry.phase_seconds(
        "inner") > 0.0
    with pytest.raises(KeyError):
        with telemetry.phase("raising"):
            raise KeyError("x")
    assert telemetry.phase_seconds("raising") > 0.0


def test_a_phase_is_a_span_on_the_profilers_timeline():
    def body():
        with telemetry.phase("outer"):
            with telemetry.phase("inner"):
                torch.ones(4).sum()

    spans = _profiled_spans(body)
    assert [s[0] for s in spans] == ["outer", "inner"]
    assert _within(spans[1], spans[0])
    assert telemetry.phase_seconds("inner") > 0.0


def test_run_telemetry_jsonl_round_trip(tmp_path):
    telemetry.counter_inc("x", 2)
    telemetry.gauge_set("g", 0.5, device="1")
    telemetry.phase_add("p", 1.25)
    rec = telemetry.snapshot(label="roundtrip")
    back = telemetry.RunTelemetry.from_dict(json.loads(rec.to_json_line()))
    assert back.to_dict() == rec.to_dict()
    assert rec.meta["backend"] == "cpu" and "torch_version" in rec.meta
    path = tmp_path / "telemetry.jsonl"
    rec.append_jsonl(path)
    rec.append_jsonl(path)
    assert telemetry.validate_jsonl(path) == 2
    # the reference's reader takes the port's records
    assert jax_telemetry.validate_jsonl(path) == 2


@pytest.mark.parametrize("damage", ["torn_tail", "mid_file", "heal"])
def test_jsonl_survives_a_crash(tmp_path, damage):
    """A torn final line, a corrupt middle line, and an append after a
    torn tail: one bad line costs one record, never the file."""
    p = tmp_path / "telemetry.jsonl"
    rec = telemetry.snapshot(label="ok")
    line = rec.to_json_line()
    if damage == "torn_tail":
        rec.append_jsonl(p)
        rec.append_jsonl(p)
        with open(p, "a") as f:
            f.write(line[:40])
        want = 2
    elif damage == "mid_file":
        p.write_text(line[:30] + "\n" + line + "\n")
        want = 1
    else:
        rec.append_jsonl(p)
        with open(p, "a") as f:
            f.write(line[:25])
        rec.append_jsonl(p)
        want = 2
    assert telemetry.validate_jsonl(p) == want
    assert [r.label for r in telemetry.iter_jsonl(p)] == ["ok"] * want
    if damage != "heal":
        assert telemetry.counter_get("telemetry_torn_lines") >= 1.0


def test_validate_jsonl_rejects_bad_schema(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"schema": "nope", "phases": {}}\n')
    with pytest.raises(ValueError, match="schema"):
        telemetry.validate_jsonl(p)
    p.write_text("")
    with pytest.raises(ValueError, match="no telemetry records"):
        telemetry.validate_jsonl(p)
    doc = telemetry.snapshot().to_dict()
    doc["counters"] = {"k": "not-a-number"}
    p.write_text(json.dumps(doc) + "\n")
    with pytest.raises(ValueError, match="not numeric"):
        telemetry.validate_jsonl(p)


def test_summary_block_keeps_the_reference_keys():
    """The XLA series (trace, lower, compile seconds, the caches) read
    0: the port traces and compiles nothing; the CPU has no peak."""
    blk = telemetry.summary_block()
    assert set(blk) == set(jax_telemetry.summary_block())
    assert blk["compile_s"] == 0.0 and blk["cache_hit_ratio"] is None
    assert blk["peak_device_bytes"] is None
    assert telemetry.record_device_memory() is None


def test_arm_telemetry_composes_detail():
    assert arm_telemetry("detail") is True
    assert arm_telemetry("on") is True  # never strips detail
    telemetry.disable()
    assert arm_telemetry(None, detail=False) is False
    assert not telemetry.emitting()
    assert arm_telemetry("on") is False and telemetry.emitting()


# -- the engine ----------------------------------------------------------------


def _canonical_sim(**params):
    return Simulator(compile_graph(ServiceGraph.from_yaml_file(CANONICAL)),
                     device="cpu", params=SimParams(**params))


def _run_ops(sim):
    with OpLog() as ops:
        s = sim.run_summary(LoadModel(kind="open", qps=1000.0), 512,
                            TorchDraws(0, "cpu"), block_size=256)
    return ops.ops, s


def test_telemetry_off_and_on_add_no_op(monkeypatch):
    """The fence helper and the registry updates are host-side: a run
    with telemetry off, or on without detail, dispatches the same torch
    ops and never synchronizes the card."""
    import torch

    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    sim = _canonical_sim()
    _run_ops(sim)  # fill the caches
    off, s_off = _run_ops(sim)
    arm_telemetry("on")
    on, s_on = _run_ops(sim)
    assert on == off
    assert torch.equal(s_on.latency_hist, s_off.latency_hist)
    assert telemetry.counter_get("engine_fences") == 0.0
    assert syncs == []
    # the spans, reached on every block, dispatch nothing with no
    # profiler running: the same ops and outputs as with no spans
    reached = []
    real = telemetry.span

    def counted(name):
        reached.append(name)
        return real(name)

    monkeypatch.setattr(telemetry, "span", counted)
    spans, s_spans = _run_ops(sim)
    monkeypatch.setattr(telemetry, "span",
                        lambda name: contextlib.nullcontext())
    bare, s_bare = _run_ops(sim)
    assert spans == bare == off
    assert torch.equal(s_spans.latency_hist, s_bare.latency_hist)
    assert reached.count("engine.block") == 2
    assert isinstance(real("engine.block"), contextlib.nullcontext)


def test_detail_mode_fences_every_level():
    sim = _canonical_sim()
    arm_telemetry("detail")
    sim.run_summary(LoadModel(kind="open", qps=1000.0), 512,
                    TorchDraws(0, "cpu"), block_size=256)
    levels = len(sim._levels)
    # two blocks, each fencing every level of both sweeps
    assert telemetry.counter_get("engine_fences") == 2 * 2 * levels
    phases = telemetry.snapshot().phases
    for d in range(levels):
        assert f"segment.up.lvl[{d}]" in phases
        assert f"segment.start.lvl[{d}]" in phases
    assert telemetry.counter_get("numeric_sentinel_violations") == 0.0


def _profiled_spans(fn):
    """``(name, start, end)`` of the program's spans in ``fn``'s run
    under a CPU profiler, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda s: s[1])


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _blocks(spans):
    """Each ``engine.block`` with the spans that start inside it."""
    blocks = [s for s in spans if s[0] == "engine.block"]
    return [(b, [s for s in spans if s is not b and b[1] <= s[1] < b[2]])
            for b in blocks]


def test_summary_run_spans_each_block_in_order():
    sim = _canonical_sim()
    spans = _profiled_spans(lambda: sim.run_summary(
        LoadModel(kind="open", qps=1000.0), 512, TorchDraws(0, "cpu"),
        block_size=256))
    names = [s[0] for s in spans]
    assert names == ["engine.block", "engine.draws", "engine.sweep",
                     "summary.block"] * 2
    for block, inner in _blocks(spans):
        assert [s[0] for s in inner] == ["engine.draws", "engine.sweep"]
        assert all(_within(s, block) for s in inner)
    # each block's summary runs after its block span closed
    blocks = [s for s in spans if s[0] == "engine.block"]
    summaries = [s for s in spans if s[0] == "summary.block"]
    assert all(b[2] <= m[1] for b, m in zip(blocks, summaries))


def test_attributed_tail_run_spans_its_pilot_and_each_blame_block():
    sim = _canonical_sim(attribution=True)
    spans = _profiled_spans(lambda: sim.run_attributed(
        LoadModel(kind="open", qps=1000.0), 1024, TorchDraws(0, "cpu"),
        block_size=512, tail=True))
    (pilot,) = [s for s in spans if s[0] == "attribution.tail_pilot"]
    in_pilot = [s for s in spans if s is not pilot and _within(s, pilot)]
    after = [s for s in spans if s[1] >= pilot[2]]
    # the pilot's 1,024 requests run in blocks of 512, the run in two
    assert [s[0] for s in in_pilot].count("engine.block") == 2
    assert "attribution.block" not in [s[0] for s in in_pilot]
    assert [s[0] for s in after] == [
        "engine.block", "engine.draws", "engine.sweep", "summary.block",
        "attribution.block"] * 2
    assert len(in_pilot) + len(after) + 1 == len(spans)


def test_no_span_stays_open_across_a_block_loops_yield(monkeypatch):
    """The lockstep twins suspend ``run_blocks`` and ``_summary_steps``
    at each ``yield``: every span the engine opened is closed there."""
    open_spans, entered = [], []

    @contextlib.contextmanager
    def tracked(name):
        open_spans.append(name)
        entered.append(name)
        try:
            yield
        finally:
            open_spans.remove(name)

    monkeypatch.setattr(telemetry, "span", tracked)
    sim = _canonical_sim(attribution=True)
    load = LoadModel(kind="open", qps=1000.0)
    seen = 0
    for _ in sim.run_blocks(load, 512, TorchDraws(0, "cpu"),
                            block_size=256):
        assert open_spans == []
        seen += 1
    steps = sim._summary_steps(load, 512, TorchDraws(0, "cpu"), 256,
                               None, False, attr=True, tail_cut=0.01)
    while True:
        try:
            next(steps)
        except StopIteration:
            break
        assert open_spans == []
        seen += 1
    assert seen == 4
    assert entered.count("engine.block") == 4
    assert entered.count("attribution.block") == 2


def test_engine_build_and_run_series():
    sim = _canonical_sim()
    sim.run_summary(LoadModel(kind="open", qps=1000.0), 512,
                    TorchDraws(0, "cpu"), block_size=256)
    assert telemetry.counter_get("simulators_built") == 1.0
    assert telemetry.phase_seconds("engine.build") > 0.0
    assert telemetry.gauge_get("engine_block_requests") == 256.0
    assert telemetry.gauge_get("engine_num_blocks") == 2.0


#: a chain of three services: the saturated closed loop's convolution path
CHAIN3 = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{call: c}]
- name: c
"""
SATURATED = dict(kind="closed", qps=None)


def _chain_sim():
    return Simulator(compile_graph(ServiceGraph.from_yaml(CHAIN3)),
                     device="cpu")


@pytest.mark.parametrize("connections", [8, 100])
def test_closed_tables_build_in_their_phase_once_per_population(connections):
    """Below and past ``CONVOLUTION_MAX_POPULATION``: one build a
    population, timed in its phase, with its population and stations."""
    sim = _chain_sim()
    load = LoadModel(connections=connections, **SATURATED)
    for _ in range(2):
        sim.run_summary(load, 2 * connections, TorchDraws(0, "cpu"),
                        block_size=connections)
    assert telemetry.counter_get("closed_table_builds") == 1.0
    assert telemetry.gauge_get("closed_population") == connections
    assert telemetry.gauge_get("closed_stations") == 3.0
    assert telemetry.phase_seconds("closed.tables") > 0.0
    sim.run_summary(LoadModel(connections=16, **SATURATED), 32,
                    TorchDraws(0, "cpu"), block_size=16)
    assert telemetry.counter_get("closed_table_builds") == 2.0
    assert telemetry.gauge_get("closed_population") == 16.0


def test_saturated_run_spans_its_tables_and_each_blocks_waits():
    sim = _chain_sim()
    spans = _profiled_spans(lambda: sim.run_summary(
        LoadModel(connections=8, **SATURATED), 32, TorchDraws(0, "cpu"),
        block_size=16))
    names = [s[0] for s in spans]
    # the tables first, outside any block, then each block's draws, its
    # waits under the finite-population law and its level sweep
    assert names == ["closed.tables"] + [
        "engine.block", "engine.draws", "engine.sat_wait", "engine.sweep",
        "summary.block"] * 2
    for block, inner in _blocks(spans):
        assert [s[0] for s in inner] == ["engine.draws", "engine.sat_wait",
                                         "engine.sweep"]
        assert all(_within(s, block) for s in inner)
    # an open loop has no saturated waits
    spans = _profiled_spans(lambda: sim.run_summary(
        LoadModel(kind="open", qps=1000.0), 32, TorchDraws(0, "cpu"),
        block_size=16))
    assert "engine.sat_wait" not in [s[0] for s in spans]


# -- the runner and the commands -----------------------------------------------


def _config(n=200):
    return ExperimentConfig(
        topology_paths=(str(CANONICAL),),
        environments=(DEFAULT_ENVIRONMENTS["NONE"],),
        qps=(200.0,), connections=(4,), duration_s=1.0, load_kind="open",
        num_requests=n, seed=3,
    )


def test_runner_emits_telemetry_artifacts(tmp_path):
    telemetry.enable()
    (result,) = run_experiment(_config(), out_dir=str(tmp_path / "out"),
                               device="cpu")
    assert result.telemetry["schema"] == telemetry.SCHEMA
    assert result.telemetry["phases"].get("engine.build", 0) > 0
    assert result.telemetry["label"] == result.label
    assert "isotope_engine_events_total" in result.prometheus_text
    assert "service_incoming_requests_total" in result.prometheus_text
    assert telemetry.validate_jsonl(tmp_path / "out" / "telemetry.jsonl") \
        == 1


def test_runner_skips_telemetry_when_off(tmp_path):
    (result,) = run_experiment(_config(), out_dir=str(tmp_path / "out"),
                               device="cpu")
    assert result.telemetry is None
    assert "isotope_engine_" not in result.prometheus_text
    assert not (tmp_path / "out" / "telemetry.jsonl").exists()


def test_cli_simulate_telemetry_appends_its_record(tmp_path, capsys):
    out = tmp_path / "t.jsonl"
    prom = tmp_path / "m.prom"
    for _ in range(2):
        assert cli.main(["simulate", str(CANONICAL), "--qps", "200",
                         "--duration", "1s", "--load-kind", "open",
                         "--telemetry", "--telemetry-out", str(out),
                         "--prometheus", str(prom), "--device",
                         "cpu"]) == 0
    assert telemetry.validate_jsonl(out) == 2
    assert "isotope_engine_" in prom.read_text()
    assert "telemetry: compile 0.00s" in capsys.readouterr().err


def test_cli_telemetry_command(tmp_path, capsys):
    """The ``telemetry`` probe: its Prometheus exposition (or ``--json``
    record), ``--out`` and a ``torch.profiler`` capture for
    ``--xla-trace``."""
    out = tmp_path / "rec.jsonl"
    assert cli.main(["telemetry", str(CANONICAL), "--requests", "256",
                     "--out", str(out), "--device", "cpu",
                     "--xla-trace", str(tmp_path / "trace")]) == 0
    cap = capsys.readouterr()
    assert "isotope_engine_phase_seconds_total" in cap.out
    assert "torch trace: 1 trace file(s)" in cap.err
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())[
        "traceEvents"]
    assert telemetry.validate_jsonl(out) == 1
    assert cli.main(["telemetry", str(CANONICAL), "--requests", "256",
                     "--json", "--detail", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["counters"]["engine_fences"] > 0
    assert any(k.startswith("segment.up.lvl") for k in rec["phases"])


def test_cli_telemetry_flags_match_reference():
    import argparse

    from isotope_tpu.commands import telemetry_cmd

    ref = argparse.ArgumentParser()
    telemetry_cmd.register(ref.add_subparsers())
    want = vars(ref.parse_args(["telemetry"]))
    got = vars(cli.build_parser().parse_args(["telemetry"]))
    for args in (want, got):
        args.pop("func")
        args.pop("command", None)
    assert got.pop("device") is None
    assert got == want
