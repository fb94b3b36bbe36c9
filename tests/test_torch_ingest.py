"""The port's trace-driven ingest (``ingest/``, ``commands/ingest_cmd.py``)
against the JAX package's.

- The readers over the vendored inputs (``tests/data/ingest``: a
  Prometheus exposition, Envoy ``/stats`` JSON, a CSV span trace) give
  equal ``Observation``s, and the fit equal topology YAML, TOML and
  dropped lists; ``to_doc`` and ``format_report`` are equal.
- The self-closure loop of ``tests/test_ingest.py``: the port records
  the same run (``run_timeline`` with a ``MetricsCollector``, on the
  reference's draws through ``JaxReplayDraws``) and its two expositions
  equal the reference's series for series: counts exactly, floats
  within rtol 1e-5 / atol 1e-9, the recorder's occupancy-derived series
  (``timeline_service_inflight`` / ``_queue_depth`` / ``_utilization``) within
  64 float32 spacings of their integral (``test_torch_summary.
  occupancy_atol``'s band).  Each side's fit of its own exposition
  passes the closure.  On the same inputs (the reference's
  expositions) the port's fit is the reference's exactly; on each
  side's own run the fitted floats agree within rtol 2e-3 / atol 1e-9,
  the closure's relative errors within 2e-3 (they are sums of the
  occupancy integrals, see the test), and the
  YAML and TOML line by line up to their numbers.
- ``run_ingest``'s artifacts are byte-equal to the reference's, and the
  TOML loads through the port's ``load_toml``.
"""
import argparse
import dataclasses
import io
import json
import pathlib
import re
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest

from isotope_tpu import ingest as jax_ingest
from isotope_tpu.commands.ingest_cmd import run_ingest as jax_run_ingest
from isotope_tpu.compiler import compile_graph as jax_compile
from isotope_tpu.ingest import report as jax_report
from isotope_tpu.metrics import timeline as jax_tm
from isotope_tpu.metrics.prometheus import MetricsCollector as JaxCollector
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu_torch import ingest
from isotope_tpu_torch.commands.ingest_cmd import run_ingest
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.ingest import report
from isotope_tpu_torch.metrics import timeline as tm
from isotope_tpu_torch.metrics.prometheus import MetricsCollector
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.runner.config import load_toml
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
from test_torch_replay import JaxReplayDraws
from test_torch_summary import _prom_values

DATA = pathlib.Path(__file__).parent / "data" / "ingest"
INPUTS = {
    "prom": (["sample.prom"], dict(duration_s=60.0)),
    "envoy": (["envoy_stats.json"], dict(duration_s=60.0)),
    "csv": (["trace.csv"], {}),
    "merged": (["sample.prom", "envoy_stats.json"],
               dict(entry="gw", duration_s=60.0)),
}
CLOSURE_TOPOLOGY = {
    "defaults": {"requestSize": 128, "responseSize": 128},
    "services": [
        {"name": "gw", "isEntrypoint": True,
         "script": [{"sleep": "2ms"}, {"call": "auth"}, {"call": "cart"}]},
        {"name": "auth", "errorRate": "2%", "script": [{"sleep": "1ms"}]},
        {"name": "cart", "script": [{"sleep": "3ms"}]},
    ],
}
CLOSURE_QPS, CLOSURE_N = 200.0, 3000
OCCUPANCY_SERIES = ("timeline_service_inflight",
                    "timeline_service_queue_depth",
                    "timeline_service_utilization")


def read_both(files, window_s=1.0):
    obs = jobs = None
    for name in files:
        obs = ingest.read_path(str(DATA / name), obs=obs, window_s=window_s)
        jobs = jax_ingest.read_path(str(DATA / name), obs=jobs,
                                    window_s=window_s)
    return obs, jobs


def fit_both(obs, jobs, label, **opts):
    return (ingest.fit(obs, ingest.FitOptions(label=label, **opts)),
            jax_ingest.fit(jobs, jax_ingest.FitOptions(label=label, **opts)))


def fitted_yaml(fr):
    return fr.graph.to_yaml()


def doc_close(got, want, path="", rtol=1e-5, atol=1e-9):
    """Documents equal: keys, strings, booleans and integers exactly,
    floats within ``rtol`` / ``atol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            doc_close(got[k], want[k], f"{path}.{k}", rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            doc_close(g, w, f"{path}[{i}]", rtol, atol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", list(INPUTS))
def test_readers_and_fit_equal_reference(name):
    files, opts = INPUTS[name]
    obs, jobs = read_both(files)
    assert dataclasses.asdict(obs) == dataclasses.asdict(jobs)
    fr, jfr = fit_both(obs, jobs, name, **opts)
    assert fitted_yaml(fr) == fitted_yaml(jfr)
    assert fr.toml_text == jfr.toml_text
    assert fr.dropped == jfr.dropped
    doc = report.to_doc(fr, obs)
    assert doc == jax_report.to_doc(jfr, jobs)
    assert report.check_doc(doc) is doc
    assert report.format_report(doc) == jax_report.format_report(doc)


@pytest.mark.parametrize("pinned", ["prometheus", "csv"])
def test_pinned_format_equal_reference(pinned):
    name = {"prometheus": "sample.prom", "csv": "trace.csv"}[pinned]
    obs = ingest.read_path(str(DATA / name), fmt=pinned, window_s=2.0)
    jobs = jax_ingest.read_path(str(DATA / name), fmt=pinned, window_s=2.0)
    assert dataclasses.asdict(obs) == dataclasses.asdict(jobs)


@pytest.fixture(scope="module")
def closure_pair(tmp_path_factory):
    """The reference's self-closure loop run by both packages on the
    same draws: ``{side: (graph, params, texts, obs, fit)}``."""
    td = tmp_path_factory.mktemp("closure")
    out = {}
    for side in ("port", "jax"):
        if side == "port":
            graph = ServiceGraph.decode(CLOSURE_TOPOLOGY)
            compiled = compile_graph(graph)
            params = SimParams(timeline=True, timeline_window_s=1.0)
            sim = Simulator(compiled, params, device="cpu")
            collector = MetricsCollector(compiled)
            summary, tl = sim.run_timeline(
                LoadModel(kind="open", qps=CLOSURE_QPS), CLOSURE_N,
                JaxReplayDraws(jax.random.PRNGKey(0)), collector=collector,
                window_s=1.0)
            texts = (collector.full_text(summary),
                     tm.prometheus_text(compiled, tl))
            pkg = ingest
        else:
            graph = JaxGraph.decode(CLOSURE_TOPOLOGY)
            compiled = jax_compile(graph)
            params = JaxParams(timeline=True, timeline_window_s=1.0)
            sim = JaxSimulator(compiled, params)
            collector = JaxCollector(compiled)
            summary, tl = sim.run_timeline(
                JaxLoad(kind="open", qps=CLOSURE_QPS), CLOSURE_N,
                jax.random.PRNGKey(0), collector=collector, window_s=1.0)
            texts = (collector.full_text(summary),
                     jax_tm.prometheus_text(compiled, tl))
            pkg = jax_ingest
        (td / f"{side}.full.prom").write_text(texts[0])
        (td / f"{side}.timeline.prom").write_text(texts[1])
        obs = pkg.read_path(str(td / f"{side}.full.prom"))
        obs = pkg.read_path(str(td / f"{side}.timeline.prom"), obs=obs)
        fr = pkg.fit(obs, pkg.FitOptions(label="closure"))
        out[side] = (graph, params, texts, obs, fr)
    return out


def _occupancy_atol(text):
    """64 float32 spacings of the largest occupancy integral, over one
    window: the recorder's band against the JAX package."""
    stamps = [int(m) for m in re.findall(r" (\d+)$", text, re.M)]
    horizon = (max(stamps) / 1e3) + 1.0
    return 64 * float(np.spacing(np.float32(horizon * CLOSURE_N)))


def test_closure_expositions_equal_reference(closure_pair):
    got_texts, want_texts = closure_pair["port"][2], closure_pair["jax"][2]
    occ_atol = _occupancy_atol(want_texts[1])
    for got, want in zip(got_texts, want_texts):
        g, w = _prom_values(got), _prom_values(want)
        assert set(g) == set(w)
        assert [ln for ln in got.splitlines() if ln.startswith("#")] == [
            ln for ln in want.splitlines() if ln.startswith("#")]
        for key, wv in w.items():
            if key.startswith(OCCUPANCY_SERIES):
                assert abs(g[key] - wv) <= occ_atol, (key, g[key], wv)
            elif float(wv).is_integer():
                assert g[key] == wv, key
            else:
                np.testing.assert_allclose(g[key], wv, rtol=1e-5,
                                           atol=1e-9, err_msg=key)


def test_closure_passes_in_both_and_fits_agree(closure_pair, tmp_path):
    verdicts = {}
    for side, mod in (("port", ingest), ("jax", jax_ingest)):
        graph, params, _, obs, fr = closure_pair[side]
        closure = mod.closure_check(graph, params.cpu_time_s,
                                    [CLOSURE_QPS], fr)
        assert closure["ok"], json.dumps(closure["checks"], indent=1)
        assert not fr.dropped["services"] and not fr.dropped["edges"]
        verdicts[side] = closure
    # the same inputs: the port's readers and fit over the reference's
    # own expositions give the reference's fit exactly
    graph, params, texts, jobs, jfr = closure_pair["jax"]
    obs = None
    for i, text in enumerate(texts):
        path = tmp_path / f"{i}.prom"
        path.write_text(text)
        obs = ingest.read_path(str(path), obs=obs)
    fr = ingest.fit(obs, ingest.FitOptions(label="closure"))
    assert fitted_yaml(fr) == fitted_yaml(jfr)
    assert fr.toml_text == jfr.toml_text
    assert report.to_doc(fr, obs)["fit"] == jax_report.to_doc(
        jfr, jobs)["fit"]
    assert ingest.closure_check(graph, params.cpu_time_s, [CLOSURE_QPS],
                                fr) == verdicts["jax"]
    # each side's own run: the fitted times come from the recorder's
    # occupancy integrals (summed window by window), held to the
    # reference's within 64 float32 spacings a window, which moves a
    # fitted time by up to ~1e-3 of itself at this size, and a relative
    # error of the closure by as much
    (_, _, _, obs, fr), (_, _, _, jobs, jfr) = (closure_pair["port"],
                                                closure_pair["jax"])
    doc_close(report.to_doc(fr, obs)["fit"],
              jax_report.to_doc(jfr, jobs)["fit"], rtol=2e-3)
    doc_close(verdicts["port"], verdicts["jax"], rtol=2e-3, atol=2e-3)
    assert fr.dropped == jfr.dropped
    assert len(fitted_yaml(fr).splitlines()) == len(
        fitted_yaml(jfr).splitlines())
    for g, w in zip(fitted_yaml(fr).splitlines(),
                    fitted_yaml(jfr).splitlines()):
        assert _unfloat(g) == _unfloat(w), (g, w)
    for g, w in zip(fr.toml_text.splitlines(), jfr.toml_text.splitlines()):
        assert _unfloat(g) == _unfloat(w), (g, w)


def _unfloat(line):
    """A line with its numbers masked (to compare up to float
    formatting)."""
    return re.sub(r"\d+(\.\d+)?", "#", line)


def test_closure_artifact_renders_and_toml_loads(closure_pair, tmp_path):
    graph, params, _, obs, fr = closure_pair["port"]
    doc = report.to_doc(fr, obs)
    doc["closure"] = ingest.closure_check(graph, params.cpu_time_s,
                                          [CLOSURE_QPS], fr)
    path = tmp_path / "closure.ingest.json"
    report.save_doc(doc, str(path))
    rendered = report.format_report(report.load_doc(str(path)))
    assert "self-closure: PASS" in rendered
    assert rendered == jax_report.format_report(
        jax_report.load_doc(str(path)))
    (tmp_path / "closure.toml").write_text(fr.toml_text)
    cfg = load_toml(tmp_path / "closure.toml")
    assert cfg.ingest and cfg.ingest["label"] == "closure"
    assert cfg.qps[0] == pytest.approx(fr.qps_mean, rel=1e-4)
    assert (cfg.load_kind, cfg.timeline) == ("open", True)


@pytest.mark.parametrize("inputs,extra", [
    (["sample.prom"], dict(duration="60s")),
    (["trace.csv"], dict(window="2s", cpu_time="150us")),
    (["sample.prom", "envoy_stats.json"], dict(duration="60s", entry="gw")),
], ids=["prom", "csv", "merged"])
@pytest.mark.parametrize("as_json", [False, True])
def test_run_ingest_artifacts_equal_reference(tmp_path, inputs, extra,
                                              as_json):
    outs = {}
    for side, fn in (("port", run_ingest), ("jax", jax_run_ingest)):
        kw = dict(format="auto", label="cli", entry=None, duration=None,
                  window="1s", cpu_time=None, connections=16, seed=3)
        kw.update(extra)
        args = argparse.Namespace(
            inputs=[str(DATA / f) for f in inputs],
            out_dir=str(tmp_path / side), json=as_json, **kw)
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            assert fn(args) == 0
        files = {p.name: p.read_bytes()
                 for p in sorted((tmp_path / side).iterdir())}
        outs[side] = (buf.getvalue().replace(str(tmp_path / side), "D"),
                      err.getvalue(), files)
    assert outs["port"] == outs["jax"]
    assert set(outs["port"][2]) == {"cli.yaml", "cli.toml",
                                    "cli.ingest.json"}
    cfg = load_toml(tmp_path / "port" / "cli.toml")
    assert cfg.ingest["label"] == "cli"
    ServiceGraph.from_yaml_file(str(tmp_path / "port" / "cli.yaml"))
