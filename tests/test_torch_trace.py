"""The port's trace and export layers (``isotope_tpu_torch/metrics/
trace.py``, ``metrics/export.py``) against the JAX package's, and the
``simulate`` flags that write them (``--trace``, ``--attribution``,
``--blame-out``, ``--flamegraph``, ``--perfetto-blame``,
``--exemplar-trace``, ``--timeline-perfetto``) against the JAX command on
the same draws.

Stated tolerances: fed the same summary, the port's documents equal the
reference's exactly (host formatting).  From each engine's own run (the
same draws): span times within rtol 1e-5 (the engine's), integer
microseconds within that plus one (a truncation or rounding of such a
value); the blame documents as ``test_torch_attribution.py`` states
(the blame histograms' band included); the recorder's counter tracks'
counts exactly, their occupancy-derived values within the
``occupancy_atol`` of ``test_torch_summary.py``.
"""
from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch
import yaml

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import attribution as jax_attr
from isotope_tpu.metrics import export as jax_export
from isotope_tpu.metrics import trace as jax_trace
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu_torch import cli
from isotope_tpu_torch.metrics import attribution, export, trace
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from test_torch_attribution import (
    RESID_ULPS,
    assert_hist_band,
    tree13,  # noqa: F401  (module fixture)
)
from test_torch_replay import JaxReplayDraws, port_compiled, scenario_pair
from test_torch_summary import CANONICAL, assert_doc_close, occupancy_atol
from test_torch_timeline import as_jax

KEY = jax.random.PRNGKey(0)

TOPO = """
services:
- name: entry
  isEntrypoint: true
  script:
  - sleep: 2ms
  - [{call: left}, {call: right}]
  - call: tail
- name: left
  script: [{call: leaf}]
- name: right
- name: tail
  errorRate: 30%
- name: leaf
"""


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def as_jax_attr(a):
    """A port AttributionSummary with numpy leaves, for the reference's
    host functions."""
    ex = a.exemplars
    return jax_attr.AttributionSummary(
        *(_np(x) for x in a[:-1]),
        exemplars=(
            None if ex is None
            else jax_attr.ExemplarBatch(*(_np(x) for x in ex))
        ),
    )


@pytest.fixture(scope="module")
def runs():
    """(JAX compiled, port results, JAX results) of 24 requests."""
    jc = jax_compile_graph(JaxGraph.decode(yaml.safe_load(TOPO)))
    js, ps = scenario_pair(jc)
    load = dict(kind="open", qps=200.0)
    got = ps.run(LoadModel(**load), 24, JaxReplayDraws(KEY, js))
    want = js.run(JaxLoad(**load), 24, KEY)
    return jc, ps.compiled, got, want


@pytest.fixture(scope="module")
def attributed(tree13):  # noqa: F811
    js, ps = scenario_pair(tree13, dict(attribution=True))
    load = dict(kind="open", qps=200.0)
    _, a = ps.run_attributed(LoadModel(**load), 1024,
                             JaxReplayDraws(KEY, js), block_size=256,
                             tail=True)
    js_, ja = js.run_attributed(JaxLoad(**load), 1024, KEY, block_size=256,
                                tail=True)
    return tree13, ps.compiled, a, ja, float(js_.latency_sum)


def _close(got, want, path="", us=False, resid=None):
    """Documents equal up to the engine's float tolerance (integer
    microseconds within one more)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}", us, resid)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", us, resid)
    elif isinstance(want, bool) or isinstance(want, str):
        assert got == want, (path, got, want)
    elif isinstance(want, int) and us:
        assert abs(got - want) <= 1 + 1e-5 * abs(want), (path, got, want)
    elif isinstance(want, float):
        if resid is not None and "residual" in path:
            assert abs(got - want) <= resid, path
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                       err_msg=path)
    else:
        assert got == want, (path, got, want)


# -- traces -------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["chrome", "jaeger"])
def test_traces_match_reference(runs, fmt):
    jc, pc, got, want = runs
    fn = f"{fmt}_trace"
    a = getattr(trace, fn)(pc, got, max_requests=16)
    b = getattr(jax_trace, fn)(jc, want, max_requests=16)
    _close(a, b, us=True)
    # fed the same results, the documents are identical
    assert getattr(trace, fn)(pc, got) == getattr(jax_trace, fn)(
        jc, got._replace(**{
            k: _np(v) for k, v in got._asdict().items() if v is not None
        })
    )


def test_chrome_trace_containment_and_status(runs):
    _, pc, res, _ = runs
    events = trace.chrome_trace(pc, res)["traceEvents"]
    by_req = {}
    for e in events:
        by_req.setdefault(e["pid"], {})[e["args"]["hop"]] = e
    for spans in by_req.values():
        for e in spans.values():
            p = e["args"]["parent_hop"]
            if p < 0:
                continue
            parent = spans[p]
            assert e["ts"] >= parent["ts"] - 1e-6
            assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-6
    statuses = {e["args"]["status"] for e in events if e["name"] == "tail"}
    assert 500 in statuses and 200 in statuses
    assert {e["tid"] for e in events} == {0, 1, 2}


def test_chrome_trace_respects_max_requests(runs):
    _, pc, res, _ = runs
    doc = trace.chrome_trace(pc, res, max_requests=5)
    assert {e["pid"] for e in doc["traceEvents"]} == set(range(5))


def test_jaeger_trace_references_resolve(runs):
    _, pc, res, _ = runs
    doc = trace.jaeger_trace(pc, res, max_requests=8)
    assert len(doc["data"]) == 8
    for tr in doc["data"]:
        ids = {s["spanID"] for s in tr["spans"]}
        by_id = {s["spanID"]: s for s in tr["spans"]}
        roots = 0
        for s in tr["spans"]:
            assert s["traceID"] == tr["traceID"]
            assert s["processID"] in tr["processes"]
            if not s["references"]:
                roots += 1
                continue
            (ref,) = s["references"]
            assert ref["refType"] == "CHILD_OF" and ref["spanID"] in ids
            parent = by_id[ref["spanID"]]
            assert s["startTime"] >= parent["startTime"]
        assert roots == 1


def test_unsent_hops_produce_no_spans(runs):
    _, pc, res, _ = runs
    doc = trace.chrome_trace(pc, res)
    assert len(doc["traceEvents"]) == int(res.hop_sent.sum())


@pytest.mark.parametrize("fmt", ["jaeger", "chrome"])
def test_exemplar_trace_matches_reference(attributed, tmp_path, fmt):
    jc, pc, a, ja, _ = attributed
    got = trace.write_trace(tmp_path / "p.json", pc, fmt=fmt, exemplars=a)
    want = jax_trace.write_trace(str(tmp_path / "j.json"), jc, fmt=fmt,
                                 exemplars=ja)
    assert got == want == 8
    doc = json.loads((tmp_path / "p.json").read_text())
    _close(doc, json.loads((tmp_path / "j.json").read_text()), us=True)
    assert trace.exemplar_annotations(a) == jax_trace.exemplar_annotations(
        as_jax_attr(a)
    )
    if fmt == "jaeger":
        tags = {t["key"]: t["value"]
                for t in doc["data"][0]["spans"][0]["tags"]}
        assert tags["tail_rank"] == 0
        assert tags["tail_cut_s"] == pytest.approx(float(a.tail_cut))
    else:
        assert doc["traceEvents"][0]["args"]["tail_rank"] == 0


def test_write_trace_refusals(runs, tmp_path):
    _, pc, res, _ = runs
    with pytest.raises(ValueError, match="res or exemplars"):
        trace.write_trace(tmp_path / "x.json", pc)
    with pytest.raises(ValueError, match="unknown trace format"):
        trace.write_trace(tmp_path / "x.json", pc, res, fmt="zipkin")


# -- attribution and timeline artifacts ---------------------------------------


def test_flamegraph_and_perfetto_equal_reference_on_one_summary(attributed):
    """Fed the same summary, the flamegraph and the counter tracks are
    the reference's, byte for byte."""
    _, pc, a, _, _ = attributed
    ja = as_jax_attr(a)
    for tail in (False, True):
        assert export.flamegraph_collapsed(pc, a, tail=tail) == (
            jax_export.flamegraph_collapsed(pc, ja, tail=tail)
        )
    assert export.perfetto_counters(pc, a) == jax_export.perfetto_counters(
        pc, ja
    )
    assert export.perfetto_counters(pc, a, top=3) == (
        jax_export.perfetto_counters(pc, ja, top=3)
    )


def test_flamegraph_from_each_engine_matches_reference(attributed):
    jc, pc, a, ja, _ = attributed
    for tail in (False, True):
        got = _stacks(export.flamegraph_collapsed(pc, a, tail=tail))
        want = _stacks(jax_export.flamegraph_collapsed(jc, ja, tail=tail))
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1 + 1e-5 * want[k], k
    # the flame's width is the attributed latency
    total = sum(_stacks(export.flamegraph_collapsed(pc, a)).values())
    assert total == pytest.approx(a.total_blame_s * 1e6, rel=1e-4)


def _stacks(text):
    out = {}
    for line in text.splitlines():
        stack, _, us = line.rpartition(" ")
        out[stack] = int(us)
    return out


def test_write_flamegraph_and_perfetto_counters(attributed, tmp_path):
    _, pc, a, _, _ = attributed
    lines = export.write_flamegraph(tmp_path / "f.txt", pc, a)
    assert lines == len((tmp_path / "f.txt").read_text().splitlines())
    n = export.write_perfetto_counters(tmp_path / "p.json", pc, a)
    doc = json.loads((tmp_path / "p.json").read_text())
    assert n == len(doc["traceEvents"])
    assert doc["otherData"]["tail_cut_s"] == pytest.approx(float(a.tail_cut))


def test_timeline_perfetto_equals_reference(tree13, tmp_path):  # noqa: F811
    js, ps = scenario_pair(tree13, dict(timeline=True))
    _, tl = ps.run_timeline(LoadModel(kind="open", qps=200.0), 1024,
                            JaxReplayDraws(KEY, js), block_size=256,
                            window_s=1.0)
    pc = ps.compiled
    assert export.timeline_perfetto(pc, tl) == jax_export.timeline_perfetto(
        pc, as_jax(tl)
    )
    assert export.timeline_perfetto(pc, tl, top=2) == (
        jax_export.timeline_perfetto(pc, as_jax(tl), top=2)
    )
    n = export.write_timeline_perfetto(tmp_path / "t.json", pc, tl)
    assert n == len(json.loads((tmp_path / "t.json").read_text())[
        "traceEvents"
    ])


class _Result:
    def __init__(self, i):
        self.fortio_json = {"Labels": f"run{i}", "ActualQPS": 10.0 * i}


def test_exporters_write_what_the_reference_writes(tmp_path):
    results = [_Result(i) for i in range(3)]
    specs = ["bigquery:proj.ds.table", "gcs:gs://bucket/path"]
    for side, mod in (("port", export), ("jax", jax_export)):
        d = tmp_path / side
        d.mkdir()
        msgs = mod.run_exporters(specs, results, d)
        assert len(msgs) == 2
    for name in ("bq_rows.json", "bq_insert.sh"):
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "jax" / name
        ).read_text()
    gcs = [(tmp_path / side / "gcs_upload.sh").read_text().replace(
        str(tmp_path / side), "OUT") for side in ("port", "jax")]
    assert gcs[0] == gcs[1]
    with pytest.raises(export.ExportError, match="unknown exporter"):
        export.resolve_exporter("s3")
    with pytest.raises(export.ExportError, match="needs a table"):
        export.resolve_exporter("bigquery")
    export.register_exporter("null", lambda arg: lambda res, d: arg)
    assert export.resolve_exporter("null:x")([], tmp_path) == "x"


# -- the simulate flags -------------------------------------------------------


def _simulate_pair(tmp_path, monkeypatch, topo, flags, seed=0):
    """The JAX command (``--mesh 1x1``; run key ``fold_in(PRNGKey(seed),
    0)``, its ``--trace`` batch ``PRNGKey(seed)``) and the port's on the
    same draws: the port's ``TorchDraws(seed)`` replays ``PRNGKey(seed)``
    (its main run draws from ``RootedSource(TorchDraws(seed), 0)``, the
    run key; its trace batch from ``TorchDraws(seed)``)."""
    import isotope_tpu_torch.sim
    from isotope_tpu import cli as jax_cli

    monkeypatch.setattr(
        isotope_tpu_torch.sim, "TorchDraws",
        lambda seed_, device: JaxReplayDraws(jax.random.PRNGKey(seed_)),
    )
    out = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        argv = ["simulate", str(topo)] + [
            str(d / a[5:]) if a.startswith("FILE:") else a for a in flags
        ] + ["--seed", str(seed)]
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            rc = (cli.main(argv + ["--device", "cpu"]) if side == "port"
                  else jax_cli.main(argv + ["--mesh", "1x1"]))
        assert rc == 0, err.getvalue()
        out[side] = {"stdout": json.loads(buf.getvalue()),
                     "stderr": err.getvalue()}
        for f in d.iterdir():
            text = f.read_text()
            out[side][f.name] = (
                json.loads(text) if f.suffix == ".json" else text
            )
    return {k: (out["port"][k], out["jax"][k]) for k in out["jax"]}


def _dist(doc):
    """The perfetto blame document's per-service histograms."""
    centers = list(attribution.blame_bucket_centers() * 1e6)
    rows = {}
    for e in doc["traceEvents"]:
        if e["name"].startswith("blame dist "):
            row = rows.setdefault(e["name"], np.zeros(len(centers)))
            row[centers.index(e["ts"])] = e["args"]["requests"]
    return rows


def test_cli_attribution_documents_match_reference(tmp_path, monkeypatch):
    got = _simulate_pair(tmp_path, monkeypatch, CANONICAL, [
        "--qps", "1000", "--duration", "2s", "--load-kind", "open",
        "--attribution", "tail", "--blame-out", "FILE:blame.json",
        "--flamegraph", "FILE:flame.txt", "--perfetto-blame",
        "FILE:pb.json", "--exemplar-trace", "FILE:ex.json",
        "--timeline", "500ms", "--timeline-perfetto", "FILE:tp.json",
    ])
    doc, want = got["stdout"]
    resid = RESID_ULPS * float(np.spacing(np.float32(
        want["DurationHistogram"]["Avg"] * want["DurationHistogram"]["Count"]
    )))
    _close(*got["blame.json"], resid=resid / want["DurationHistogram"][
        "Count"])
    assert got["blame.json"][0]["tail_cut_s"] is not None
    flame, flame_want = (_stacks(t) for t in got["flame.txt"])
    assert set(flame) == set(flame_want)
    for k in flame_want:
        assert abs(flame[k] - flame_want[k]) <= 1 + 1e-5 * flame_want[k], k
    pb, pb_want = got["pb.json"]
    d, d_want = _dist(pb), _dist(pb_want)
    assert set(d) == set(d_want)
    assert_hist_band(np.stack([d[k] for k in sorted(d)]),
                     np.stack([d_want[k] for k in sorted(d)]), "pb")
    _close([e for e in pb["traceEvents"] if "dist" not in e["name"]],
           [e for e in pb_want["traceEvents"] if "dist" not in e["name"]])
    _close(*got["ex.json"], us=True)
    tp, tp_want = got["tp.json"]
    assert [(e["name"], e["ts"]) for e in tp["traceEvents"][1:]] == [
        (e["name"], e["ts"]) for e in tp_want["traceEvents"][1:]
    ]
    occ = occupancy_atol({"num_windows": 4, "window_s": 0.5,
                          "services": {"x": {"requests": 2000.0}}})
    for e, w in zip(tp["traceEvents"][1:], tp_want["traceEvents"][1:]):
        for k, v in w["args"].items():
            if e["name"].startswith("client"):
                assert e["args"][k] == pytest.approx(v, rel=1e-5), e
            else:
                assert abs(e["args"][k] - v) <= occ + 1e-5 * abs(v), e
    assert "critical-path blame over 2000 requests" in got["stderr"][0]
    assert_doc_close(doc, want)


@pytest.mark.parametrize("fmt", ["chrome", "jaeger"])
def test_cli_trace_matches_reference(tmp_path, monkeypatch, fmt):
    got = _simulate_pair(tmp_path, monkeypatch, CANONICAL, [
        "--qps", "500", "--duration", "1s", "--load-kind", "open",
        "--trace", "FILE:trace.json", "--trace-format", fmt,
        "--trace-requests", "6",
    ])
    _close(*got["trace.json"], us=True)
    n = (len({e["pid"] for e in got["trace.json"][0]["traceEvents"]})
         if fmt == "chrome" else len(got["trace.json"][0]["data"]))
    assert n == 6
    assert "traced 6 requests" in got["stderr"][0]


def test_cli_trace_honors_entry_override(tmp_path):
    topo = tmp_path / "multi.yaml"
    topo.write_text("""
services:
- name: e1
  isEntrypoint: true
  script: [{call: leaf}]
- name: leaf
- name: e2
  isEntrypoint: true
""")
    out = tmp_path / "trace.json"
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
        rc = cli.main(["simulate", str(topo), "--qps", "50", "--duration",
                       "10s", "--max-requests", "500", "--entry", "e2",
                       "--trace", str(out), "--trace-requests", "3",
                       "--device", "cpu"])
    assert rc == 0
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert any("e2" in n for n in names)
    assert not any("e1" in n or "leaf" in n for n in names)


def test_cli_protected_attribution_appends_blame(tmp_path):
    """``--policies --attribution``: the blame of the protected run, the
    same Fortio document as without ``--attribution``."""
    from test_torch_summary import PROTECTED_TOPOLOGY

    topo = tmp_path / "prot.yaml"
    topo.write_text(PROTECTED_TOPOLOGY)
    docs = []
    for extra in ([], ["--attribution", "--blame-out",
                       str(tmp_path / "b.json")]):
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            assert cli.main(["simulate", str(topo), "--qps", "2000",
                             "--duration", "2s", "--load-kind", "open",
                             "--policies", "--device", "cpu"] + extra) == 0
        docs.append(json.loads(buf.getvalue()))
    for doc in docs:
        doc.pop("StartTime")
    assert docs[0] == docs[1]
    blame = json.loads((tmp_path / "b.json").read_text())
    assert blame["count"] == docs[0]["DurationHistogram"]["Count"]
    assert blame["tail_cut_s"] is None


def test_exemplar_trace_without_exemplars_warns(attributed, tmp_path):
    """A run that mined no exemplars (``attribution_top_k == 0``) skips
    the exemplar trace with the reference's warning."""
    import argparse

    _, pc, a, _, _ = attributed
    args = argparse.Namespace(
        blame_out=None, flamegraph=None, perfetto_blame=None,
        exemplar_trace=str(tmp_path / "e.json"), exemplar_format="jaeger",
    )
    err = io.StringIO()
    with redirect_stderr(err):
        cli._write_attribution_artifacts(args, pc,
                                         a._replace(exemplars=None))
    assert "no exemplars mined" in err.getvalue()
    assert not (tmp_path / "e.json").exists()


def test_top_k_zero_mines_no_exemplars():
    """A run with ``attribution_top_k=0`` on the production source has
    no exemplars and its other invariants."""
    sim = Simulator(port_compiled(jax_compile_graph(JaxGraph.from_yaml(
        TOPO))), SimParams(attribution=True, attribution_top_k=0),
        device="cpu")
    s, a = sim.run_attributed(LoadModel(kind="open", qps=100.0), 300,
                              TorchDraws(1, "cpu"), block_size=100)
    assert a.exemplars is None
    assert int(a.count) == 300 == int(s.count)
    assert float(a.residual_abs) / 300 < 1e-6
