"""The port's benchmark suite (``runner/suite.py``), its reports
(``report.py``, a copy) and the ``suite`` / ``report`` commands against
the JAX package's.

The suites run the same configs on the same draws (the JAX one on one
device, ``$ISOTOPE_MESH=1x1``; the port's ``TorchDraws(seed)`` replays
``PRNGKey(seed)``): the published tree's file names, ``manifest.json``
and the ``monitor_status.jsonl`` rows are equal (a row's value within
rtol 1e-5); ``write_report`` and ``write_history_report`` give the
reference's HTML byte for byte on the same results; the exit codes are
the reference's.  ``metrics/stability.py`` is a copy, held to the
reference's exposition.
"""
import json
import pathlib

import jax
import numpy as np
import pytest

import isotope_tpu_torch.sim
from isotope_tpu import cli as jax_cli
from isotope_tpu import report as jax_report
from isotope_tpu.metrics import stability as jax_stability
from isotope_tpu.runner.suite import run_suite as jax_run_suite
from isotope_tpu.runner.suite import suite_id as jax_suite_id
from isotope_tpu_torch import cli, report
from isotope_tpu_torch.metrics import stability
from isotope_tpu_torch.runner.suite import run_suite, suite_id
from test_torch_replay import JaxReplayDraws

TOPO = pathlib.Path(__file__).resolve().parents[1] / (
    "examples/topologies/canonical.yaml")


def write_cfg(tmp_path, name, qps, envs=("NONE",), n=2000):
    cfg = tmp_path / name
    cfg.write_text(f"""
topology_paths = ["{TOPO}"]
environments = {json.dumps(list(envs))}

[client]
qps = [{qps}]
num_concurrent_connections = [8]
duration = "60s"
load_kind = "open"

[sim]
num_requests = {n}
seed = 3
""")
    return cfg


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(
        isotope_tpu_torch.sim, "TorchDraws",
        lambda seed, device: JaxReplayDraws(jax.random.PRNGKey(seed)),
    )


SID = "20260730_sim_master_dev"


def _suites(tmp_path, monkeypatch, configs, **kw):
    monkeypatch.setenv("ISOTOPE_MESH", "1x1")
    want = jax_run_suite(configs, tmp_path / "jax", id=SID, **kw)
    monkeypatch.delenv("ISOTOPE_MESH")
    got = run_suite(configs, tmp_path / "port", id=SID, device="cpu", **kw)
    return got, want


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_suite_publishes_the_reference_tree(tmp_path, monkeypatch, replay):
    c1 = write_cfg(tmp_path, "latency.toml", 200, envs=("NONE", "ISTIO"))
    c2 = write_cfg(tmp_path, "cpu_mem.toml", 250)
    got, want = _suites(tmp_path, monkeypatch, [str(c1), str(c2)])
    assert _tree(got.publish_dir) == _tree(want.publish_dir)
    assert got.manifest == want.manifest
    assert json.loads((got.publish_dir / "manifest.json").read_text()) == \
        want.manifest
    assert got.manifest["total_runs"] == 3
    rows = [json.loads(ln) for ln in (got.publish_dir /
            "monitor_status.jsonl").read_text().splitlines()]
    want_rows = [json.loads(ln) for ln in (want.publish_dir /
                 "monitor_status.jsonl").read_text().splitlines()]
    assert len(rows) == len(want_rows) == 4 * 3
    for g, w in zip(rows, want_rows):
        gv, wv = g.pop("value"), w.pop("value")
        g.pop("timestamp", None)
        w.pop("timestamp", None)
        assert g == w
        if wv is not None:
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-9)


def test_reports_equal_the_reference_html(tmp_path, monkeypatch, replay):
    """``write_report`` (with a baseline) and ``write_history_report``
    on the port's published results give the reference's HTML."""
    c1 = write_cfg(tmp_path, "latency.toml", 200, envs=("NONE", "ISTIO"))
    got, _ = _suites(tmp_path, monkeypatch, [str(c1)])
    res = got.publish_dir / "latency"
    base = tmp_path / "jax" / SID / "latency"
    for mod, name in ((report, "port.html"), (jax_report, "jax.html")):
        n = mod.write_report(res, tmp_path / name, baseline_dir=base,
                             title="t")
        assert n == 2
    assert (tmp_path / "port.html").read_bytes() == \
        (tmp_path / "jax.html").read_bytes()
    for mod, name in ((report, "ph.html"), (jax_report, "jh.html")):
        mod.write_history_report(tmp_path / "port", tmp_path / name)
    assert (tmp_path / "ph.html").read_bytes() == \
        (tmp_path / "jh.html").read_bytes()
    # the suite's own per-config page is the copy's rendering
    page = (res / "report.html").read_text()
    assert page.startswith("<!DOCTYPE html>") or "<html" in page


def test_suite_resumes_and_fresh_reruns(tmp_path):
    c1 = write_cfg(tmp_path, "latency.toml", 200)
    run_suite([str(c1)], tmp_path / "pub", id="x", device="cpu")
    pub = tmp_path / "pub" / "x"
    rows1 = (pub / "monitor_status.jsonl").read_text().splitlines()
    csv1 = (pub / "latency" / "benchmark.csv").read_bytes()
    ran = []
    run_suite([str(c1)], tmp_path / "pub", id="x", progress=ran.append,
              device="cpu")
    assert ran == []  # the checkpointed sweep replays
    # the sink restarts fresh: no duplicate monitor rows
    assert (pub / "monitor_status.jsonl").read_text().splitlines() == rows1
    assert (pub / "latency" / "benchmark.csv").read_bytes() == csv1
    run_suite([str(c1)], tmp_path / "pub", id="x", progress=ran.append,
              resume=False, device="cpu")
    assert len(ran) == 1


def test_suite_cli_exit_codes_match_reference(tmp_path, capsys, replay,
                                             monkeypatch):
    c1 = write_cfg(tmp_path, "latency.toml", 200)
    for limit, want_rc in (("50", 0), ("0.0001", 1)):
        rcs = []
        for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                                  ("jax", jax_cli.main, [])):
            if side == "jax":
                monkeypatch.setenv("ISOTOPE_MESH", "1x1")
            rcs.append(main(["suite", str(c1), "-o",
                             str(tmp_path / f"{side}{limit}"), "--id", "y",
                             "--cpu-limit", limit] + extra))
            monkeypatch.delenv("ISOTOPE_MESH", raising=False)
            assert "1 runs across 1 configs" in capsys.readouterr().err
        assert rcs == [want_rc, want_rc]


def test_suite_id_and_loadgen_match_reference(tmp_path):
    from datetime import datetime, timezone

    d = datetime(2026, 7, 30, tzinfo=timezone.utc)
    assert suite_id("master", "sim", "dev", d) == jax_suite_id(
        "master", "sim", "dev", d) == "20260730_sim_master_dev"
    cfg = tmp_path / "nh.toml"
    cfg.write_text(f"""
topology_paths = ["{TOPO}"]
environments = ["NONE"]

[client]
loadgen = "nighthawk"
qps = [200]
num_concurrent_connections = [8]
duration = "30s"

[sim]
num_requests = 500
""")
    result = run_suite([str(cfg)], tmp_path / "pub", device="cpu")
    assert "_nighthawk_" in result.publish_dir.name
    assert result.manifest["loadgen"] == "nighthawk"


def test_report_command_matches_reference(tmp_path, capsys):
    c1 = write_cfg(tmp_path, "latency.toml", 300, n=1000)
    run_suite([str(c1)], tmp_path / "pub", id="20260730_sim_master_dev",
              device="cpu")
    res = tmp_path / "pub" / "20260730_sim_master_dev" / "latency"
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        assert main(["report", str(res), "-o",
                     str(tmp_path / f"{side}.html")]) == 0
        assert "1 runs ->" in capsys.readouterr().err
        assert main(["report", str(tmp_path / "pub"), "--history", "-o",
                     str(tmp_path / f"{side}-h.html")]) == 0
        assert "1 publishes ->" in capsys.readouterr().err
    for name in ("{}.html", "{}-h.html"):
        assert (tmp_path / name.format("port")).read_bytes() == (
            tmp_path / name.format("jax")).read_bytes()


@pytest.mark.parametrize("seed", [0, 4])
def test_stability_copy_matches_reference(seed):
    """Scenarios, their exposition and their alarm queries: the
    reference's, for a bounce-coupled and a lossy scenario."""
    made = []
    for mod in (stability, jax_stability):
        made.append([
            mod.StabilityScenario("redis", "redis-master", period_s=0.5,
                                  success_prob=0.97),
            mod.scenario_from_bounce("gateway-bouncer", "istio-gateway",
                                     [(10.0, 20.0), (40.0, 45.0)]),
        ])
    got, want = made
    assert stability.stability_text(got, 60.0, seed) == \
        jax_stability.stability_text(want, 60.0, seed)
    assert [(q.description, q.query, q.running_query) for q in
            stability.stability_queries(got)] == [
        (q.description, q.query, q.running_query)
        for q in jax_stability.stability_queries(want)]
