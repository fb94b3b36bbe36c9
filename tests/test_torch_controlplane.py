"""The port's control-plane push model (``isotope_tpu_torch/sim/
controlplane.py``), its projection onto the recorder's windows
(``metrics/timeline.controlplane_windows``, ``to_doc(controlplane=)``),
the monitor sink (``metrics/monitor.py``) and the ``timeline`` command,
against the JAX package.

Stated tolerances: on the reference's own normals (``PRNGKey(seed)``)
the per-proxy ACK times are float32 sums and maxima of the same values,
within rtol 1e-6 (``exp`` may round one ULP apart in XLA and torch); the
window projection and the monitor rows, fed the same inputs, are equal.
The ``timeline`` command on the same draws: its document as
``test_torch_summary.py`` holds the ``--timeline`` document (counts
exactly, occupancy-derived values within ``occupancy_atol``), its
control-plane projection and alarm verdict equal.
"""
from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.metrics import monitor as jax_monitor
from isotope_tpu.metrics import timeline as jax_tm
from isotope_tpu.metrics.alarms import standard_queries as jax_queries
from isotope_tpu.sim import controlplane as jax_cp
from isotope_tpu_torch import cli
from isotope_tpu_torch.metrics import monitor
from isotope_tpu_torch.metrics import timeline as tm
from isotope_tpu_torch.metrics.alarms import standard_queries
from isotope_tpu_torch.metrics.query import MetricStore
from isotope_tpu_torch.sim import controlplane as cp
from test_torch_replay import JaxReplayDraws
from test_torch_summary import CANONICAL, assert_doc_close, occupancy_atol


def _jax_normals(seed, p):
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), (p,)), np.float32
    ).copy())


@pytest.mark.parametrize("entries,endpoints,proxies,throttle", [
    (10, 10, 50, 100),
    (100, 10, 500, 100),
    (1000, 5, 3000, 64),
    (3, 1, 1, 100),
])
def test_push_convergence_on_reference_normals(entries, endpoints, proxies,
                                               throttle):
    model = cp.PilotModel(push_throttle=throttle)
    jmodel = jax_cp.PilotModel(push_throttle=throttle)
    got = cp.push_convergence(model, entries, endpoints, proxies,
                              z=_jax_normals(5, proxies))
    want = jax_cp.push_convergence(jmodel, entries, endpoints, proxies,
                                   key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(got.ack_times_s, want.ack_times_s, rtol=1e-6)
    assert got.ack_times_s.dtype == np.float64
    for q in ([0.5, 0.99], 0.9):
        np.testing.assert_allclose(got.quantile_s(q), want.quantile_s(q),
                                   rtol=1e-6)
    np.testing.assert_allclose(got.max_s, want.max_s, rtol=1e-6)
    t = float(np.median(want.ack_times_s))
    assert abs(got.converged_fraction(t) - want.converged_fraction(t)) <= (
        2.0 / proxies
    )


def test_deterministic_closed_form():
    m = cp.PilotModel(push_throttle=4, push_jitter=0.0, debounce_s=0.1,
                      gen_s_per_endpoint=0.0, push_base_s=1.0,
                      push_s_per_endpoint=0.0)
    res = cp.push_convergence(m, 1, 1, 10)
    want = [1.1] * 4 + [2.1] * 4 + [3.1] * 2
    np.testing.assert_allclose(np.sort(res.ack_times_s), want, rtol=1e-6)
    assert res.converged_fraction(1.2) == pytest.approx(0.4)
    assert res.converged_fraction(3.2) == 1.0


def test_convergence_grows_with_config_and_fleet():
    m = cp.PilotModel()
    small = cp.push_convergence(m, 10, 10, 50)
    big_cfg = cp.push_convergence(m, 1000, 10, 50)
    big_fleet = cp.push_convergence(m, 10, 10, 5000)
    assert big_cfg.max_s > small.max_s
    assert big_fleet.max_s > small.max_s
    wide = cp.PilotModel(push_throttle=1000)
    assert cp.push_convergence(wide, 10, 10, 5000).max_s < big_fleet.max_s


def test_sweep_rows_monotone_and_seeded():
    rows = cp.convergence_sweep(cp.PilotModel(), [10, 100, 1000], 10, 100)
    assert [r["num_entries"] for r in rows] == [10, 100, 1000]
    assert [r["endpoints"] for r in rows] == [100, 1000, 10000]
    p99s = [r["p99_s"] for r in rows]
    assert p99s[0] < p99s[1] < p99s[2]
    assert rows == cp.convergence_sweep(cp.PilotModel(), [10, 100, 1000],
                                        10, 100)
    assert rows != cp.convergence_sweep(cp.PilotModel(), [10, 100, 1000],
                                        10, 100, seed=1)


def test_push_normals_are_seeded():
    a, b = cp.push_normals(64, 3), cp.push_normals(64, 3)
    assert torch.equal(a, b) and not torch.equal(a, cp.push_normals(64, 4))
    assert a.dtype == torch.float32 and a.shape == (64,)


def test_validation():
    with pytest.raises(ValueError):
        cp.PilotModel(push_throttle=0)
    with pytest.raises(ValueError):
        cp.push_convergence(cp.PilotModel(), 1, 1, 0)


@pytest.mark.parametrize("acks,window_s,windows", [
    ([0.05, 0.2, 0.2, 0.9, 2.5, 40.0], 0.5, 8),
    ([0.0, 1.0, 1.0, 1.0], 1.0, 3),
    ([], 1.0, 4),
    ([7.5], 10.0, 1),
])
def test_controlplane_windows_equal_reference(acks, window_s, windows):
    got = tm.controlplane_windows(np.asarray(acks), window_s, windows)
    assert got == jax_tm.controlplane_windows(np.asarray(acks), window_s,
                                              windows)


def test_window_series_equals_reference():
    res = cp.push_convergence(cp.PilotModel(), 100, 10, 400,
                              z=_jax_normals(0, 400))
    want = jax_cp.push_convergence(jax_cp.PilotModel(), 100, 10, 400,
                                   key=jax.random.PRNGKey(0))
    assert res.window_series(0.01, 6) == want.window_series(0.01, 6)


# -- the monitor sink ---------------------------------------------------------


def _store_text():
    """A canonical run's exposition (the port's collector)."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics.prometheus import MetricsCollector
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws

    compiled = compile_graph(ServiceGraph.from_yaml_file(CANONICAL))
    sim = Simulator(compiled, device="cpu")
    collector = MetricsCollector(compiled)
    summary = sim.run_summary(LoadModel(kind="open", qps=1000.0), 500,
                              TorchDraws(0, "cpu"), collector=collector)
    return collector.full_text(summary), float(summary.end_max)


def test_monitor_rows_equal_reference(tmp_path):
    from isotope_tpu.metrics.query import MetricStore as JaxStore

    text, end = _store_text()
    store, jstore = MetricStore.from_text(text, end), JaxStore.from_text(
        text, end)
    rows = monitor.evaluate(standard_queries("canonical", cpu_lim=1.0),
                            store, "lbl", 2, 20.0)
    want = jax_monitor.evaluate(jax_queries("canonical", cpu_lim=1.0),
                                jstore, "lbl", 2, 20.0)
    assert [r.to_json() for r in rows] == [r.to_json() for r in want]
    assert any(r.status == monitor.STATUS_ALARM for r in rows)
    onset = monitor.first_alarm_onset(rows)
    assert onset.window_index == 2 and onset.sim_time_s == 20.0
    sink = monitor.MonitorSink(tmp_path / "s.jsonl")
    written = monitor.monitor_run(store, sink, standard_queries("c"), "x")
    assert sink.read() == written
    assert sink.alarms() == [r for r in written
                             if r.status == monitor.STATUS_ALARM]
    assert monitor.MonitorSink(tmp_path / "none").read() == []


def test_monitor_flapping_alarm_is_inconclusive():
    from isotope_tpu_torch.metrics.alarms import Alarm, Query

    class Flapping:
        def __init__(self):
            self.reads = 0

        def query_value(self, q):
            self.reads += 1
            return 1.0 if self.reads == 1 else 0.0

    q = Query("flap", "x", Alarm(lambda v: v > 0.5, "fired"), None)
    (row,) = monitor.evaluate([q], Flapping())
    assert row.status == monitor.STATUS_INCONCLUSIVE


# -- the timeline command -----------------------------------------------------


def _timeline_both(tmp_path, monkeypatch, flags, seed=0):
    """The JAX ``timeline`` command and the port's on the same draws
    (``TorchDraws`` replays ``PRNGKey(seed)``, the push's normals are
    the reference's): ``{name: (port, JAX)}`` for stdout, stderr, the
    exit code and every file written."""
    import isotope_tpu_torch.sim
    from isotope_tpu import cli as jax_cli

    key = jax.random.PRNGKey(seed)
    monkeypatch.setattr(isotope_tpu_torch.sim, "TorchDraws",
                        lambda seed_, device: JaxReplayDraws(key))
    monkeypatch.setattr(cp, "push_normals",
                        lambda p, seed_, device: _jax_normals(seed_, p))
    out = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        argv = ["timeline", str(CANONICAL)] + [
            str(d / a[5:]) if a.startswith("FILE:") else a for a in flags
        ] + ["--seed", str(seed)]
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            rc = (cli.main(argv + ["--device", "cpu"]) if side == "port"
                  else jax_cli.main(argv))
        out[side] = {"rc": rc, "stdout": buf.getvalue(),
                     "stderr": err.getvalue()}
        for f in d.iterdir():
            out[side][f.name] = f.read_text()
    return {k: (out["port"][k], out["jax"][k]) for k in out["jax"]}


def test_timeline_command_matches_reference(tmp_path, monkeypatch):
    got = _timeline_both(tmp_path, monkeypatch, [
        "--qps", "2000", "--duration", "3s", "--window", "500ms",
        "--controlplane", "100:10:500", "--alarms", "--alarm-sink",
        "FILE:sink.jsonl", "--out", "FILE:tl.json", "--json",
        "--perfetto", "FILE:tp.json", "--prometheus", "FILE:tl.prom",
    ])
    doc, want = (json.loads(t) for t in got["stdout"])
    assert doc["controlplane"] == want["controlplane"]
    assert doc["controlplane"]["proxies"] == 500
    assert_doc_close(doc, want, occ_atol=occupancy_atol(want))
    assert json.loads(got["tl.json"][0]) == doc
    assert got["rc"][0] == got["rc"][1]
    rows = [[json.loads(line) for line in t.splitlines()]
            for t in got["sink.jsonl"]]
    assert [(r["monitor"], r["status"], r["window_index"]) for r in rows[0]]\
        == [(r["monitor"], r["status"], r["window_index"]) for r in rows[1]]
    # the CPU rows are the busy-occupancy integral in milli-cores: the
    # occupancy band, scaled
    cpu_atol = 1000.0 * occupancy_atol(want)
    for a, b in zip(*rows):
        atol = cpu_atol if "CPU" in b["monitor"] else 2e-3
        np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4,
                                   atol=atol, err_msg=b["monitor"])
    onset = [line for line in got["stderr"][0].splitlines()
             if line.startswith(("ALARM onset", "alarms:"))]
    want_onset = [line for line in got["stderr"][1].splitlines()
                  if line.startswith(("ALARM onset", "alarms:"))]
    assert [o.split(" = ")[0] for o in onset] == [
        o.split(" = ")[0] for o in want_onset
    ]
    tp, tp_want = (json.loads(t) for t in got["tp.json"])
    assert [e["name"] for e in tp["traceEvents"]] == [
        e["name"] for e in tp_want["traceEvents"]
    ]


def test_timeline_command_table_and_exit_code(tmp_path, monkeypatch):
    got = _timeline_both(tmp_path, monkeypatch, [
        "--qps", "500", "--duration", "2s", "--window", "1s",
        "--controlplane", "10:10:50", "--alarms", "--cpu-limit", "1e9",
        "--mem-limit", "1e9",
    ])
    table, want = got["stdout"]
    assert table.splitlines()[0] == want.splitlines()[0]
    assert table.splitlines()[-1] == want.splitlines()[-1]
    assert "controlplane: push converged in window 0 (50 proxies)" in table
    assert got["rc"] == (0, 0)
    assert "alarms: all windows clean" in got["stderr"][0]


def test_timeline_command_refuses_a_bad_controlplane_spec():
    err = io.StringIO()
    with redirect_stdout(io.StringIO()), redirect_stderr(err):
        assert cli.main(["timeline", str(CANONICAL), "--duration", "1s",
                         "--controlplane", "1:2", "--device", "cpu"]) == 1
    assert err.getvalue().startswith("error: ")
    assert "N:M:P" in err.getvalue()
