"""The port's run summary, histogram, Fortio document and CLI against
the JAX package.

``run_summary`` runs three blocks through both engines on the same
draws (block ``b`` replays the JAX key ``fold_in(key, 1_000_000 + b)``).
Tolerances: ``count``, ``error_count`` and ``hop_events`` are exactly
equal; sum, min, max, m2 and the run end agree within rtol 1e-5 (the
per-request latencies carry the few-ULP XLA/torch differences of
tests/test_torch_engine.py, and the f32 block sums add in another
order); p50/p90/p99 agree within one histogram bucket (~0.6%), since a
latency within a few ULP of a bucket edge may land one bucket over.
"""
import io
import json
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import fortio as jax_fortio
from isotope_tpu.metrics import histogram as jax_histogram
from isotope_tpu.models.generators import tree_topology as jax_tree
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import summary as jax_summary
from isotope_tpu_torch import cli
from isotope_tpu_torch.metrics import fortio, histogram
from isotope_tpu_torch.sim import LoadModel, Simulator
from isotope_tpu_torch.sim import summary
from test_torch_replay import JaxReplayDraws, port_compiled

ROOT = pathlib.Path(__file__).resolve().parents[1]
CANONICAL = ROOT / "examples" / "topologies" / "canonical.yaml"

CENSUS_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 30ms, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  script:
  - - call: {service: leaf, timeout: 10ms, retries: 1}
    - call: {service: leaf2, probability: 60}
- name: leaf
  errorRate: 3%
- name: leaf2
  script:
  - call: deep
- name: deep
"""

EXACT = ("count", "error_count", "hop_events", "win_count",
         "win_error_count")
CLOSE = ("latency_sum", "latency_m2", "latency_min", "latency_max",
         "end_max")


def _bucket(x):
    return np.searchsorted(histogram.EDGES, np.asarray(x), side="right") - 1


def _graph(name):
    if name == "flagship":
        return JaxGraph.decode(jax_tree(
            num_levels=5, num_branches=3, request_size=1024,
            response_size=1024,
        ))
    return JaxGraph.from_yaml(CENSUS_YAML)


@pytest.mark.parametrize("name,qps", [("flagship", 1000.0),
                                      ("census", 500.0)])
def test_run_summary_matches_reference(name, qps):
    jc = jax_compile_graph(_graph(name))
    jax_sim = JaxSimulator(jc)
    sim = Simulator(port_compiled(jc), device="cpu")
    key = jax.random.PRNGKey(7)
    want = jax_sim.run_summary(JaxLoad(kind="open", qps=qps), 3 * 1024,
                               key, block_size=1024, trim=True)
    got = sim.run_summary(LoadModel(kind="open", qps=qps), 3 * 1024,
                          JaxReplayDraws(key, jax_sim), block_size=1024,
                          trim=True)
    for field in EXACT:
        assert float(getattr(got, field)) == float(getattr(want, field)), (
            field
        )
    assert float(got.count) == 3 * 1024
    for field in CLOSE:
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=1e-5, err_msg=field,
        )
    qs = (0.5, 0.9, 0.99)
    assert np.all(np.abs(_bucket(got.quantiles_s(qs))
                         - _bucket(want.quantiles_s(qs))) <= 1)
    np.testing.assert_array_equal(
        got.unstable.numpy(), np.asarray(want.unstable)
    )
    np.testing.assert_allclose(
        got.utilization.numpy(), np.asarray(want.utilization), rtol=1e-5
    )


def test_histogram_matches_reference():
    rng = np.random.default_rng(2)
    lat = np.concatenate([
        rng.lognormal(-6.0, 1.5, 4000), [0.0, 1e-7, 50.0, np.nan],
    ]).astype(np.float32)
    want_idx = np.asarray(jax_histogram.bucket_index(jnp.asarray(lat)))
    got_idx = histogram.bucket_index(torch.from_numpy(lat)).numpy()
    # the float32 log may put a value within an ULP of an edge one
    # bucket over; everything else lands in the same bucket
    assert np.abs(got_idx - want_idx).max() <= 1
    assert (got_idx == want_idx).mean() > 0.999
    w = (rng.uniform(0, 1, lat.shape) > 0.5).astype(np.float32)
    got = histogram.latency_histogram(
        torch.from_numpy(lat), torch.from_numpy(w)
    ).numpy()
    assert got.sum() == w.sum()
    np.testing.assert_array_equal(
        got, np.bincount(got_idx, weights=w, minlength=2048)
    )
    qs = [0.5, 0.9, 0.99, 0.999]
    np.testing.assert_array_equal(
        histogram.quantile_from_histogram(torch.from_numpy(got), qs),
        jax_histogram.quantile_from_histogram(got, qs),
    )
    np.testing.assert_array_equal(
        histogram.bucket_centers(), jax_histogram.bucket_centers()
    )


def test_reduce_stacked_matches_reference():
    """Stacked per-block summaries reduce like the reference's."""
    rng = np.random.default_rng(4)
    blocks = []
    for b in range(3):
        lat = rng.lognormal(-6.0, 0.3, 500).astype(np.float32)
        start = np.sort(rng.uniform(0, 100, 500)).astype(np.float32)
        err = rng.uniform(0, 1, 500) < 0.05
        blocks.append((lat, start, err, 1000 + b))

    class Res:
        def __init__(self, lat, start, err, hops, xp):
            self.client_latency = xp(lat)
            self.client_start = xp(start)
            self.client_error = xp(err)
            self.client_end = self.client_start + self.client_latency
            self.hop_events = xp(np.int32(hops))
            self.utilization = xp(np.float32([0.5, 0.25]))
            self.unstable = xp(np.array([False, True]))

    got = summary.reduce_stacked(summary.stack([
        summary.summarize(
            Res(*blk, torch.as_tensor),
            window=(torch.tensor(20.0), torch.tensor(80.0)),
        )
        for blk in blocks
    ]))
    parts = [
        jax_summary.summarize(
            Res(*blk, jnp.asarray),
            window=(jnp.float32(20.0), jnp.float32(80.0)),
        )
        for blk in blocks
    ]
    want = jax_summary.reduce_stacked(
        jax.tree.map(lambda *x: jnp.stack(x), *parts)
    )
    for field in EXACT:
        assert float(getattr(got, field)) == float(getattr(want, field))
    for field in CLOSE:
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=1e-5, err_msg=field,
        )
    np.testing.assert_array_equal(
        got.win_latency_hist.numpy(), np.asarray(want.win_latency_hist)
    )


def test_trim_window_bounds_match_reference():
    for n, qps in [(1000, 10.0), (200_000, 1000.0), (10, 1e6)]:
        assert fortio.trim_window_bounds(n, qps) == (
            jax_fortio.trim_window_bounds(n, qps)
        )


def _jax_canonical_doc():
    graph = JaxGraph.from_yaml_file(CANONICAL)
    sim = JaxSimulator(jax_compile_graph(graph))
    load = JaxLoad(kind="open", qps=1000.0, duration_s=2.0)
    s = sim.run_summary(load, 2000, jax.random.PRNGKey(0), trim=True)
    return jax_fortio.fortio_result_from_summary(s, load, labels="x")


def _keys(doc):
    out = set()
    for k, v in doc.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk in _keys(v)}
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out |= {f"{k}[].{kk}" for kk in _keys(v[0])}
    return out


def test_cli_simulate_prints_the_reference_document():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "simulate", str(CANONICAL), "--qps", "1000", "--duration",
            "2s", "--load-kind", "open", "--device", "cpu",
        ])
    assert rc == 0
    doc = json.loads(buf.getvalue())
    assert _keys(doc) == _keys(_jax_canonical_doc())
    hist = doc["DurationHistogram"]
    assert hist["Count"] == 2000
    assert doc["RetCodes"] == {"200": 2000}
    assert doc["Labels"] == "canonical_none_1000qps_64c"
    assert 0.0 < hist["Percentiles"][0]["Value"] < hist["Max"]


def test_cli_defaults_match_reference():
    """The load flags and their defaults are the JAX command's."""
    from isotope_tpu.commands import simulate_cmd
    import argparse

    ref = argparse.ArgumentParser()
    simulate_cmd.register(ref.add_subparsers())
    want = vars(ref.parse_args(["simulate", "t.yaml"]))
    got = vars(cli.build_parser().parse_args(["simulate", "t.yaml"]))
    for flag in ("qps", "connections", "duration", "load_kind",
                 "max_requests", "service_time", "seed"):
        assert got[flag] == want[flag], flag
    assert got["device"] is None


def test_cli_refuses_qps_max():
    """``--qps max`` was refused before the saturated closed loop was
    ported; it now runs Fortio's saturated closed loop and prints its
    document (requests rounded up to whole blocks of 64 connections, as
    the reference's run_summary does)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["simulate", str(CANONICAL), "--qps", "max",
                       "--max-requests", "2000", "--device", "cpu"])
    assert rc == 0
    doc = json.loads(buf.getvalue())
    assert doc["RequestedQPS"] == "max"
    assert doc["Labels"] == "canonical_none_maxqps_64c"
    assert doc["DurationHistogram"]["Count"] == 2 * (2000 // 64 * 64)
    assert doc["ActualQPS"] > 1000.0


def test_cli_check_defaults_match_reference():
    """The check command's flags and defaults are the JAX command's,
    plus ``--device``."""
    from isotope_tpu.commands import simulate_cmd
    import argparse

    ref = argparse.ArgumentParser()
    simulate_cmd.register(ref.add_subparsers())
    want = vars(ref.parse_args(["check", "t.yaml"]))
    got = vars(cli.build_parser().parse_args(["check", "t.yaml"]))
    for args in (want, got):
        args.pop("func")
        args.pop("command", None)
    assert got.pop("device") is None
    assert got == want


def test_module_entry_point_runs(tmp_path):
    """``python -m isotope_tpu_torch`` reaches the same CLI."""
    import subprocess

    out = subprocess.run(
        [sys.executable, "-m", "isotope_tpu_torch", "simulate", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


# -- simulate, number for number against the JAX command ---------------------

PROTECTED_TOPOLOGY = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 2
  script:
  - call: {service: worker, timeout: 2ms, retries: 2}
- name: worker
  numReplicas: 2
policies:
  defaults:
    retry_budget: {budget_percent: 25%}
  entry:
    lb: {policy: least_request, choices_d: 2}
  worker:
    breaker: {max_pending: 4}
    autoscaler: {min_replicas: 2, max_replicas: 6,
                 target_utilization: 50%, sync_period: 1s,
                 stabilization_window: 3s}
rollouts:
  worker:
    steps: [10%, 50%, 100%]
    bake: 1s
    gates: {min_samples: 20}
    canary: {error_rate: 30%}
"""

#: occupancy-derived entries of the timeline document: the float32
#: occupancy integrals over a window (and replicas), held to the
#: integrals' tolerance (test_torch_timeline.py) over the window
_OCCUPANCY_KEYS = {"utilization", "queue_depth", "in_flight",
                   "peak_utilization"}
#: the convoy detector's shares and correlation are quotients of those
#: integrals, window by window: the series they come from are held in
#: test_torch_timeline.py, and here only the verdict's counts and flag;
#: likewise the argmax of a utilization series (two windows within the
#: tolerance may swap; its value, peak_utilization, is compared)
_CONVOY_FLOATS = {"entry_wait_share", "leaf_busy_share", "correlation",
                  "peak_window"}


def occupancy_atol(doc):
    """The integrals' tolerance over one window, for a document."""
    horizon = doc["num_windows"] * doc["window_s"]
    events = max([s["requests"] for s in doc["services"].values()] + [1])
    return 64 * float(np.spacing(np.float32(horizon * events))) / (
        doc["window_s"]
    )


def assert_doc_close(got, want, path="", occ_atol=None):
    """Documents equal: keys, strings, booleans and integers exactly;
    floats at rtol 1e-5 / atol 1e-9 (the engine's), occupancy-derived
    entries at ``occ_atol``; ``StartTime`` (the wall clock) and the
    convoy quotients skipped."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            if k == "StartTime" or k in _CONVOY_FLOATS:
                continue
            atol = occ_atol if k in _OCCUPANCY_KEYS else None
            assert_doc_close(got[k], want[k], f"{path}.{k}",
                             occ_atol if atol is None else atol)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_doc_close(g, w, f"{path}[{i}]", occ_atol)
        return
    if isinstance(want, float) and not isinstance(want, bool):
        if occ_atol is not None and path.split(".")[-1].split("[")[0] in (
            _OCCUPANCY_KEYS
        ):
            assert abs(got - want) <= occ_atol, (path, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                       err_msg=path)
        return
    assert got == want, (path, got, want)


def _prom_values(text):
    """{series line without its value: value} of an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        head, _, rest = line.rpartition(" ")
        if "{" in line and line.count(" ") >= 2 and rest.isdigit():
            head, _, value = head.rpartition(" ")
            out[f"{head} @{rest}"] = float(value)
        else:
            out[head] = float(rest)
    return out


def _simulate_both(tmp_path, monkeypatch, topo, flags, seed=0):
    """The JAX ``simulate`` (``run_experiment``, run key
    ``fold_in(PRNGKey(seed), 0)``, on one device: ``--mesh 1x1``, as
    the tests' virtual CPU mesh would shard it) and the port's (its
    ``run_experiment``, case 0 on ``RootedSource(TorchDraws(seed),
    0)``) on the JAX run's draws (``TorchDraws(seed)`` replaced by
    ``JaxReplayDraws(PRNGKey(seed))``); returns ``{name: (port output,
    JAX output)}`` for stdout and every file flag."""
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
            str(d / a[5:]) if isinstance(a, str) and a.startswith("FILE:")
            else a for a in flags
        ] + ["--seed", str(seed)]
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            if side == "port":
                rc = cli.main(argv + ["--device", "cpu"])
            else:
                rc = jax_cli.main(argv + ["--mesh", "1x1"])
        assert rc == 0, err.getvalue()
        out[side] = {"stdout": json.loads(buf.getvalue()),
                     "stderr": err.getvalue()}
        for f in d.iterdir():
            text = f.read_text()
            out[side][f.name] = (
                json.loads(text) if f.suffix == ".json" else text
            )
    return {k: (out["port"][k], out["jax"][k]) for k in out["jax"]}


def test_cli_simulate_flags_match_reference_number_for_number(tmp_path,
                                                             monkeypatch):
    """``--cpu-time``, ``--service-time-param``, ``--entry``,
    ``--labels``, ``--prometheus`` and the ``--timeline`` pass with its
    documents, against the JAX command on the same draws."""
    got = _simulate_both(tmp_path, monkeypatch, CANONICAL, [
        "--qps", "1000", "--duration", "1s", "--load-kind", "open",
        "--cpu-time", "100us", "--service-time", "lognormal",
        "--service-time-param", "0.5", "--entry", "a", "--labels", "lbl",
        "--prometheus", "FILE:run.prom", "--timeline", "250ms",
        "--timeline-out", "FILE:tl.json",
        "--timeline-prometheus", "FILE:tl.prom",
    ])
    doc, want = got["stdout"]
    assert doc["Labels"] == "canonical_none_1000qps_64c_lbl"
    assert_doc_close(doc, want)
    tl, tl_want = got["tl.json"]
    assert tl["num_windows"] == 4
    assert_doc_close(tl, tl_want, occ_atol=occupancy_atol(tl_want))
    for name in ("run.prom", "tl.prom"):
        a, b = (_prom_values(t) for t in got[name])
        assert set(a) == set(b), name
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=2e-3,
                                       err_msg=f"{name} {k}")
    assert "timeline:" in got["stderr"][0]


def test_cli_protected_run_matches_reference_number_for_number(tmp_path,
                                                               monkeypatch):
    """``--policies --rollouts`` (one composed carry) with
    ``--policies-out``, ``--rollouts-out``, ``--timeline-out`` and
    ``--lb-out`` (the per-window split over the policy pools), against
    the JAX command on the same draws."""
    topo = tmp_path / "prot.yaml"
    topo.write_text(PROTECTED_TOPOLOGY)
    got = _simulate_both(tmp_path, monkeypatch, topo, [
        "--qps", "2000", "--duration", "8s", "--load-kind", "open",
        "--policies", "--rollouts", "--policies-out", "FILE:pol.json",
        "--rollouts-out", "FILE:roll.json", "--timeline-out",
        "FILE:tl.json", "--lb-out", "FILE:lb.json",
    ])
    assert_doc_close(*got["stdout"])
    for name in ("pol.json", "roll.json", "lb.json"):
        assert_doc_close(*got[name], path=name)
    assert_doc_close(*got["tl.json"],
                     occ_atol=occupancy_atol(got["tl.json"][1]))
    roll = got["roll.json"][0]["services"]["worker"]
    assert roll["state"] == "failed" and roll["rollbacks"] >= 1
    assert got["pol.json"][0]["windows_done"] >= 7
    for table in ("policies:", "rollouts:", "lb:", "timeline:"):
        assert table in got["stderr"][0], table


@pytest.mark.parametrize("flags,exc,match", [
    (["--mesh", "auto"], NotImplementedError,
     r"--mesh auto .*item 11b\.5"),
    (["--overlap", "--mesh", "2x1"], ValueError,
     "mesh: mesh data=2,svc=1 needs 2 devices, have 1"),
], ids=["--mesh", "--overlap"])
def test_cli_refused_flags_name_their_item(flags, exc, match, monkeypatch,
                                           capsys):
    """The mesh flags parse; what the port cannot serve is refused
    before anything simulates: ``--mesh auto`` (the layout search)
    names its ROADMAP item, and a mesh larger than the world (one
    process here) exits 1 with the reference's key-pathed message."""
    import re

    import isotope_tpu_torch.runner.run as run_mod

    def no_sim(*args, **kwargs):
        raise AssertionError("simulated before refusing")

    monkeypatch.setattr(run_mod, "_execute", no_sim)
    argv = ["simulate", str(CANONICAL), "--device", "cpu"] + flags
    if exc is ValueError:
        assert cli.main(argv) == 1
        assert re.search(match, capsys.readouterr().err)
    else:
        with pytest.raises(exc, match=match):
            cli.main(argv)


def test_cli_accepts_every_flag_of_the_jax_command():
    """Every flag of the JAX ``simulate`` parses in the port's parser:
    it runs, or raises naming its ROADMAP item, never an argparse
    error."""
    import argparse

    from isotope_tpu.commands import simulate_cmd

    ref = argparse.ArgumentParser()
    simulate_cmd.register(ref.add_subparsers())
    sim_ref = ref._subparsers._group_actions[0].choices["simulate"]
    port = cli.build_parser()._subparsers._group_actions[0].choices[
        "simulate"
    ]
    want = {o for a in sim_ref._actions for o in a.option_strings}
    have = {o for a in port._actions for o in a.option_strings}
    assert want - have == set()
    assert have - want == {"--device"}


def test_cli_compile_cache_is_accepted_and_ignored():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(["simulate", str(CANONICAL), "--qps", "1000",
                       "--duration", "1s", "--load-kind", "open",
                       "--compile-cache", "/nonexistent", "--device",
                       "cpu"])
    assert rc == 0 and json.loads(out.getvalue())["Labels"]
    assert "XLA" in err.getvalue()


@pytest.mark.parametrize("timeline", [None, 1.0, 0.25])
@pytest.mark.parametrize("qps,duration", [(1000.0, 240.0), (1e4, 30.0),
                                          (None, 2.0), (50.0, 0.004)])
def test_protected_window_block_matches_reference(timeline, qps, duration):
    """``simulate``'s window and block sizing of the protected runs is
    the reference's ``_protected_window_block``."""
    from types import SimpleNamespace

    from isotope_tpu.runner.run import _protected_window_block
    from isotope_tpu_torch.runner.run import protected_window_block

    jc = jax_compile_graph(JaxGraph.from_yaml_file(str(CANONICAL)))
    js = JaxSimulator(jc)
    ps = Simulator(port_compiled(jc), device="cpu")
    kw = dict(kind="closed", qps=qps, connections=64, duration_s=duration)
    for block in (65_536, 1_000, 100):
        want = _protected_window_block(
            js, JaxLoad(**kw), block, SimpleNamespace(timeline_window_s=10.0),
            timeline,
        )
        got = protected_window_block(ps, LoadModel(**kw), block, 10.0,
                                     timeline)
        assert got == want


def _ensemble_line(stderr):
    return [ln for ln in stderr.splitlines() if ln.startswith("ensemble:")]


def test_cli_ensemble_matches_reference_number_for_number(tmp_path,
                                                          monkeypatch):
    """``--ensemble 4 --ensemble-jitter --ensemble-slo --ensemble-out``:
    the pooled document, the ``ensemble:`` line and the
    ``isotope-ensemble/v2`` document against the JAX command on the same
    draws (members ``fold_in(run_key, seed)``)."""
    got = _simulate_both(tmp_path, monkeypatch, CANONICAL, [
        "--qps", "1000", "--duration", "1s", "--load-kind", "open",
        "--ensemble", "4", "--ensemble-jitter",
        "qps=0.1,cpu=0.05,error=0.2", "--ensemble-slo", "5ms",
        "--ensemble-out", "FILE:ens.json",
    ])
    assert_doc_close(*got["stdout"])
    doc, want = got["ens.json"]
    assert doc["schema"] == "isotope-ensemble/v2" and doc["members"] == 4
    assert_doc_close(doc, want, path="ens.json")
    port_err, jax_err = got["stderr"]
    assert len(_ensemble_line(port_err)) == 1
    assert _ensemble_line(port_err) == _ensemble_line(jax_err)


def test_cli_observed_ensemble_matches_reference(tmp_path, monkeypatch):
    """``--ensemble`` with ``--attribution --timeline``: every member is
    attributed and recorded, and the worst member's blame and timeline
    documents (stamped with its member and seed) are the JAX
    command's."""
    got = _simulate_both(tmp_path, monkeypatch, CANONICAL, [
        "--qps", "1000", "--duration", "1s", "--load-kind", "open",
        "--ensemble", "3", "--attribution", "--timeline", "250ms",
        "--blame-out", "FILE:blame.json", "--timeline-out", "FILE:tl.json",
        "--ensemble-out", "FILE:ens.json",
    ])
    assert_doc_close(*got["stdout"])
    assert_doc_close(*got["ens.json"], path="ens.json")
    tl, tl_want = got["tl.json"]
    assert tl["worst_member"] is True
    assert (tl["member"], tl["member_seed"]) == \
        (tl_want["member"], tl_want["member_seed"])
    assert_doc_close(tl, tl_want, occ_atol=occupancy_atol(tl_want))
    blame, blame_want = got["blame.json"]
    assert blame["member"] == blame_want["member"]
    assert blame["fleet_members"] == 3


def test_cli_protected_ensemble_matches_reference(tmp_path, monkeypatch):
    """``--policies --rollouts --ensemble 3 --ensemble-chaos-jitter``:
    a protected fleet whose member 0 rides the run key; the worst
    member's documents and the fleet document against the JAX
    command's (``simulate`` has no chaos schedule: the jitter is
    checked and has nothing to jitter, in both)."""
    topo = tmp_path / "prot.yaml"
    topo.write_text(PROTECTED_TOPOLOGY)
    got = _simulate_both(tmp_path, monkeypatch, topo, [
        "--qps", "2000", "--duration", "4s", "--load-kind", "open",
        "--policies", "--rollouts", "--ensemble", "3",
        "--ensemble-chaos-jitter", "time=0.2,magnitude=0.5,seed=3",
        "--ensemble-slo", "20ms", "--ensemble-out", "FILE:ens.json",
        "--policies-out", "FILE:pol.json", "--rollouts-out",
        "FILE:roll.json",
    ])
    assert_doc_close(*got["stdout"])
    doc, want = got["ens.json"]
    assert doc["protected"] is True
    assert_doc_close(doc, want, path="ens.json")
    for name in ("pol.json", "roll.json"):
        assert_doc_close(*got[name], path=name)
    assert got["pol.json"][0]["member_key"] == \
        got["pol.json"][1]["member_key"]


def test_cli_refuses_a_bad_chaos_jitter_like_reference(capsys):
    assert cli.main(["simulate", str(CANONICAL), "--device", "cpu",
                     "--ensemble", "2", "--ensemble-chaos-jitter",
                     "tim=1"]) == 1
    assert "error: unknown chaos jitter key" in capsys.readouterr().err
