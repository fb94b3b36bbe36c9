"""The port's experiment runner (``runner/run.py``) against the JAX
package's ``run_experiment``, and its checkpoint and resume.

Both sweeps run the same TOML grid on the same draws: the JAX one on one
device (``mesh_spec="1x1"``), the port's on the CPU with
``TorchDraws(seed)`` replaced by ``JaxReplayDraws(PRNGKey(seed))``, so
its case ``i`` (``RootedSource(TorchDraws(seed), i)``) replays the
reference's ``fold_in(PRNGKey(seed), i)``.  Tolerances: labels, CSV
columns, flat markers, checkpoint record keys and every string, boolean
and count are exactly equal; floats within ``assert_doc_close``'s rtol
1e-5 / atol 1e-9 s (occupancy-derived timeline entries within the
recorder's integral band); an integer the flat row takes as the floor
of a float (microsecond percentiles, min, max, rounded qps) within one
unit plus rtol 1e-5, since its float is held to rtol 1e-5.  The
Prometheus expositions within rtol 1e-5 / atol 1e-9.

The resume tests mirror ``tests/test_checkpoint.py`` and
``tests/test_runner.py`` on the port alone.
"""
import dataclasses
import io
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

import isotope_tpu_torch.sim
from isotope_tpu import cli as jax_cli
from isotope_tpu.runner import load_toml as jax_load_toml
from isotope_tpu.runner import run_experiment as jax_run_experiment
from isotope_tpu_torch import cli, telemetry
from isotope_tpu_torch.native import census as census_mod
from isotope_tpu_torch.resilience import ResiliencePolicy, faults
from isotope_tpu_torch.runner.config import load_toml
from isotope_tpu_torch.runner.run import run_experiment
from test_torch_replay import JaxReplayDraws
from test_torch_summary import (
    PROTECTED_TOPOLOGY,
    _prom_values,
    assert_doc_close,
    occupancy_atol,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CANONICAL = ROOT / "examples" / "topologies" / "canonical.yaml"


def grid(tmp_path, topo=CANONICAL, qps=(200, 400), conns=(8,),
         kind="open", envs=("NONE", "ISTIO"), duration="60s", n=3000,
         seed=11, sim_extra=""):
    cfg = tmp_path / "exp.toml"
    cfg.write_text(f"""
topology_paths = ["{topo}"]
environments = {json.dumps(list(envs))}

[client]
qps = {json.dumps(list(qps))}
num_concurrent_connections = {json.dumps(list(conns))}
duration = "{duration}"
load_kind = "{kind}"

[sim]
num_requests = {n}
seed = {seed}
{sim_extra}
""")
    return cfg


@pytest.fixture(autouse=True)
def clean_state():
    faults.clear()
    telemetry.reset()
    yield
    faults.clear()
    telemetry.reset()
    telemetry.disable()


@pytest.fixture
def replay(monkeypatch):
    """The port's ``TorchDraws(seed)`` replays ``PRNGKey(seed)``."""
    monkeypatch.setattr(
        isotope_tpu_torch.sim, "TorchDraws",
        lambda seed, device: JaxReplayDraws(jax.random.PRNGKey(seed)),
    )


def _sweep_pair(tmp_path, cfg, **kw):
    jc = dataclasses.replace(jax_load_toml(cfg), mesh_spec="1x1")
    jr = jax_run_experiment(jc, out_dir=str(tmp_path / "jax"), **kw)
    pr = run_experiment(load_toml(cfg), out_dir=str(tmp_path / "port"),
                        device="cpu", **kw)
    return pr, jr


def flat_close(got, want, what=""):
    """Flat rows: keys, strings and booleans equal; ``StartTime`` (the
    wall clock) skipped; integers within one unit plus rtol 1e-5 (a
    floor of a float held at rtol 1e-5), floats at rtol 1e-5 / atol
    1e-9."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        if k == "StartTime":
            continue
        if isinstance(w, bool) or isinstance(w, str) or w is None:
            assert g == w, (what, k, g, w)
        elif isinstance(w, int):
            assert isinstance(g, int) and abs(g - w) <= 1 + 1e-5 * abs(w), (
                what, k, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9,
                                       err_msg=f"{what} {k}")


def doc_close(got, want, path="", occ_atol=None):
    """``assert_doc_close``, with a Fortio document's ``ActualDuration``
    (integer nanoseconds of the float32 run end) at rtol 1e-5."""
    if isinstance(want, dict) and "ActualDuration" in want:
        got, want = dict(got), dict(want)
        np.testing.assert_allclose(got.pop("ActualDuration"),
                                   want.pop("ActualDuration"), rtol=1e-5,
                                   err_msg=f"{path}.ActualDuration")
    assert_doc_close(got, want, path, occ_atol=occ_atol)


def _csv_rows(path):
    lines = path.read_text().splitlines()
    keys = lines[0].split(",")
    rows = []
    for line in lines[1:]:
        row = {}
        for k, v in zip(keys, line.split(",")):
            try:
                row[k] = int(v)
            except ValueError:
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v
        rows.append(row)
    return keys, rows


def assert_sweep_dirs_close(port_dir: pathlib.Path, jax_dir: pathlib.Path):
    """Every artifact of the two sweeps: the same file names; the CSV's
    columns and labels equal, rows close; results.jsonl and each
    checkpoint record's flat row close with equal keys; every JSON
    document by ``assert_doc_close``; every exposition's values."""
    names = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    keys, want = _csv_rows(jax_dir / "benchmark.csv")
    got_keys, got = _csv_rows(port_dir / "benchmark.csv")
    assert got_keys == keys
    assert [r["Labels"] for r in got] == [r["Labels"] for r in want]
    for g, w in zip(got, want):
        flat_close(g, w, w["Labels"])
    for name in ("results.jsonl", "checkpoint.jsonl"):
        got_l = (port_dir / name).read_text().splitlines()
        want_l = (jax_dir / name).read_text().splitlines()
        assert len(got_l) == len(want_l), name
        if name == "checkpoint.jsonl":
            # the headers bind each package's own config
            got_l, want_l = got_l[1:], want_l[1:]
        for g, w in zip(got_l, want_l):
            g, w = json.loads(g), json.loads(w)
            if name == "results.jsonl":
                flat_close(g, w, name)
                continue
            assert sorted(g) == sorted(w) and g["label"] == w["label"]
            if "flat" in w:
                flat_close(g["flat"], w["flat"], g["label"])
                assert_doc_close(g["window"], w["window"], "window")
                doc_close(g["fortio_json"], w["fortio_json"], g["label"])
    for name in names:
        if name.endswith(".prom"):
            a = _prom_values((port_dir / name).read_text())
            b = _prom_values((jax_dir / name).read_text())
            assert set(a) == set(b), name
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           atol=1e-9,
                                           err_msg=f"{name} {k}")
        elif name.endswith(".json"):
            g = json.loads((port_dir / name).read_text())
            w = json.loads((jax_dir / name).read_text())
            occ = occupancy_atol(w) if name.endswith(".timeline.json") \
                else None
            doc_close(g, w, name, occ_atol=occ)


GRIDS = {
    # the reference's checkpoint grid: 2 environments x 2 open loads
    "open": dict(),
    # a paced closed loop over two connection counts
    "closed": dict(kind="closed", qps=(500,), conns=(4, 8), n=1000,
                   envs=("NONE",)),
    # a fleet-served grid: every cell capped at the same request count,
    # so each environment's cells collapse into one dispatch
    "fleet": dict(qps=(200, 400, 800), n=2000, envs=("NONE",),
                  sim_extra='ensemble = 3\nensemble_jitter = '
                            '"qps=0.1,cpu=0.05,error=0.2"\n'
                            'ensemble_slo = "5ms"'),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_sweep_matches_reference(tmp_path, replay, name):
    pr, jr = _sweep_pair(tmp_path, grid(tmp_path, **GRIDS[name]))
    assert [r.label for r in pr] == [r.label for r in jr]
    assert not any(r.failed for r in pr)
    for p, j in zip(pr, jr):
        flat_close(p.flat, j.flat, p.label)
        assert p.degraded_to == j.degraded_to is None
    assert_sweep_dirs_close(tmp_path / "port", tmp_path / "jax")
    if name == "fleet":
        assert all(r.flat["_ensemble"] == 3 for r in pr)


def test_protected_sweep_matches_reference(tmp_path, replay):
    """``--policies --rollouts`` (one composed carry, an active lb law):
    the protected case's documents and markers against the JAX sweep."""
    topo = tmp_path / "prot.yaml"
    topo.write_text(PROTECTED_TOPOLOGY)
    cfg = grid(tmp_path, topo=topo, qps=(2000,), conns=(64,),
               duration="8s", envs=("NONE",),
               sim_extra="policies = true\nrollouts = true")
    pr, jr = _sweep_pair(tmp_path, cfg)
    (p,), (j,) = pr, jr
    assert p.flat["_policies"] and p.flat["_rollout"] and p.flat["_lb"]
    flat_close(p.flat, j.flat)
    assert_sweep_dirs_close(tmp_path / "port", tmp_path / "jax")


def test_sweep_timeline_pass_matches_reference(tmp_path, replay):
    cfg = grid(tmp_path, qps=(1000,), duration="2s", envs=("NONE",),
               n=2000)
    jc = dataclasses.replace(jax_load_toml(cfg), mesh_spec="1x1",
                             timeline=True)
    jax_run_experiment(jc, out_dir=str(tmp_path / "jax"), timeline=0.5)
    pc = dataclasses.replace(load_toml(cfg), timeline=True)
    (r,) = run_experiment(pc, out_dir=str(tmp_path / "port"),
                          timeline=0.5, device="cpu")
    assert r.timeline["num_windows"] == 4
    assert_sweep_dirs_close(tmp_path / "port", tmp_path / "jax")


def test_cli_simulate_flat_matches_reference(tmp_path, replay):
    """``simulate --flat``: the flattened single-line record of the JAX
    command, through ``cli.main`` on both sides."""
    argv = ["simulate", str(CANONICAL), "--qps", "200", "--duration",
            "100s", "--load-kind", "open", "--max-requests", "2000",
            "--flat"]
    out = {}
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, ["--mesh", "1x1"])):
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            assert main(argv + extra + ["--prometheus",
                                        str(tmp_path / f"{side}.prom")]) == 0
        text = buf.getvalue()
        assert text.count("\n") == 1  # one line
        out[side] = json.loads(text)
    flat_close(out["port"], out["jax"])
    assert out["port"]["RequestedQPS"] == 200
    # the five service series + the two sim-side resource series
    assert (tmp_path / "port.prom").read_text().count("# TYPE") == 7


def test_cli_sweep_matches_reference(tmp_path, replay):
    cfg = grid(tmp_path, qps=(300,), n=1500)
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, ["--mesh", "1x1"])):
        err = io.StringIO()
        with redirect_stderr(err):
            assert main(["sweep", str(cfg), "-o", str(tmp_path / side)]
                        + extra) == 0
        assert "2 runs ->" in err.getvalue()
    assert_sweep_dirs_close(tmp_path / "port", tmp_path / "jax")


# -- checkpoint and resume (the port alone) -----------------------------------


class Kill(Exception):
    pass


def _csv_without_start(path):
    out = []
    for line in path.read_text().splitlines():
        cells = line.split(",")
        del cells[1]  # StartTime, the wall clock
        out.append(cells)
    return out


def test_kill_and_resume_identical_csv(tmp_path):
    cfg = load_toml(grid(tmp_path))
    run_experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    count = 0

    def killer(label):
        nonlocal count
        count += 1
        if count > 2:
            raise Kill(label)

    with pytest.raises(Kill):
        run_experiment(cfg, out_dir=str(tmp_path / "resumed"),
                       progress=killer, device="cpu")
    ckpt = (tmp_path / "resumed" / "checkpoint.jsonl").read_text()
    assert len(ckpt.splitlines()) == 1 + 2  # header + 2 completed runs
    ran = []
    results = run_experiment(cfg, out_dir=str(tmp_path / "resumed"),
                             progress=ran.append, device="cpu")
    assert len(ran) == 2 and len(results) == 4
    # the resumed cases draw from their own index: the same rows
    assert _csv_without_start(tmp_path / "resumed" / "benchmark.csv") == \
        _csv_without_start(tmp_path / "full" / "benchmark.csv")


def test_completed_sweep_replays_for_free(tmp_path):
    """A resumed complete sweep builds no Simulator and launches no
    census call; its CSV is byte-identical."""
    cfg = load_toml(grid(tmp_path))
    out = tmp_path / "out"
    run_experiment(cfg, out_dir=str(out), device="cpu")
    csv = (out / "benchmark.csv").read_bytes()
    built = telemetry.counter_get("simulators_built")
    launches = census_mod.census.launches
    ran = []
    results = run_experiment(cfg, out_dir=str(out), progress=ran.append,
                             device="cpu")
    assert ran == [] and len(results) == 4
    assert telemetry.counter_get("simulators_built") == built
    assert census_mod.census.launches == launches
    assert (out / "benchmark.csv").read_bytes() == csv
    assert all(r.prometheus_text for r in results)


@pytest.mark.parametrize("edit", ["config", "topology"])
def test_edit_invalidates_checkpoint(tmp_path, edit):
    topo = tmp_path / "t.yaml"
    topo.write_text(CANONICAL.read_text())
    cfg = load_toml(grid(tmp_path, topo=topo))
    out = tmp_path / "out"
    run_experiment(cfg, out_dir=str(out), device="cpu")
    if edit == "config":
        cfg = dataclasses.replace(cfg, seed=12)
    else:
        # resuming stale results would silently simulate the old graph
        topo.write_text(CANONICAL.read_text() + "- name: extra\n")
    ran = []
    run_experiment(cfg, out_dir=str(out), progress=ran.append, device="cpu")
    assert len(ran) == 4


@pytest.mark.parametrize("where", ["tail", "middle"])
def test_torn_checkpoint_record_reruns_only_its_case(tmp_path, where):
    """A truncated tail (a kill mid-append) is tolerated, and a corrupt
    record in the middle is quarantined: only that record's case
    re-executes."""
    cfg = load_toml(grid(tmp_path))
    out = tmp_path / "out"
    run_experiment(cfg, out_dir=str(out), device="cpu")
    ckpt = out / "checkpoint.jsonl"
    lines = ckpt.read_text().splitlines()
    assert len(lines) == 5
    i = 4 if where == "tail" else 2
    lines[i] = lines[i][: len(lines[i]) // 2]
    ckpt.write_text("\n".join(lines) + ("" if where == "tail" else "\n"))
    ran = []
    results = run_experiment(cfg, out_dir=str(out), progress=ran.append,
                             device="cpu")
    assert len(ran) == 1 and len(results) == 4
    assert not any(r.failed for r in results)
    if where == "middle":
        assert telemetry.counter_get("checkpoint_quarantined_records") == 1


def test_failed_case_recorded_and_sweep_continues(tmp_path):
    """An unrecoverable OOM (degradation off) fails ONE case; the sweep
    records it, completes the other three, and a resume retries exactly
    it, to the uninterrupted sweep's CSV."""
    cfg = load_toml(grid(tmp_path))
    out = tmp_path / "out"
    strict = ResiliencePolicy(max_retries=0, degrade=False,
                              sleep=lambda s: None)
    faults.install("oom:engine.run:1")
    results = run_experiment(cfg, out_dir=str(out), policy=strict,
                             device="cpu")
    faults.clear()
    assert [r.failed for r in results] == [True, False, False, False]
    recs = [json.loads(ln) for ln in
            (out / "checkpoint.jsonl").read_text().splitlines()[1:]]
    assert recs[0]["failed"] and "RESOURCE_EXHAUSTED" in recs[0]["error"]
    assert recs[0]["error_class"] == "resource_exhausted"
    assert len((out / "benchmark.csv").read_text().splitlines()) == 1 + 3
    run_experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    ran = []
    results = run_experiment(cfg, out_dir=str(out), progress=ran.append,
                             device="cpu")
    assert len(ran) == 1 and not any(r.failed for r in results)
    assert _csv_without_start(out / "benchmark.csv") == \
        _csv_without_start(tmp_path / "full" / "benchmark.csv")


def test_sticky_cuda_error_ends_the_sweep_and_resume_retries_it(
        tmp_path, monkeypatch):
    """A sticky CUDA error (the context is lost) fails its case once,
    unretried, records it, and ends the sweep; the same sweep in a
    fresh start retries that case and runs the rest, to the
    uninterrupted sweep's CSV."""
    from isotope_tpu_torch.sim.engine import Simulator

    cfg = load_toml(grid(tmp_path))
    out = tmp_path / "out"
    run_summary = Simulator.run_summary
    calls = {"n": 0}

    def lost_context(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return run_summary(self, *a, **kw)

    monkeypatch.setattr(Simulator, "run_summary", lost_context)
    ran = []
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_experiment(cfg, out_dir=str(out), progress=ran.append,
                       device="cpu")
    assert len(ran) == 2 and calls["n"] == 2
    assert telemetry.counter_get("retries_total") == 0.0
    recs = [json.loads(ln) for ln in
            (out / "checkpoint.jsonl").read_text().splitlines()[1:]]
    assert [r.get("failed", False) for r in recs] == [False, True]
    assert recs[1]["error_class"] == "deterministic"
    assert not (out / "benchmark.csv").exists()
    monkeypatch.setattr(Simulator, "run_summary", run_summary)
    ran = []
    results = run_experiment(cfg, out_dir=str(out), progress=ran.append,
                             device="cpu")
    assert ran == [recs[1]["label"]] + [r.label for r in results[2:]]
    assert not any(r.failed for r in results)
    run_experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    assert _csv_without_start(out / "benchmark.csv") == \
        _csv_without_start(tmp_path / "full" / "benchmark.csv")


def test_checkpoint_records_are_wellformed(tmp_path):
    out = tmp_path / "out"
    run_experiment(load_toml(grid(tmp_path)), out_dir=str(out),
                   device="cpu")
    lines = (out / "checkpoint.jsonl").read_text().splitlines()
    assert "config" in json.loads(lines[0])
    for line in lines[1:]:
        rec = json.loads(line)
        assert set(rec) == {"label", "topology", "environment", "flat",
                            "window", "fortio_json"}
        assert (out / f"{rec['label']}.prom").exists()
        assert (out / f"{rec['label']}.json").exists()


def test_fleet_grid_collapses_same_shape_cells(tmp_path, capsys):
    """Cells past the request cap share a fleet program: ONE dispatch
    serves them, and a collapsed cell's members equal its uncollapsed
    dispatch's (a cell's members draw from ``(index, seed)``): with the
    other cells restored from the checkpoint, the last one runs alone,
    to the same fleet bit for bit."""
    cfg = load_toml(grid(tmp_path, qps=(200, 400, 800), n=2000,
                         envs=("NONE",), sim_extra="ensemble = 2"))
    out = tmp_path / "out"
    results = run_experiment(cfg, out_dir=str(out), device="cpu")
    assert "collapsed 3 same-shape case(s) (6 members)" in \
        capsys.readouterr().err
    assert telemetry.counter_get("ensemble_group_dispatches") == 1
    assert telemetry.counter_get("ensemble_collapsed_cases") == 2
    ckpt = out / "checkpoint.jsonl"
    ckpt.write_text("\n".join(ckpt.read_text().splitlines()[:-1]) + "\n")
    ran = []
    alone = run_experiment(cfg, out_dir=str(out), progress=ran.append,
                           device="cpu")
    assert ran == [results[2].label]
    assert "collapsed" not in capsys.readouterr().err
    got = alone[2].ensemble_summary.summaries
    want = results[2].ensemble_summary.summaries
    for field in ("count", "error_count", "latency_sum", "latency_hist",
                  "win_latency_hist", "end_max"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    flat = dict(alone[2].flat, StartTime=results[2].flat["StartTime"])
    assert flat == results[2].flat


def test_unported_options_raise(tmp_path, monkeypatch, capsys):
    """A mesh the one-process world cannot hold raises the reference's
    key-pathed message before anything simulates; ``--mesh auto``
    (through ``$ISOTOPE_MESH``) resolves to 1x1 in the one-process
    world and prints its choice; auto, a 1x1 mesh and ``overlap`` run
    the plain path, row for row."""
    cfg = load_toml(grid(tmp_path, qps=(300,), n=500))
    out = tmp_path / "out"
    with pytest.raises(ValueError,
                       match="mesh: mesh data=2,svc=1 needs 2 devices"):
        run_experiment(dataclasses.replace(cfg, mesh_spec="2x1"),
                       out_dir=str(out), device="cpu")
    assert not out.exists()
    monkeypatch.setenv("ISOTOPE_MESH", "auto")
    capsys.readouterr()
    auto = run_experiment(cfg, device="cpu")
    assert (f"mesh auto: {cfg.topology_paths[0]} -> data=1,svc=1 (score "
            "0s/merge)") in capsys.readouterr().err
    monkeypatch.setenv("ISOTOPE_MESH", "1x1")
    plain = run_experiment(cfg, device="cpu")
    over = run_experiment(dataclasses.replace(cfg, overlap=True),
                          device="cpu")
    for a, b, c in zip(plain, over, auto):
        assert "_mesh_layout" not in a.flat
        assert dict(a.flat, StartTime=0) == dict(b.flat, StartTime=0)
        assert dict(a.flat, StartTime=0) == dict(c.flat, StartTime=0)


def test_duplicate_labels_rejected(tmp_path):
    cfg = load_toml(grid(tmp_path))
    dup = dataclasses.replace(cfg, topology_paths=(str(CANONICAL),) * 2)
    with pytest.raises(ValueError, match="duplicate run label"):
        run_experiment(dup, device="cpu")


def test_sweep_profile_writes_a_torch_trace_per_case(tmp_path):
    cfg = load_toml(grid(tmp_path, qps=(300,), n=500))
    prof = tmp_path / "prof"
    run_experiment(cfg, profile_dir=str(prof), device="cpu")
    runs = sorted(p.name for p in prof.iterdir())
    assert runs == ["canonical_istio_300qps_8c", "canonical_none_300qps_8c"]
    for r in runs:
        assert json.loads((prof / r / "trace.json").read_text())[
            "traceEvents"]


def test_export_needs_an_out_dir_and_writes_its_datafile(tmp_path):
    cfg = load_toml(grid(tmp_path, qps=(300,), n=500))
    with pytest.raises(ValueError, match="require out_dir"):
        run_experiment(cfg, export=["bigquery:p.d.t"], device="cpu")
    out = tmp_path / "out"
    run_experiment(cfg, out_dir=str(out), export=["bigquery:p.d.t"],
                   device="cpu")
    lines = (out / "bq_rows.json").read_text().splitlines()
    assert len(lines) == 2 and "DurationHistogram" in json.loads(lines[0])
    assert "bq insert p.d.t bq_rows.json" in (out / "bq_insert.sh").read_text()


@pytest.mark.parametrize("command", ["sweep", "suite", "report",
                                     "telemetry"])
def test_cli_accepts_every_flag_of_the_jax_command(command):
    """Every flag of the JAX command parses in the port's parser (it
    runs, or raises naming its ROADMAP item); the port adds
    ``--device`` to the run-executing ones."""
    import argparse

    from isotope_tpu.commands import (
        report_cmd,
        simulate_cmd,
        suite_cmd,
        telemetry_cmd,
    )

    ref = argparse.ArgumentParser()
    sub = ref.add_subparsers()
    for mod in (simulate_cmd, suite_cmd, report_cmd, telemetry_cmd):
        mod.register(sub)
    want = ref._subparsers._group_actions[0].choices[command]
    have = cli.build_parser()._subparsers._group_actions[0].choices[command]
    want = {o for a in want._actions for o in a.option_strings}
    have = {o for a in have._actions for o in a.option_strings}
    assert want - have == set()
    assert have - want == (set() if command == "report" else {"--device"})


def test_cli_sweep_refuses_the_unported_flags(tmp_path, monkeypatch,
                                              capsys):
    """Every flag is ported; ``sweep --mesh auto`` on a world whose
    devices do not divide over its hosts (5 ranks, 2 a host, as a
    launcher would announce them) exits 1 with the key-pathed config
    error before anything simulates or initializes a world."""
    import isotope_tpu_torch.runner.run as run_mod

    def no_sim(*args, **kwargs):
        raise AssertionError("simulated before refusing")

    monkeypatch.setattr(run_mod, "_execute", no_sim)
    monkeypatch.setenv("WORLD_SIZE", "5")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    cfg = grid(tmp_path)
    assert cli.main(["sweep", str(cfg), "--mesh", "auto",
                     "--device", "cpu"]) == 1
    assert ("mesh: 5 devices do not divide over 2 hosts"
            in capsys.readouterr().err)
