"""The port's ``vet`` (``analysis/vet.py``, ``commands/vet_cmd.py``) and
its ``--vet`` gate (``runner/run.py``) against the JAX package's.

The reference's audits walk ``jax.core.Literal`` / ``ClosedJaxpr`` /
``Jaxpr``, which jax 0.9 moved to ``jax.extend.core`` (and its ``f64``
injection enters ``jax.experimental.enable_x64``, now
``jax.enable_x64(True)``); its own ``tests/test_vet.py`` fails on them.
:func:`jax_core_alias` puts the names back for the length of ONE test
(``monkeypatch``, never the module or ``conftest.py``: a leaked alias
would make the reference's own tests pass or fail by which worker ran
what), so the reference runs live beside the port.  Nothing under ``isotope_tpu/`` changes.

Findings are compared as (rule, severity, path); the op audit's and the
gradient audit's sites are aten names in the port and jaxpr paths in the
reference, so for their site-bearing rules (VET-J00x, VET-G001 with a
kill, VET-G003) the rule and the count are compared.  The port's pilot
runs on the CPU here (``device="cpu"``).
"""
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout
import io

import pytest
import yaml

from isotope_tpu import cli as jax_cli
from isotope_tpu.analysis import vet as jax_vet
from isotope_tpu.sim.config import LoadModel as JaxLoad
from isotope_tpu_torch import cli, telemetry
from isotope_tpu_torch.analysis import (
    RULES,
    Report,
    VetError,
    suppression_patterns,
    topo_lint,
    vet_config_path,
    vet_simulator,
    vet_topology_path,
)
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.runner.config import (
    DEFAULT_ENVIRONMENTS,
    ExperimentConfig,
    load_toml,
)
from isotope_tpu_torch.runner.run import run_experiment
from isotope_tpu_torch.sim.config import LoadModel
from isotope_tpu_torch.sim.engine import Simulator

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPEN = dict(kind="open", qps=100.0)

SHIPPED = [
    "examples/topologies/canonical.yaml",
    "examples/topologies/chain-3-services.yaml",
    "examples/topologies/tree-13-services.yaml",
    "examples/topologies/realistic-star-50.yaml",
    "examples/topologies/realistic-auxiliary-services-50.yaml",
    "examples/topologies/two-cluster-canonical.yaml",
    "examples/topologies/canonical-errors.yaml",
]

CHAIN = {
    "services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b"},
    ]
}

#: the defective fixtures of the reference's tests/test_vet.py
DEFECTS = {
    "unreachable": {"services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b"},
        {"name": "orphan"},
    ]},
    "cycle": {"services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b", "script": [{"call": "a"}]},
    ]},
    "bounds": {"services": [
        {"name": "a", "isEntrypoint": True, "numReplicas": 0,
         "errorRate": 1.0},
    ]},
    "no-entrypoint": {"services": [{"name": "a"}]},
    "dead-capacity": {"services": [
        {"name": "a", "isEntrypoint": True},
        {"name": "dead"},
    ]},
    "error-rate-one": {"services": [
        {"name": "a", "isEntrypoint": True, "errorRate": 1.0},
    ]},
}

#: sites differ by design (aten names against jaxpr paths)
_SITE_RULES = ("VET-J001", "VET-J002", "VET-J003", "VET-G003")


@pytest.fixture
def jax_core_alias(monkeypatch):
    """The three names the reference's audits read from ``jax.core``,
    aliased to ``jax.extend.core``, and ``enable_x64``, for this test
    only."""
    import jax
    import jax.extend.core as jec

    for name in ("Literal", "ClosedJaxpr", "Jaxpr"):
        monkeypatch.setattr(jax.core, name, getattr(jec, name),
                            raising=False)
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    monkeypatch.delenv("ISOTOPE_VET_INJECT", raising=False)
    monkeypatch.delenv("ISOTOPE_VET_DEVICE_BYTES", raising=False)
    monkeypatch.delenv("ISOTOPE_VET_SUPPRESS", raising=False)
    monkeypatch.delenv("ISOTOPE_VET", raising=False)


def finding_keys(findings):
    """(rule, severity, path) of each finding, the path dropped where
    it is an op or jaxpr site; sorted."""
    out = []
    for f in findings:
        site = f.rule in _SITE_RULES or (
            f.rule == "VET-G001" and "first kill" in f.message
        )
        out.append((f.rule, f.severity, None if site else f.path))
    return sorted(out, key=lambda k: (k[0], k[1], k[2] or ""))


def write_topo(tmp_path, doc, name="topo.yaml"):
    p = tmp_path / name
    p.write_text(yaml.safe_dump(doc))
    return str(p)


def vet_both(path, grad=False, **load):
    load = load or OPEN
    want = jax_vet.vet_topology_path(path, load=JaxLoad(**load), grad=grad)
    got = vet_topology_path(path, load=LoadModel(**load), grad=grad,
                            device="cpu")
    return got, want


# -- findings against the reference ------------------------------------------


@pytest.mark.parametrize("example", SHIPPED)
def test_shipped_examples_vet_like_reference(example, jax_core_alias):
    """The reference's shipped examples vet clean in both packages, with
    the same findings (the port's float64 clocks are allowlisted, not
    dropped: ``test_torch_op_audit.py``)."""
    got, want = vet_both(str(ROOT / example))
    assert got.errors == [], [f.render() for f in got.errors]
    assert finding_keys(got.findings) == finding_keys(want.findings)


@pytest.mark.parametrize("name", sorted(DEFECTS))
def test_defective_fixtures_vet_like_reference(name, tmp_path,
                                               jax_core_alias):
    path = write_topo(tmp_path, DEFECTS[name])
    got, want = vet_both(path)
    assert finding_keys(got.findings) == finding_keys(want.findings)
    assert [f.message for f in got.findings if f.rule.startswith("VET-T")] \
        == [f.message for f in want.findings if f.rule.startswith("VET-T")]


def test_malformed_yaml_is_a_finding_like_reference(tmp_path,
                                                    jax_core_alias):
    bad = tmp_path / "bad.yaml"
    bad.write_text("services: [unclosed\n")
    got, want = vet_both(str(bad))
    (f,) = got.findings
    assert f.rule == "VET-C001" and f.severity == "error"
    assert finding_keys(got.findings) == finding_keys(want.findings)
    assert cli.main(["vet", str(bad), "--device", "cpu"]) == 1


def test_lint_survives_deep_chains():
    """The cycle walk is iterative: a 2000-service chain lints clean."""
    n = 2000
    g = ServiceGraph.decode({"services": (
        [{"name": "s0", "isEntrypoint": True,
          "script": [{"call": "s1"}]}]
        + [{"name": f"s{i}", "script": [{"call": f"s{i + 1}"}]}
           for i in range(1, n - 1)]
        + [{"name": f"s{n - 1}"}]
    )})
    assert topo_lint.lint_graph(g) == []


SWEEP = """
topology_paths = ["{topo}", "missing.yaml"]
environments = ["NONE"]

[client]
qps = [50]
num_concurrent_connections = [4]
duration = "10s"
load_kind = "open"

[[chaos]]
service = "nope"
start = "1s"
end = "2s"

[[churn]]
service = "b"
period = "60s"
weights = [1.0, 0.5]
"""


def test_sweep_toml_vets_like_reference(tmp_path, jax_core_alias):
    """``vet_config_path``: the config lint's rules and key paths, then
    every referenced topology, as the reference's."""
    topo = write_topo(tmp_path, CHAIN, "chain.yaml")
    cfg = tmp_path / "sweep.toml"
    cfg.write_text(SWEEP.format(topo=topo))
    got = vet_config_path(cfg, device="cpu")
    want = jax_vet.vet_config_path(cfg)
    rules = {f.rule for f in got.findings}
    assert {"VET-C001", "VET-C003", "VET-C004"} <= rules
    assert finding_keys(got.findings) == finding_keys(want.findings)
    assert set(got.meta) == set(want.meta) == {topo}
    assert got.meta[topo]["cost"]["peak_bytes_at_block"] > 0


@pytest.mark.parametrize("kind,rule", [
    ("callback", "VET-J001"), ("f64", "VET-J002"), ("graddead", "VET-G001"),
])
def test_injected_defects_surface_in_both(kind, rule, monkeypatch,
                                          jax_core_alias):
    """Each ``$ISOTOPE_VET_INJECT`` kind surfaces its rule in both
    packages, through the CLI."""
    monkeypatch.setenv("ISOTOPE_VET_INJECT", kind)
    path = str(ROOT / "examples/topologies/chain-3-services.yaml")
    argv = ["vet", path] + (["--grad"] if kind == "graddead" else [])
    outs = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jax_cli.main, [])):
        out = io.StringIO()
        with redirect_stdout(out), redirect_stderr(io.StringIO()):
            rc = main(argv + extra)
        outs.append((rc, out.getvalue()))
    (rc, out), (jax_rc, jax_out) = outs
    assert rc == jax_rc == (0 if kind == "graddead" else 1)
    assert rule in out and rule in jax_out
    if kind == "graddead":
        assert "'cpu_time_s' is gradient-dead" in out
        assert "aten.floor" in out


# -- the CLI -------------------------------------------------------------------


def _rc_both(argv):
    rcs = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jax_cli.main, [])):
        with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
            rcs.append(main(argv + extra))
    return rcs


def test_cli_exit_codes_like_reference(tmp_path, jax_core_alias):
    """``vet`` exits as the reference's: 1 on an error, ``--suppress``
    silences it, ``--strict`` promotes warnings, and the VET-G warnings
    block only under ``--strict`` (the family glob restores 0)."""
    dead = write_topo(tmp_path, DEFECTS["dead-capacity"], "dead.yaml")
    warn = write_topo(tmp_path, DEFECTS["error-rate-one"], "warn.yaml")
    chain = write_topo(tmp_path, CHAIN, "chain.yaml")
    for argv, rc in (
        (["vet", dead], 1),
        (["vet", dead, "--suppress", "VET-T001"], 0),
        (["vet", warn], 0),
        (["vet", warn, "--strict"], 1),
        (["vet", chain, "--strict"], 0),
        (["vet", "--grad", "--strict", chain], 1),
        (["vet", "--grad", "--strict", "--suppress", "VET-G*", chain], 0),
    ):
        assert _rc_both(argv) == [rc, rc], argv


def test_cli_unreachable_fixture_names_its_rule(tmp_path, capsys):
    path = write_topo(tmp_path, DEFECTS["dead-capacity"])
    assert cli.main(["vet", path, "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "VET-T001" in captured.out
    assert "1 error(s)" in captured.err


def test_cli_json_and_grad_json(tmp_path, capsys, jax_core_alias):
    """``--json`` prints the report (findings, per-path meta with the
    cost model and the ``mesh_layout`` block: what ``--mesh auto``
    would pick in this world, with its cost rows), and
    ``--grad-json`` writes ``isotope-gradaudit/v1`` with the reference's
    classes (exit 0: VET-G findings are warn/info)."""
    topo = write_topo(tmp_path, CHAIN, "chain.yaml")
    cfg = tmp_path / "sweep.toml"
    cfg.write_text(SWEEP.split("[[chaos]]")[0].format(topo=topo).replace(
        ', "missing.yaml"', ""))
    assert cli.main(["vet", "--json", str(cfg), "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == []
    meta = doc["meta"][str(cfg)][topo]
    assert meta["cost"]["peak_bytes_at_block"] > 0
    layout = meta["mesh_layout"]
    assert set(layout) == {"mesh", "score_s", "pad_fraction", "comm"}
    # the one-process world: one device, one host
    assert layout["mesh"] == "data=1,svc=1"
    assert layout["score_s"] == 0.0 and layout["pad_fraction"] == 0.0
    assert [r["collective"] for r in layout["comm"]] == [
        "psum_replicated", "psum_scatter_svc"]
    assert all(set(r) == {"collective", "link", "participants", "bytes",
                          "time_s"} for r in layout["comm"])
    out, jax_out = tmp_path / "grad.json", tmp_path / "jax-grad.json"
    assert cli.main(["vet", "--grad-json", str(out), topo,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["vet", "--grad-json", str(jax_out), topo]) == 0
    got, want = json.loads(out.read_text()), json.loads(jax_out.read_text())
    assert got["schema"] == want["schema"] == "isotope-gradaudit/v1"
    (audit,), (jax_audit,) = got["audits"], want["audits"]
    assert audit["topology"] == topo
    for key in ("classes", "objectives", "vacuous_objectives", "invars"):
        assert audit[key] == jax_audit[key], key


# -- cli.main, as the reference's -------------------------------------------


def test_cli_main_without_a_command_prints_help_and_returns_2(capsys):
    assert cli.main([]) == 2
    assert "usage:" in capsys.readouterr().out


def test_cli_main_turns_os_and_value_errors_into_exit_1(tmp_path, capsys):
    """``OSError`` / ``ValueError`` become ``error: ...`` and exit 1, as
    the reference's ``cli.main`` does; a handler's ``None`` is 0."""
    missing = str(tmp_path / "nope.yaml")
    assert cli.main(["graphviz", missing]) == 1
    assert capsys.readouterr().err.startswith("error: ")
    assert cli.main(["timeline", str(ROOT / "examples/topologies/"
                                     "canonical.yaml"),
                     "--controlplane", "x", "--device", "cpu"]) == 1
    assert "error: " in capsys.readouterr().err
    assert cli.main(["graphviz", str(ROOT / "examples/topologies/"
                                     "canonical.yaml")]) == 0


def test_simulate_vet_blocks_with_the_reference_error(tmp_path, capsys):
    """``simulate --vet`` on a defective topology records the case
    FAILED before it runs and exits 1 with ``error: vet found ...``."""
    path = write_topo(tmp_path, DEFECTS["dead-capacity"])
    rc = cli.main(["simulate", path, "--vet", "--qps", "50",
                   "--duration", "0.1s", "--load-kind", "open",
                   "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "vet: error VET-T001" in err
    assert "error: vet found 1 blocking finding(s): VET-T001" in err


# -- the gate ------------------------------------------------------------------


def _config(topo, **kw):
    return ExperimentConfig(
        topology_paths=(topo,),
        environments=(DEFAULT_ENVIRONMENTS["NONE"],),
        qps=(50.0,), connections=(4,), duration_s=30.0,
        load_kind="open", num_requests=kw.pop("num_requests", 1024), **kw,
    )


def _same_case(a, b):
    assert a.fortio_json["DurationHistogram"] == \
        b.fortio_json["DurationHistogram"]
    fa = dict(a.flat, StartTime=None)
    fb = dict(b.flat, StartTime=None)
    assert fa == fb


def test_gate_leaves_the_summary_bit_for_bit(tmp_path, monkeypatch):
    """A vetted case that fits runs at ``scan`` and reports exactly the
    un-vetted case's documents; ``$ISOTOPE_VET`` arms the same gate."""
    monkeypatch.delenv("ISOTOPE_VET_DEVICE_BYTES", raising=False)
    topo = write_topo(tmp_path, CHAIN)
    cfg = _config(topo)
    (plain,) = run_experiment(cfg, device="cpu")
    telemetry.reset()
    (vetted,) = run_experiment(cfg, vet="on", device="cpu")
    assert telemetry.counter_get("vet_runs_total") == 1.0
    assert not vetted.failed and vetted.degraded_to is None
    _same_case(vetted, plain)
    monkeypatch.setenv("ISOTOPE_VET", "1")
    telemetry.reset()
    (env_vetted,) = run_experiment(cfg, device="cpu")
    assert telemetry.counter_get("vet_runs_total") == 1.0
    _same_case(env_vetted, plain)


def test_gate_preselects_half_block_and_records_degraded(tmp_path,
                                                         monkeypatch):
    """A device budget between half and all of the estimate gives
    VET-M002: the case starts on ``half-block``, is recorded degraded,
    and reports exactly what the ladder serves after an OOM at
    ``scan``."""
    from isotope_tpu_torch.analysis import costmodel
    from isotope_tpu_torch.resilience import faults

    topo = write_topo(tmp_path, CHAIN)
    cfg = _config(topo)
    sim = Simulator(compile_graph(ServiceGraph.decode(CHAIN)), device="cpu")
    # the gate estimates at the block the case runs: its 1,024 requests
    peak = vet_simulator(sim, LoadModel(**OPEN), block_requests=1024,
                         ).meta["cost"]["peak_bytes_at_block"]
    # the gate's load is the case's (50 qps): its pilot is the same size
    monkeypatch.setenv("ISOTOPE_VET_DEVICE_BYTES",
                       str(peak * 0.7 / costmodel.CAPACITY_FILL))
    (vetted,) = run_experiment(cfg, vet="on", device="cpu")
    assert not vetted.failed
    assert vetted.degraded_to == "half-block"
    monkeypatch.delenv("ISOTOPE_VET_DEVICE_BYTES")
    try:
        faults.install("oom:engine.run:1")
        (laddered,) = run_experiment(cfg, device="cpu")
    finally:
        faults.clear()
    assert laddered.degraded_to == "half-block"
    _same_case(vetted, laddered)


def _force_m002(monkeypatch, analysis_mod, fill):
    """Wrap the gate's ``vet_simulator`` (it imports it from
    ``analysis_mod`` at call time): a first call reads the estimate, then
    ``ISOTOPE_VET_DEVICE_BYTES`` is set to 0.7x of it over ``fill``
    (between half and all of the block) and the gate's own call runs."""
    real = analysis_mod.vet_simulator

    def gate_vet(sim, load, **kw):
        peak = real(sim, load, **kw).meta["cost"]["peak_bytes_at_block"]
        monkeypatch.setenv("ISOTOPE_VET_DEVICE_BYTES", str(peak * 0.7 / fill))
        return real(sim, load, **kw)

    monkeypatch.setattr(analysis_mod, "vet_simulator", gate_vet)


@pytest.mark.parametrize("protected", [False, True],
                         ids=["fleet", "protected-fleet"])
def test_gate_m002_fleet_gives_way_to_the_solo_run_like_reference(
        protected, tmp_path, monkeypatch, jax_core_alias):
    """A fleet case whose block does not fit (VET-M002) skips the fleet,
    plain or protected, and is served by the solo run from the
    pre-selected rung (a protected one on its own ladder), as the
    reference's is: the same served path, markers and flat row on the
    same draws."""
    import jax

    import isotope_tpu.analysis as jax_analysis
    import isotope_tpu_torch.analysis as port_analysis
    import isotope_tpu_torch.sim
    from isotope_tpu.analysis import costmodel as jax_costmodel
    from isotope_tpu_torch.analysis import costmodel
    from test_torch_replay import JaxReplayDraws
    from test_torch_runner import _sweep_pair, flat_close, grid
    from test_torch_summary import PROTECTED_TOPOLOGY

    monkeypatch.setattr(
        isotope_tpu_torch.sim, "TorchDraws",
        lambda seed, device: JaxReplayDraws(jax.random.PRNGKey(seed)),
    )
    _force_m002(monkeypatch, jax_analysis, jax_costmodel.CAPACITY_FILL)
    _force_m002(monkeypatch, port_analysis, costmodel.CAPACITY_FILL)
    if protected:
        topo = tmp_path / "prot.yaml"
        topo.write_text(PROTECTED_TOPOLOGY)
        cfg = grid(tmp_path, topo=topo, qps=(2000,), conns=(64,),
                   duration="8s", envs=("NONE",),
                   sim_extra="policies = true\nensemble = 3")
    else:
        cfg = grid(tmp_path, topo=write_topo(tmp_path, CHAIN), qps=(200,),
                   envs=("NONE",), n=2000, sim_extra="ensemble = 3")
    telemetry.reset()
    (p,), (j,) = _sweep_pair(tmp_path, cfg, vet="on")
    assert telemetry.counter_get("vet_rung_preselections") == 1.0
    assert not p.failed and not j.failed
    assert p.ensemble_summary is None and j.ensemble_summary is None
    # a protected run keeps its own ladder: not recorded as degraded
    assert p.degraded_to == j.degraded_to == (
        None if protected else "half-block")
    assert "_ensemble" not in p.flat and "_ensemble" not in j.flat
    assert p.flat.get("_policies") == j.flat.get("_policies") == (
        True if protected else None)
    flat_close(p.flat, j.flat, p.label)


def test_gate_blocks_vet_m001_without_running(tmp_path, monkeypatch):
    """When even half a block does not fit, no rung of the port's ladder
    can serve the case: VET-M001 blocks it (ladder armed or not) and the
    case is recorded FAILED without a block running."""
    topo = write_topo(tmp_path, CHAIN)
    monkeypatch.setenv("ISOTOPE_VET_DEVICE_BYTES", "65536")

    def boom(*a, **k):  # pragma: no cover - must never run
        raise AssertionError("a blocked case ran")

    monkeypatch.setattr(Simulator, "run_summary", boom)
    monkeypatch.setattr(Simulator, "run_blocks", boom)
    (res,) = run_experiment(_config(topo), vet="on", device="cpu")
    assert res.failed
    assert isinstance(res.cause, VetError)
    assert "VET-M001" in res.error


def test_gate_blocks_defective_topology(tmp_path):
    topo = write_topo(tmp_path, DEFECTS["dead-capacity"])
    (res,) = run_experiment(_config(topo), vet="on", device="cpu")
    assert res.failed
    assert "VET-T001" in res.error
    # gate off: the same topology runs fine (dead capacity is legal)
    (res_off,) = run_experiment(_config(topo), device="cpu")
    assert not res_off.failed


def test_gate_strict_blocks_warnings(tmp_path):
    topo = write_topo(tmp_path, DEFECTS["error-rate-one"])
    (res,) = run_experiment(_config(topo), vet="on", device="cpu")
    assert not res.failed
    (res,) = run_experiment(_config(topo), vet="strict", device="cpu")
    assert res.failed and "VET-T005" in res.error


# -- no real block -------------------------------------------------------------


@pytest.mark.parametrize("kind,n", [("open", 8), ("closed", 64)])
def test_vet_never_runs_a_real_block(kind, n, monkeypatch):
    """The port's form of ``test_audit_is_trace_only``: vet (with the
    gradient audit) records pilot blocks of the reference's trace size
    (8 requests, one per connection for a closed loop) and never enters
    ``run``, ``run_blocks`` or ``run_summary``."""
    monkeypatch.delenv("ISOTOPE_VET_INJECT", raising=False)

    def boom(*a, **k):  # pragma: no cover - must never run
        raise AssertionError("vet executed the engine")

    for name in ("run", "run_blocks", "run_summary"):
        monkeypatch.setattr(Simulator, name, boom)
    telemetry.reset()
    load = dict(kind=kind, qps=100.0, connections=64)
    report = vet_topology_path(
        str(ROOT / "examples/topologies/tree-13-services.yaml"),
        load=LoadModel(**load), grad=True, device="cpu",
    )
    assert report.errors == []
    assert report.meta["cost"]["trace_requests"] == n
    assert report.meta["grad"]["traced_requests"] == n
    assert telemetry.counter_get("vet_rule.VET-G002") > 0


# -- the reference's live pins -----------------------------------------------


def test_rules_registry_and_suppression():
    assert "VET-T001" in RULES and "VET-M001" in RULES
    for rule in ("VET-G001", "VET-G002", "VET-G003", "VET-G004"):
        assert rule in RULES
    with pytest.raises(ValueError, match="unknown vet rule"):
        suppression_patterns("VET-X999")
    with pytest.raises(ValueError, match="unknown vet rule"):
        suppression_patterns("VET-G999")
    pats = suppression_patterns("VET-J003,VET-T00*")
    r = Report(suppress=pats)
    r.add(topo_lint.Finding("VET-T001", "error", "x"))
    r.add(topo_lint.Finding("VET-M001", "error", "y"))
    assert [f.rule for f in r.findings] == ["VET-M001"]
    assert [f.rule for f in r.suppressed] == ["VET-T001"]
    assert [f.rule for f in r.blocking()] == ["VET-M001"]
    assert r.blocking(nonblocking_rules=("VET-M001",)) == []


def test_decode_and_toml_errors_carry_key_paths(tmp_path):
    with pytest.raises(ValueError) as ei:
        ServiceGraph.decode({"services": [
            {"name": "a", "isEntrypoint": True},
            {"name": "b", "script": [{"call": "a"}, {"sleep": 5}]},
        ]})
    assert "services[1].script[1].sleep" in str(ei.value)
    with pytest.raises(ValueError) as ei:
        ServiceGraph.decode({"defaults": {"requestSize": "bogus"},
                             "services": []})
    assert "defaults.requestSize" in str(ei.value)
    cfg = tmp_path / "bad.toml"
    cfg.write_text('topology_paths = []\n\n[[chaos]]\nservice = "a"\n'
                   'start = "xx"\nend = "2s"\n')
    with pytest.raises(ValueError) as ei:
        load_toml(cfg)
    assert "chaos[0].start" in str(ei.value)


def test_vet_counters_render_as_first_class_series():
    telemetry.reset()
    sim = Simulator(compile_graph(ServiceGraph.decode(CHAIN)), device="cpu")
    vet_simulator(sim, LoadModel(**OPEN), block_requests=1024, trace=False)
    assert telemetry.counter_get("vet_runs_total") == 1.0
    blk = telemetry.summary_block()
    assert blk["vet_runs"] == 1
    assert "vet_errors" in blk
    assert "isotope_engine_vet_runs_total" in telemetry.prometheus_text()
    telemetry.reset()
    assert "vet_errors" not in telemetry.summary_block()


def test_bench_regress_vet_gate_reads_the_port_s_telemetry(tmp_path,
                                                          monkeypatch):
    """The reference's bench gate (``tools/bench_regress.vet_failures``)
    reads the ``vet_errors`` the port's telemetry block carries: a
    capture whose vet found more errors than its baseline's regressed,
    and a capture that never vetted carries no vet keys."""
    import tools.bench_regress as br

    def capture(doc):
        telemetry.reset()
        vet_topology_path(write_topo(tmp_path, doc), device="cpu")
        return {"value": 1.0, "extra": {
            "svc": 2.0, "svc_telemetry": telemetry.summary_block()}}

    clean = capture(CHAIN)
    bad = capture(DEFECTS["dead-capacity"])
    assert clean["extra"]["svc_telemetry"]["vet_errors"] == 0
    assert bad["extra"]["svc_telemetry"]["vet_errors"] == 1
    monkeypatch.setenv("BENCH_REGRESS_VET_GATE", "1")
    assert br.vet_failures(clean, bad) == ["svc.vet_errors"]
    assert br.vet_failures(clean, clean) == []
    telemetry.reset()
    assert "vet_errors" not in telemetry.summary_block()


def test_fault_site_validation_lists_valid_sites():
    from isotope_tpu_torch.resilience import faults

    with pytest.raises(ValueError) as ei:
        faults.FaultPlan.parse("oom:engine.rnu:1")
    for site in faults.VALID_SITES:
        assert site in str(ei.value)
    faults.clear()
