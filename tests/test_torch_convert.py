"""The port's host-only commands against the JAX package's: the
converters (``kubernetes``, ``graphviz``, ``security-policies``), the
topology generators (``generate tree|realistic|powerlaw``),
``pilot-load`` and ``plot``.

Tolerances: the converters' manifests and DOT text, the generated
YAML and the signed token are byte-equal (the same RSA key is handed to
both packages' generator: each draws a fresh key by design).
``pilot-load``'s rows on the reference's normals (the port's
``push_normals`` replaced, as in ``tests/test_torch_controlplane.py``):
counts exactly, seconds within rtol 1e-6 (``exp`` may round one ULP
apart).  ``plot`` draws the same series from a port ``sweep``'s CSV.
"""
import argparse
import io
import json
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch

from isotope_tpu import cli as jax_cli
from isotope_tpu.convert import security as jax_security
from isotope_tpu.plotting import plot_benchmark as jax_plot_benchmark
from isotope_tpu_torch import cli
from isotope_tpu_torch.convert import security
from isotope_tpu_torch.plotting import plot_benchmark
from isotope_tpu_torch.sim import controlplane as cp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPOLOGIES = sorted((ROOT / "examples" / "topologies").glob("*.yaml"))
CANONICAL = ROOT / "examples" / "topologies" / "canonical.yaml"
TWO_CLUSTER = ROOT / "examples" / "topologies" / "two-cluster-canonical.yaml"

SECURITY_CONFIG = {
    "authZ": {"action": "ALLOW", "numPolicies": 2, "numPaths": 3,
              "numSourceIP": 1, "numValues": 2,
              "numRequestPrincipals": 2},
    "namespace": "twopods-istio",
    "peerAuthN": {"mtlsMode": "STRICT", "numPolicies": 1},
    "requestAuthN": {"numPolicies": 1, "numJwks": 2},
}


def run_both(argv, port_extra=()):
    """``argv`` through both CLIs, the port's with ``port_extra`` after
    it: ``(port, jax)`` of ``(rc, stdout)``."""
    out = []
    for main, extra in ((cli.main, list(port_extra)), (jax_cli.main, [])):
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            rc = main(list(argv) + extra)
        out.append((rc, buf.getvalue()))
    return out


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=lambda p: p.stem)
def test_kubernetes_and_graphviz_byte_equal(topo):
    for argv in (["kubernetes", str(topo)],
                 ["kubernetes", str(topo), "--environment-name", "ISTIO",
                  "--max-idle-connections-per-host", "8"],
                 ["graphviz", str(topo)]):
        got, want = run_both(argv)
        assert got == want and got[0] == 0 and got[1], argv


@pytest.mark.parametrize("cluster", ["cluster1", "cluster2"])
def test_kubernetes_cluster_filter_byte_equal(cluster):
    got, want = run_both(["kubernetes", str(TWO_CLUSTER), "--cluster",
                          cluster])
    assert got == want and got[0] == 0


def test_graphviz_writes_the_same_file(tmp_path):
    port, ref = tmp_path / "port.dot", tmp_path / "jax.dot"
    assert cli.main(["graphviz", str(TWO_CLUSTER), str(port)]) == 0
    assert jax_cli.main(["graphviz", str(TWO_CLUSTER), str(ref)]) == 0
    assert port.read_bytes() == ref.read_bytes()
    assert b"subgraph" in port.read_bytes()


@pytest.fixture(scope="module")
def rsa_key():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


@pytest.mark.parametrize("config", [SECURITY_CONFIG, None,
                                    {"authZ": {"action": "DENY",
                                               "numPolicies": 1,
                                               "dryRun": True}}],
                         ids=["full", "empty", "deny-dry-run"])
def test_security_policies_equal_with_one_key(tmp_path, monkeypatch,
                                              rsa_key, config):
    monkeypatch.setattr(security, "_generate_key", lambda: rsa_key)
    monkeypatch.setattr(jax_security, "_generate_key", lambda: rsa_key)
    argv = ["security-policies"]
    if config is not None:
        path = tmp_path / "config.json"
        path.write_text(json.dumps(config))
        argv.append(str(path))
    outs = {}
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        man, tok = tmp_path / f"{side}.yaml", tmp_path / f"{side}.jwt"
        assert main(argv + ["-o", str(man), "--token-out", str(tok)]) == 0
        outs[side] = (man.read_bytes(),
                      tok.read_bytes() if tok.exists() else None)
    assert outs["port"] == outs["jax"]
    assert (outs["port"][1] is not None) == (config is SECURITY_CONFIG)


@pytest.mark.parametrize("argv", [
    ["tree"],
    ["tree", "--levels", "4", "--branches", "2", "--sleep", "10ms",
     "--num-replicas", "3", "--instances", "2"],
    ["tree", "--levels", "5", "--num-services", "40"],
    ["realistic", "--services", "30", "--seed", "3"],
    ["realistic", "--services", "25", "--type", "star", "--seed", "1",
     "--instances", "2"],
    ["powerlaw", "--services", "60", "--seed", "5"],
    ["powerlaw", "--services", "40", "--exponent", "1.5", "--max-degree",
     "6", "--sleep-choices", "1ms,4ms", "--error-rate-choices",
     "0%,1%,2%", "--seed", "2"],
], ids=lambda a: "-".join(a[:3]))
def test_generate_byte_equal(argv):
    got, want = run_both(["generate"] + argv)
    assert got == want and got[0] == 0 and "services:" in got[1]


def test_generate_writes_the_same_file(tmp_path):
    port, ref = tmp_path / "port.yaml", tmp_path / "jax.yaml"
    argv = ["generate", "powerlaw", "--services", "20", "--seed", "9", "-o"]
    assert cli.main(argv + [str(port)]) == 0
    assert jax_cli.main(argv + [str(ref)]) == 0
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("argv,seed", [
    ([], 0),
    (["--entries", "5,50,500", "--endpoints", "4", "--proxies", "300",
      "--push-throttle", "64"], 3),
])
def test_pilot_load_rows_on_reference_normals(monkeypatch, argv, seed):
    entries = [10, 100, 1000] if not argv else [5, 50, 500]
    proxies = 100 if not argv else 300
    # entry count i draws seed (seed, i) in the port, fold_in(key, i)
    # in the reference: hand the port the reference's normals
    index = {
        int(np.random.SeedSequence([seed, i]).generate_state(1)[0]): i
        for i in range(len(entries))
    }
    key = jax.random.PRNGKey(seed)

    def normals(p, seed_i, device):
        k = jax.random.fold_in(key, index[seed_i])
        return torch.from_numpy(
            np.asarray(jax.random.normal(k, (p,)), np.float32).copy())

    monkeypatch.setattr(cp, "push_normals", normals)
    (rc, out), (jrc, jout) = run_both(["pilot-load", "--seed", str(seed)]
                                      + argv, ["--device", "cpu"])
    assert rc == jrc == 0
    got = [json.loads(line) for line in out.splitlines()]
    want = [json.loads(line) for line in jout.splitlines()]
    assert len(got) == len(want) == len(entries)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("num_entries", "endpoints", "proxies"):
            assert g[k] == w[k] and proxies == g["proxies"]
        for k in ("p50_s", "p99_s", "max_s"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6)


def test_pilot_load_refuses_without_a_gpu(monkeypatch):
    """``pilot-load`` draws its jitter on the card: without a GPU and
    without ``--device cpu`` it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["pilot-load", "--entries", "10"])


@pytest.fixture(scope="module")
def sweep_csv(tmp_path_factory):
    """A port ``sweep``'s ``benchmark.csv`` (2 environments x 2
    connection counts of canonical.yaml, on the CPU)."""
    tmp = tmp_path_factory.mktemp("plot")
    cfg = tmp / "exp.toml"
    cfg.write_text(f"""
topology_paths = ["{CANONICAL}"]
environments = ["NONE", "ISTIO"]

[client]
qps = [500]
num_concurrent_connections = [2, 16]
duration = "10s"
load_kind = "closed"

[sim]
num_requests = 2000
seed = 4
""")
    with redirect_stderr(io.StringIO()):
        rc = cli.main(["sweep", str(cfg), "-o", str(tmp / "out"),
                       "--device", "cpu"])
    assert rc == 0
    return tmp / "out" / "benchmark.csv"


@pytest.mark.parametrize("x,metrics", [("conn", "p50,p90,p99"),
                                       ("qps", "p50,p999")])
def test_plot_same_series_from_a_port_sweep(sweep_csv, tmp_path, x,
                                            metrics):
    ms = metrics.split(",")
    got = plot_benchmark(sweep_csv, tmp_path / "port.png", x_axis=x,
                         metrics=ms)
    want = jax_plot_benchmark(sweep_csv, tmp_path / "jax.png", x_axis=x,
                              metrics=ms)
    assert got == want == ["canonical_istio", "canonical_none"]
    assert (tmp_path / "port.png").stat().st_size > 1000
    out = tmp_path / "cli.png"
    err = io.StringIO()
    with redirect_stderr(err):
        rc = cli.main(["plot", str(sweep_csv), "--x", x, "--metrics",
                       metrics, "-o", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"plotted {len(want)} series" in err.getvalue()


def _flags(parser):
    """``{command: {flag or positional: (dest, default, nargs, choices,
    const, required)}}`` of a parser, a sub-subcommand's flags under
    ``(kind, flag)``; a subparser action's choices by name."""
    def rows(p, prefix=()):
        out = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            key = prefix + (tuple(sorted(a.option_strings)) or (a.dest,))
            choices = a.choices
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    out.update(rows(sp, prefix + (name,)))
                choices = sorted(a.choices)
            out[key] = (a.dest, a.default, a.nargs, choices, a.const,
                        a.required)
        return out

    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return {name: rows(p) for name, p in sub.choices.items()}


def test_build_parser_matches_reference():
    """Both CLIs have the same subcommands, and each command the
    reference's flags with their defaults, choices and arities; the
    port adds ``--device`` to the commands that run the engine, and
    nothing else."""
    got, want = _flags(cli.build_parser()), _flags(jax_cli.build_parser())
    assert set(got) == set(want)
    engine = {"simulate", "check", "sweep", "suite", "telemetry",
              "timeline", "search", "fidelity", "pilot-load", "vet"}
    for name in got:
        extra = set(got[name]) - set(want[name])
        assert extra == ({("--device",)} if name in engine else set()), (
            name, extra)
        assert {k: got[name][k] for k in want[name]} == want[name], name


def test_cli_import_needs_no_optional_package():
    """Importing the port's CLI and building its parser imports no
    matplotlib, pandas or cryptography (the card's machine may lack
    them): only the handlers that need them do."""
    import subprocess

    code = ("import sys, isotope_tpu_torch.cli as c; c.build_parser(); "
            "print(sorted(m for m in ('matplotlib', 'pandas', "
            "'cryptography', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
