"""The port's ``fidelity`` (``metrics/fidelity.py``,
``commands/fidelity_cmd.py``) against the JAX package's.

Both packages read the vendored ``fortio load -json`` artifact
(``tests/data/fortio_canonical_sample.json``: closed loop, 16
connections, 1000 qps) and simulate ``canonical.yaml`` on the same
draws: the port's ``TorchDraws(seed)`` is replaced by
``JaxReplayDraws(PRNGKey(seed))``, so its closed loop's rate pilots and
blocks replay the reference's.  Tolerances: every string, boolean and
percentile key exactly; every float (sim percentiles, relative errors,
the sim's qps) within rtol 1e-5 / atol 1e-9, the engine's tolerance.
The runs are capped at 20,000 requests to keep the file small.
"""
import copy
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import isotope_tpu_torch.sim
from isotope_tpu import cli as jax_cli
from isotope_tpu.metrics import fidelity as jax_fidelity
from isotope_tpu_torch import cli
from isotope_tpu_torch.metrics import fidelity
from test_torch_replay import JaxReplayDraws

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "tests" / "data" / "fortio_canonical_sample.json"
TOPO = ROOT / "examples" / "topologies" / "canonical.yaml"
MAX_REQUESTS = 20_000
SEED = 7


@pytest.fixture(scope="module")
def artifact():
    return json.loads(ARTIFACT.read_text())


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(
        isotope_tpu_torch.sim, "TorchDraws",
        lambda seed, device: JaxReplayDraws(jax.random.PRNGKey(seed)),
    )


def perturbed(artifact):
    """Every percentile of the artifact x 1.2."""
    doc = copy.deepcopy(artifact)
    for p in doc["DurationHistogram"]["Percentiles"]:
        p["Value"] *= 1.2
    return doc


def json_close(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                   err_msg=path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def report_pair(doc, **kw):
    want = jax_fidelity.check_fidelity(
        doc, TOPO.read_text(), max_requests=MAX_REQUESTS, seed=SEED, **kw)
    got = fidelity.check_fidelity(
        doc, TOPO.read_text(), max_requests=MAX_REQUESTS, seed=SEED,
        device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("requested", [None, "max", "250", 64.0])
def test_load_from_artifact_equals_reference(artifact, requested):
    doc = dict(artifact)
    if requested is not None:
        doc["RequestedQPS"] = requested
    (load, dur), (jload, jdur) = (fidelity.load_from_artifact(doc),
                                  jax_fidelity.load_from_artifact(doc))
    assert (load.kind, load.qps, load.connections, dur) == (
        jload.kind, jload.qps, jload.connections, jdur)
    assert (load.kind, load.connections) == ("closed", 16)
    assert (load.qps is None) == (requested == "max")


def test_check_fidelity_matches_reference(artifact, replay):
    got, want = report_pair(artifact)
    assert [d.percentile for d in got.deltas] == [
        d.percentile for d in want.deltas] == [50, 75, 90, 99, 99.9]
    for g, w in zip(got.deltas, want.deltas):
        assert g.fortio_s == w.fortio_s
        np.testing.assert_allclose(g.sim_s, w.sim_s, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(g.rel_err, w.rel_err, rtol=1e-5,
                                   atol=1e-9)
    np.testing.assert_allclose(got.actual_qps_sim, want.actual_qps_sim,
                               rtol=1e-5)
    assert (got.actual_qps_fortio, got.error_percent_fortio,
            got.error_percent_sim, got.tolerance) == (
        want.actual_qps_fortio, want.error_percent_fortio,
        want.error_percent_sim, want.tolerance)
    assert got.ok and want.ok
    assert got.lines() == want.lines()


def test_perturbed_artifact_fails_in_both(artifact, replay):
    got, want = report_pair(perturbed(artifact))
    assert not got.ok and not want.ok
    assert [abs(d.rel_err) > 0.05 for d in got.deltas] == [
        abs(d.rel_err) > 0.05 for d in want.deltas]
    assert got.lines() == want.lines()


def _cli(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("perturb", [False, True])
def test_cli_json_equals_reference(artifact, replay, tmp_path, perturb):
    path = ARTIFACT
    if perturb:
        path = tmp_path / "perturbed.json"
        path.write_text(json.dumps(perturbed(artifact)))
    argv = ["fidelity", str(TOPO), "--fortio", str(path), "--json",
            "--max-requests", str(MAX_REQUESTS), "--seed", str(SEED)]
    rc, out = _cli(cli.main, argv + ["--device", "cpu"])
    jrc, jout = _cli(jax_cli.main, argv)
    assert (rc, jrc) == ((1, 1) if perturb else (0, 0))
    json_close(json.loads(out), json.loads(jout))


def test_cli_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["fidelity", str(TOPO), "--fortio", str(ARTIFACT),
                  "--max-requests", "64"])
