"""The port's ``explain`` (``commands/explain_cmd.py``) against the JAX
package's: both render the same artifacts and their output text must be
byte-equal.

The artifacts are the port's own: a ``sweep`` (``run_experiment`` on the
CPU) of a fleet with attribution and the recorder
(``<label>.fleet-blame.json`` and the worst member's stamped
postmortems) and a ``search`` bracket's document written into the same
directory (``<label>.search.json``),
the reference's hand-written bracket document
(``tests/test_fleetblame.py::test_explain_cmd_narrates_search_doc``) and
an ingest report with its closure verdict (``<label>.ingest.json``).
Each is explained as a directory (with and without ``--label``) and as
one file, as text and as ``--json``.  Of the reference's fleet-blame
pins, the port is held to the passing ones (the explainer's planted
member pin fails in the reference, ROADMAP queue 3): the search
narrative's words here, the worst members' report in
``tests/test_torch_fleetblame.py``.
"""
import argparse
import io
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout

import pytest

from isotope_tpu.commands.explain_cmd import run_explain_cmd as jax_explain
from isotope_tpu_torch import cli
from isotope_tpu_torch.commands.explain_cmd import run_explain_cmd
from isotope_tpu_torch.ingest import FitOptions, closure_check, fit
from isotope_tpu_torch.ingest import read_path
from isotope_tpu_torch.ingest import report
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.runner.config import (
    DEFAULT_ENVIRONMENTS,
    ExperimentConfig,
)
from isotope_tpu_torch.runner.run import run_experiment

DATA = pathlib.Path(__file__).parent / "data" / "ingest"
YAML = """
defaults:
  responseSize: 1 KiB
services:
- name: entry
  isEntrypoint: true
  errorRate: 1%
  script:
  - - call: x
    - call: y
  - call: z
- name: x
  numReplicas: 2
- name: y
  script:
  - call: z
- name: z
"""
SEARCH_DOC = {
    "schema": "isotope-search/v1",
    "label": "t", "rank": "err_peak",
    "rank_effective": "err_share", "eta": 4, "growth": 2,
    "candidates": 4, "block": 256, "traces": 2, "mode": "map",
    "winner": {"candidate": 3, "severity": 0.01},
    "lineage": [{
        "rung": 0, "width": 4, "chunk": 4, "start_block": 0,
        "num_blocks": 1, "cum_requests": 1024,
        "candidates": [0, 1, 2, 3],
        "severity": [0.4, 0.3, 0.2, 0.1],
        "survivors": [3],
        "cut": {"kept": 1,
                "last_kept": {"candidate": 3, "severity": 0.1},
                "first_cut": {"candidate": 2, "severity": 0.2},
                "margin": 0.1},
        "evidence": {"traces": 1, "compile_s": 0.5,
                     "rank_order": [3, 2, 1, 0]},
    }],
    "spec": {},
}


def explain_both(path, **kw):
    """Both packages' ``explain`` on ``path``: ``(port, jax)`` of
    ``(rc, stdout, stderr)``."""
    opts = dict(label=None, top=3, hops=3, json=False)
    opts.update(kw)
    out = []
    for fn in (run_explain_cmd, jax_explain):
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            rc = fn(argparse.Namespace(path=str(path), **opts))
        out.append((rc, buf.getvalue(), err.getvalue()))
    return out


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """A port sweep's output directory holding a fleet's blame
    documents, a search bracket's document and an ingest report."""
    tmp = tmp_path_factory.mktemp("explain")
    topo = tmp / "t.yaml"
    topo.write_text(YAML)
    out = tmp / "out"
    common = dict(topology_paths=(str(topo),),
                  environments=(DEFAULT_ENVIRONMENTS["NONE"],),
                  connections=(8,), duration_s=2.0, load_kind="open")
    fleet = ExperimentConfig(qps=(500.0,), ensemble=3, attribution=True,
                             timeline=True, num_requests=256, **common)
    (res,) = run_experiment(fleet, out_dir=str(out), attribution="on",
                            timeline=0.25, device="cpu")
    assert not res.failed, res.error
    with redirect_stdout(io.StringIO()):
        rc = cli.main(["search", str(topo), "--qps", "400", "--duration",
                       "4s", "--candidates", "4", "--eta", "2", "--rungs",
                       "2", "--device", "cpu", "--out",
                       str(out / "t_400qps.search.json")])
    assert rc == 0
    # an ingest report with its self-closure verdict
    obs = read_path(str(DATA / "sample.prom"))
    fr = fit(obs, FitOptions(label="prom", duration_s=60.0))
    doc = report.to_doc(fr, obs)
    doc["closure"] = closure_check(ServiceGraph.from_yaml(
        fr.graph.to_yaml()), fr.cpu_time_s, [fr.qps_mean], fr)
    report.save_doc(doc, str(out / "prom.ingest.json"))
    return out


def test_sweep_directory_holds_every_kind(sweep_dir):
    names = sorted(p.name for p in sweep_dir.iterdir())
    for suffix in (".fleet-blame.json", ".search.json", ".ingest.json",
                   ".blame.json", ".timeline.json"):
        assert any(n.endswith(suffix) for n in names), (suffix, names)


@pytest.mark.parametrize("kw", [
    {}, dict(top=1, hops=1), dict(json=True), dict(label="500qps"),
    dict(label="400qps"), dict(label="no-such-run"),
], ids=["default", "top1", "json", "fleet-only", "search-only", "none"])
def test_explain_directory_byte_equal(sweep_dir, kw):
    got, want = explain_both(sweep_dir, **kw)
    assert got == want
    if kw.get("label") == "no-such-run":
        assert got[0] == 1 and "explain: no" in got[2]
        return
    assert got[0] == 0 and got[1]
    if not kw:
        for what in ("== ", "search bracket", "ingest 'prom'",
                     "self-closure:", "replay:"):
            assert what in got[1], what


@pytest.mark.parametrize("suffix", [".fleet-blame.json", ".search.json",
                                    ".ingest.json"])
def test_explain_one_file_byte_equal(sweep_dir, suffix):
    (path,) = [p for p in sweep_dir.iterdir() if p.name.endswith(suffix)]
    got, want = explain_both(path)
    assert got == want and got[0] == 0 and got[1].startswith("== ")


def test_explain_narrates_the_reference_search_doc(tmp_path):
    path = tmp_path / "t.search.json"
    path.write_text(json.dumps(SEARCH_DOC))
    got, want = explain_both(path)
    assert got == want and got[0] == 0
    text = got[1]
    for what in ("winner 3", "beat runner-up 2", "margin 0.1",
                 "compile 0.50s"):
        assert what in text, what


def test_explain_refuses_a_foreign_search_doc(tmp_path):
    path = tmp_path / "x.search.json"
    path.write_text(json.dumps(dict(SEARCH_DOC, schema="other/v9")))
    with pytest.raises(ValueError, match="isotope-search/v1"):
        explain_both(path)


def test_explain_through_the_cli(sweep_dir):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["explain", str(sweep_dir), "--top", "2"])
    got, _ = explain_both(sweep_dir, top=2)
    assert rc == 0 and buf.getvalue() == got[1]
