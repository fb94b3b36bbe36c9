"""A copy of the benchmark's files with the cells cut to CPU sizes.

Tests run the harness on the CPU through ``bench.run_cell(device=
"cpu")``, which skips the look for a card that ``run.py`` makes; the
sizes here are the tests' own and never a cell's."""
from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np

from portbench.harness import cells, check

#: traffic overrides of each cell's mix at test size
SIZES = {
    "tree121.open": {"requests": 8192, "block": 4096},
    # an odd block: the half-batch fault must halve it too
    "star10k.open": {"requests": 130, "block": 65},
    "tree121.blame-tail": {"requests": 8192, "block": 4096},
}
DIRS = ("configs", "entries", "metrics", "workloads", "traffic")


FLEET = "tree121.fleet4"
#: a run's summary, as the comparison reads it
RUN = check.Run(count=1.0, errors=0.0, hop_events=1.0,
                hist=np.ones(4), latency_sum=1.0, utilization=np.ones(2))


def fleet(base_dir: pathlib.Path, bench: dict) -> dict:
    """Add a test-only fleet cell (4 members of the tree, folded where
    the device folds) to ``base_dir``; returns ``bench`` listing it."""
    (base_dir / "traffic" / "tiny-fleet.json").write_text(json.dumps({
        "entry": "run_ensemble", "kind": "open", "qps": 10400,
        "requests": 256, "block": 256, "members": 4}))
    limits = json.loads((base_dir / "workloads" / "tree121.open.json")
                        .read_text())["limits"]
    (base_dir / "workloads" / f"{FLEET}.json").write_text(json.dumps({
        "config": "tree121", "traffic": "tiny-fleet",
        "check_experiments": 2, "limits": {**limits, "hist_moved": 5e-3}}))
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": FLEET, "config": "tree121",
                               "traffic": "tiny-fleet", "chips": 1,
                               "why": "test"})
    return bench


def base(tmp: pathlib.Path, cell: str = None) -> pathlib.Path:
    """A benchmark directory under ``tmp`` whose cells run at test size
    (only ``cell``'s, when given)."""
    out = tmp / "portbench"
    for d in DIRS:
        shutil.copytree(cells.BASE / d, out / d)
    for name, sizes in SIZES.items():
        if cell is not None and name != cell:
            continue
        w_path = out / "workloads" / f"{name}.json"
        w = json.loads(w_path.read_text())
        w["warmup_requests"] = sizes["block"]
        w_path.write_text(json.dumps(w))
        t_path = out / "traffic" / f"{w['traffic']}.json"
        t = json.loads(t_path.read_text())
        t.update(sizes)
        t_path.write_text(json.dumps(t))
    return out
