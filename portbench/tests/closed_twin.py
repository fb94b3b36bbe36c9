"""A twin of the closed-loop cell at test size: ``tiny``'s copy of the
benchmark with the cell's multitier graph cut to ``services`` services
(the generator's own graph at that size, seed 0) and its mix to
``connections`` connections and ``requests`` requests in two blocks."""
from __future__ import annotations

import json
import pathlib

from isotope_tpu_torch.models.generators import realistic_topology
from portbench.harness import cells
from portbench.tests import tiny

CELL = "multitier1k.qps-max-c10k"


def base(tmp: pathlib.Path, services: int = 40, connections: int = 64,
         requests: int = 4096) -> pathlib.Path:
    """The twin's benchmark directory under ``tmp``."""
    out = tiny.base(tmp, CELL)
    w = cells.load_workload(CELL, out)[0]
    cfg_path = out / "configs" / f"{w['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["topology"] = realistic_topology(services, archetype="multitier",
                                         seed=0)
    cfg_path.write_text(json.dumps(cfg))
    block = requests // 2 // connections * connections
    t_path = out / "traffic" / f"{w['traffic']}.json"
    t = json.loads(t_path.read_text())
    t.update(connections=connections, block=block, requests=2 * block)
    t_path.write_text(json.dumps(t))
    w_path = out / "workloads" / f"{CELL}.json"
    doc = json.loads(w_path.read_text())
    doc["warmup_requests"] = block
    w_path.write_text(json.dumps(doc))
    return out
