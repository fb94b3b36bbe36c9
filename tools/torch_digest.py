"""Digests of one block of each ``chip_smoke.py`` run, to hold two
checkouts to each other bit for bit on one card.

    python3 tools/torch_digest.py [--root DIR] --out FILE
    python3 tools/torch_digest.py --compare A B

Imports ``isotope_tpu_torch`` from ``DIR`` (default: this checkout),
builds on one CUDA card the runs of ``chip_smoke.py`` phase 5 (the main
path, the scenario runs and the lb runs) and its census-only
topologies, runs the first block of each (``Simulator.run_blocks``,
draws of seed 0) and writes, per run, the levels on the ragged census
(``DIR`` with ``sim/joins.py``) and the SHA-256 of every result
field of the block.  ``--compare`` prints the runs whose digests differ
and exits 1 if any does.  Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
from types import SimpleNamespace

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def port_namespace():
    """The port's entry points as ``chip_smoke.py``'s phases take them."""
    from isotope_tpu_torch.compiler import compile_graph, compile_lb
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census as census_mod
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.sim import (
        LoadModel,
        SimParams,
        Simulator,
        TorchDraws,
    )
    from isotope_tpu_torch.sim.config import (
        ChaosEvent,
        MtlsSchedule,
        TrafficSplit,
        bounce_schedule,
    )

    return SimpleNamespace(
        compile_graph=compile_graph, compile_lb=compile_lb,
        ServiceGraph=ServiceGraph, LoadModel=LoadModel, Simulator=Simulator,
        TorchDraws=TorchDraws, census=census_mod.census,
        realistic_topology=realistic_topology,
        with_call_policy=with_call_policy, SimParams=SimParams,
        ChaosEvent=ChaosEvent, TrafficSplit=TrafficSplit,
        MtlsSchedule=MtlsSchedule, bounce_schedule=bounce_schedule,
        DEFAULT_ENVIRONMENTS=DEFAULT_ENVIRONMENTS,
    ), census_mod


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()
    ).hexdigest()[:16]


def digests(port, chip_smoke) -> dict:
    from isotope_tpu_torch.models.generators import tree_topology

    flagship = port.ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))
    runs = chip_smoke.main_path_runs(port, flagship)
    runs += [run[:5] for run in chip_smoke.scenario_runs(port, {})]
    runs += [run[:5] for run in chip_smoke.lb_runs(port)]
    runs += [
        (name, sim, port.LoadModel(kind="open", qps=1000.0), block, block)
        for name, sim, block in chip_smoke.census_only_configs(port)
    ]
    out = {}
    for name, sim, load, n, block in runs:
        res = next(iter(sim.run_blocks(load, n, port.TorchDraws(0, "cuda"),
                                       block_size=block)))
        torch.cuda.synchronize()
        fields = {
            k: digest(v) for k, v in res._asdict().items()
            if isinstance(v, torch.Tensor)
        }
        ragged = [d for d, lvl in enumerate(sim._levels)
                  if lvl.join.kind == "ragged"]
        out[name] = {"ragged_levels": ragged, "fields": fields}
        print(f"digest {name}: block {block}, ragged levels {ragged}, "
              + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)
    return out


def compare(a: str, b: str) -> int:
    got = json.loads(pathlib.Path(a).read_text())
    want = json.loads(pathlib.Path(b).read_text())
    bad = 0
    for name in sorted(set(got) | set(want)):
        fa = got.get(name, {}).get("fields")
        fb = want.get(name, {}).get("fields")
        same = fa == fb
        bad += not same
        print(f"{'same' if same else 'DIFFERS'} {name}: ragged levels "
              f"{got.get(name, {}).get('ragged_levels')} / "
              f"{want.get(name, {}).get('ragged_levels')}", flush=True)
    print(f"{len(set(got) | set(want)) - bad} runs equal, {bad} differ")
    return 1 if bad else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--out")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = parser.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("torch_digest: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    port, census_mod = port_namespace()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card(), flush=True)
    print(f"isotope_tpu_torch from "
          f"{pathlib.Path(census_mod.__file__).resolve().parents[1]}",
          flush=True)
    census_mod.LIBRARY.build()
    out = digests(port, chip_smoke)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
