"""Time the port's main-path runs of ``chip_smoke.py`` phase 5.

    python3 tools/torch_main_path.py [--root DIR]

Builds the census kernel and runs, on one CUDA card, the flagship,
``1000-svc_2000-end``, ``canonical`` paced closed loop,
``realistic-powerlaw-100``, star-10k with 30 s timeouts and ``canonical``
under ``-qps max``, and the two lb runs (lb-10svc-100r-panic and
lb-1000svc-lr) where the imported package has the lb laws, exactly as
``chip_smoke.py`` phase 5 does (one warm-up block each, then each run
timed with its census launches counted), and prints the card's name and
power limit and one ``main path`` line per run.  ``--root`` imports ``isotope_tpu_torch``
from another checkout (default: this one), so that two versions can be
timed in turns on one card within one call.  Needs a CUDA device; exits
1 without one.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from types import SimpleNamespace

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(ROOT))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from isotope_tpu_torch import compiler
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        tree_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census as census_mod
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws
    from isotope_tpu_torch.sim.config import ChaosEvent

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card(), flush=True)
    package = pathlib.Path(census_mod.__file__).resolve().parents[1]
    print(f"isotope_tpu_torch from {package}", flush=True)
    census_mod.LIBRARY.build()
    port = SimpleNamespace(
        compile_graph=compile_graph, ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, Simulator=Simulator, TorchDraws=TorchDraws,
        census=census_mod.census, realistic_topology=realistic_topology,
        with_call_policy=with_call_policy, ChaosEvent=ChaosEvent,
        compile_lb=getattr(compiler, "compile_lb", None),
    )
    flagship = ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))
    build_s = {}
    runs = chip_smoke.main_path_runs(port, flagship, build_s=build_s)
    if port.compile_lb is not None:
        runs += [run[:5] for run in chip_smoke.lb_runs(port)]
    else:
        print("no lb laws in this package: the lb runs are skipped",
              flush=True)
    chip_smoke.main_path_phase(port, runs, build_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
