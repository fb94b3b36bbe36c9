"""Host time per block of the port's unprotected runs, at a tiny block.

    python3 tools/torch_host_time.py [--root DIR] [--device cpu] [--reps R]

Runs star-10k with 30 s timeouts and ``1000-svc_2000-end`` open loop, as
``chip_smoke.py`` phase 5 configures them, through ``run_blocks`` with no
recorder or control law, at a block of a few requests, so that a block's
time is the host's: the Python of the block loop and the dispatch of its
torch ops.  Prints, per run, the ops a block dispatches and the median
and the least time per block over ``--reps`` blocks.  ``--root`` imports
``isotope_tpu_torch`` from another checkout (default: this one), so that
two versions can be timed in turns on one host.  Runs on the CPU; needs
no card.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time
from types import SimpleNamespace

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: requests of a timed block
BLOCK = 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--reps", type=int, default=40)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tools.torch_op_count import OpLog

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws

    import isotope_tpu_torch

    torch.set_num_threads(1)
    package = pathlib.Path(isotope_tpu_torch.__file__).resolve().parent
    print(f"isotope_tpu_torch from {package}", flush=True)
    port = SimpleNamespace(ServiceGraph=ServiceGraph,
                           realistic_topology=realistic_topology,
                           with_call_policy=with_call_policy)
    runs = (
        ("star-10k-timeouts", chip_smoke.star10k_graph(port),
         chip_smoke.STAR10K_QPS),
        ("1000-svc_2000-end", ServiceGraph.from_yaml_file(
            chip_smoke.TOPOLOGIES / "1000-svc_2000-end.yaml"), 1e4),
    )
    for name, graph, qps in runs:
        sim = Simulator(compile_graph(graph), device=args.device)
        load = LoadModel(kind="open", qps=qps)
        source = TorchDraws(0, sim.device)
        blocks = sim.run_blocks(load, BLOCK * (args.reps + 2), source,
                                block_size=BLOCK)
        next(blocks)  # the caches
        with OpLog() as ops:
            next(blocks)
        times = []
        for _ in range(args.reps):
            t = time.perf_counter()
            res = next(blocks)
            if res.client_latency.is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        print(f"host {name}: {ops.count} ops a block of {BLOCK}; "
              f"{statistics.median(times):.3f} ms median, "
              f"{min(times):.3f} ms least a block over {args.reps}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
