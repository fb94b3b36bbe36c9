"""Where a block's device time goes in the PyTorch port, on one CUDA card.

    python3 tools/torch_profile.py [--config C] [--qps Q]
        [--attribution {mean,tail}] [--out PROFILE.json]

Runs one configuration open loop through ``Simulator.run_summary``: the
flagship tree (5 levels x 3 branches, 121 hops, 1 KiB payloads) at
100k qps in blocks of 262,144 requests (``--config flagship``, the
default), or svc100k-chaos (BASELINE configs[4]: the 100,000-service
multitier graph, Pareto service times, ``mock-7`` down in [5 s, 15 s))
at 100 qps in blocks of its default 335 (``--config svc100k-chaos``):
one warm-up block, then two blocks under ``torch.profiler`` with CPU
and CUDA activities.  ``--attribution`` runs the same blocks through
``Simulator.run_attributed`` (``SimParams(attribution=True)``; ``tail``
arms the tail accumulators at a cut taken from the pilot before the
profiled blocks), so the blame sweep's share of the block shows.  Prints the card's name
and power limit, the wall time per block, the summed device time of
all kernels, the device idle share (1 - device time / wall time) and
the 15 kernels with the most device time, and with ``--out`` writes the
same as JSON.  Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_BLOCK = 262_144


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--config", choices=("flagship", "svc100k-chaos"),
                        default="flagship")
    parser.add_argument("--attribution", choices=("mean", "tail"),
                        default=None)
    parser.add_argument("--qps", type=float, default=None,
                        help="open-loop rate (default: 100k for the "
                             "flagship, 100 for svc100k-chaos)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        tree_topology,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import (
        LoadModel,
        SimParams,
        Simulator,
        TorchDraws,
    )
    from isotope_tpu_torch.sim.config import ChaosEvent

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    attributed = args.attribution is not None
    if args.config == "flagship":
        sim = Simulator(compile_graph(ServiceGraph.decode(tree_topology(
            num_levels=5, num_branches=3, request_size=1024,
            response_size=1024,
        ))), SimParams(attribution=attributed), device="cuda")
        block, qps = FLAGSHIP_BLOCK, 1e5
    else:
        sim = Simulator(
            compile_graph(ServiceGraph.decode(realistic_topology(
                100_000, archetype="multitier", seed=0
            ))),
            SimParams(service_time="pareto", service_time_param=2.5,
                      attribution=attributed),
            (ChaosEvent("mock-7", 5.0, 15.0),),
            device="cuda",
        )
        block, qps = sim.default_block_size(), 100.0
    load = LoadModel(kind="open", qps=args.qps or qps)
    source = TorchDraws(0, "cuda")
    if attributed:
        tail = args.attribution == "tail"
        cut = (sim.estimate_tail_cut(load, 2 * block, source,
                                     block_size=block) if tail else None)

        def run(n):
            sim.run_attributed(load, n, source, block_size=block,
                               tail=tail, tail_cut=cut)
    else:
        def run(n):
            sim.run_summary(load, n, source, block_size=block)
    run(block)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(2 * block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # the kernels themselves (device-side events), so that no time is
    # counted twice through the operator that launched them
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(events, key=device_us, reverse=True)
    device_total = sum(device_us(e) for e in events) / 1e6
    top = [
        {"name": e.key, "device_ms": device_us(e) / 1e3,
         "calls": e.count}
        for e in rows[:15]
    ]
    doc = {
        "card": card,
        "config": args.config,
        "attribution": args.attribution,
        "block_requests": block,
        "blocks": 2,
        "qps": load.qps,
        "wall_ms_per_block": wall / 2 * 1e3,
        "device_ms_per_block": device_total / 2 * 1e3,
        "device_idle_share": max(0.0, 1.0 - device_total / wall),
        "top_ops": top,
    }
    if not events:
        print("torch_profile: the profiler recorded no device events",
              file=sys.stderr)
    print(card)
    print(f"{args.config}, attribution {args.attribution}")
    print(f"wall {doc['wall_ms_per_block']:.3f} ms/block, device "
          f"{doc['device_ms_per_block']:.3f} ms/block, idle share "
          f"{doc['device_idle_share']:.3f} (profiler on)")
    for row in top:
        print(f"  {row['device_ms'] / 2:9.3f} ms/block  {row['calls'] // 2:5d}"
              f" calls/block  {row['name'][:90]}")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
