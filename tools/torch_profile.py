"""Where a block's device time goes in the PyTorch port, on one CUDA card.

    python3 tools/torch_profile.py [--qps Q] [--out PROFILE.json]

Runs the flagship tree (5 levels x 3 branches, 121 hops, 1 KiB
payloads) open loop through ``Simulator.run_summary`` in blocks of
262,144 requests: one warm-up block, then two blocks under
``torch.profiler`` with CPU and CUDA activities.  Prints the card's name
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
BLOCK = 262_144


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--qps", type=float, default=1e5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.generators import tree_topology
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sim = Simulator(compile_graph(ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))), device="cuda")
    load = LoadModel(kind="open", qps=args.qps)
    source = TorchDraws(0, "cuda")
    sim.run_summary(load, BLOCK, source, block_size=BLOCK)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sim.run_summary(load, 2 * BLOCK, source, block_size=BLOCK)
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
        "block_requests": BLOCK,
        "blocks": 2,
        "qps": args.qps,
        "wall_ms_per_block": wall / 2 * 1e3,
        "device_ms_per_block": device_total / 2 * 1e3,
        "device_idle_share": max(0.0, 1.0 - device_total / wall),
        "top_ops": top,
    }
    if not events:
        print("torch_profile: the profiler recorded no device events",
              file=sys.stderr)
    print(card)
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
