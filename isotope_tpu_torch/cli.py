"""``python -m isotope_tpu_torch simulate TOPOLOGY``: one labeled run.

The port of ``isotope-tpu simulate`` for the main path: the topology is
compiled, simulated in blocks on the device and summarized, and the
Fortio-style result JSON is printed.  The load flags and their defaults
are the JAX command's (closed loop, 64 connections, 1000 qps, 240 s);
``--device`` picks the device (``cuda`` by default).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from isotope_tpu_torch.utils import duration as dur


def _label(topo_path: str, load) -> str:
    """The reference's run label, in its NONE (no sidecar) environment."""
    stem = pathlib.Path(topo_path).stem
    return f"{stem}_none_{load.qps:g}qps_{load.connections}c"


def _num_requests(load, capacity: float, cap: int) -> int:
    """Size the batch so the simulated run spans ``load.duration_s``."""
    rate = capacity if load.qps is None else min(load.qps, capacity)
    return max(1, min(int(rate * load.duration_s), cap))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="isotope-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    s = sub.add_parser(
        "simulate", help="simulate one topology under one load"
    )
    s.add_argument("topology", help="path to the service graph YAML")
    s.add_argument("--qps", default="1000",
                   help='target QPS ("max" is not ported yet)')
    s.add_argument("--connections", "-c", type=int, default=64)
    s.add_argument("--duration", "-t", default="240s",
                   help='run duration, e.g. "240s" or "5m"')
    s.add_argument("--load-kind", choices=["open", "closed"],
                   default="closed",
                   help="closed = fortio workers; open = Poisson arrivals")
    s.add_argument("--max-requests", type=int, default=1_000_000)
    s.add_argument("--service-time",
                   choices=["exponential", "deterministic", "lognormal",
                            "pareto"],
                   default="exponential",
                   help="per-request CPU-time distribution")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    s.set_defaults(func=run_simulate)
    return parser


def run_simulate(args) -> int:
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics.fortio import fortio_result_from_summary
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import (
        LoadModel,
        SimParams,
        Simulator,
        TorchDraws,
    )

    if args.qps == "max":
        raise NotImplementedError(
            "--qps max (the saturated closed loop, sim/closed.py) is not "
            "ported to isotope_tpu_torch yet (ROADMAP.md queue 1: closed "
            "loop)"
        )
    params = SimParams(
        service_time=args.service_time,
        # the reference CLI's heavy-tail default for pareto
        service_time_param=1.5 if args.service_time == "pareto" else 1.0,
    )
    load = LoadModel(
        kind=args.load_kind,
        qps=float(args.qps),
        connections=args.connections,
        duration_s=dur.parse_duration_seconds(args.duration),
    )
    graph = ServiceGraph.from_yaml_file(args.topology)
    compiled = compile_graph(graph)
    sim = Simulator(compiled, params, device=args.device)
    n = _num_requests(load, sim.capacity_qps(), args.max_requests)
    summary = sim.run_summary(
        load, n, TorchDraws(args.seed, sim.device),
        block_size=sim.default_block_size(), trim=True,
    )
    entry = compiled.entry_service
    doc = fortio_result_from_summary(
        summary, load, labels=_label(args.topology, load),
        response_size_bytes=float(compiled.services.response_size[entry]),
    )
    json.dump(doc, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
