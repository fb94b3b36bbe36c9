"""``python -m isotope_tpu_torch simulate|check TOPOLOGY``.

The port of ``isotope-tpu simulate`` and ``isotope-tpu check`` for the
main path:

- ``simulate``: the topology is compiled, simulated in blocks on the
  device and summarized, and the Fortio-style result JSON is printed.
  The load flags and their defaults are the JAX command's (closed loop,
  64 connections, 1000 qps, 240 s); ``--qps max`` is Fortio's saturated
  closed loop; ``--environment`` picks a sidecar mode of
  ``runner/config.DEFAULT_ENVIRONMENTS`` (``NONE`` by default, ``ISTIO``
  adds the client and server proxy passes to every edge).
- ``check``: the run's Prometheus series (``MetricsCollector``) are
  queried by the reference's stability alarm suite; every alarm is
  printed to stderr and the exit code is 1 when one fires.

``--device`` picks the device (``cuda`` by default).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from isotope_tpu_torch.utils import duration as dur


def _label(topo_path: str, env: str, load) -> str:
    """The reference's run label: topology stem, environment, load."""
    stem = pathlib.Path(topo_path).stem
    qps = "max" if load.qps is None else f"{load.qps:g}"
    return f"{stem}_{env.lower()}_{qps}qps_{load.connections}c"


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
                   help='target QPS, or "max" for the saturated closed loop')
    s.add_argument("--connections", "-c", type=int, default=64)
    s.add_argument("--duration", "-t", default="240s",
                   help='run duration, e.g. "240s" or "5m"')
    s.add_argument("--load-kind", choices=["open", "closed"],
                   default="closed",
                   help="closed = fortio workers; open = Poisson arrivals")
    s.add_argument("--environment", default="NONE",
                   help="NONE or ISTIO (adds the sidecar latency tax)")
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

    k = sub.add_parser(
        "check",
        help="simulate a topology and evaluate the stability alarm suite",
    )
    k.add_argument("topology")
    k.add_argument("--qps", default="1000")
    k.add_argument("--connections", "-c", type=int, default=64)
    k.add_argument("--duration", "-t", default="240s")
    k.add_argument("--load-kind", choices=["open", "closed"], default="open")
    k.add_argument("--max-requests", type=int, default=200_000)
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--cpu-limit", type=float, default=50.0,
                   help="per-service CPU alarm threshold, milli-cores "
                        "(the reference's load-test override is 250)")
    k.add_argument("--mem-limit", type=float, default=64.0,
                   help="per-service memory alarm threshold, MiB")
    k.add_argument("--debug", action="store_true",
                   help="print every query result")
    k.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    k.set_defaults(func=run_check)
    return parser


def run_simulate(args) -> int:
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics.fortio import fortio_result_from_summary
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.sim import SimParams, Simulator, TorchDraws

    if args.environment not in DEFAULT_ENVIRONMENTS:
        raise ValueError(
            f"unknown environment {args.environment!r} "
            f"(expected one of {sorted(DEFAULT_ENVIRONMENTS)})"
        )
    env = DEFAULT_ENVIRONMENTS[args.environment]
    params = env.apply(SimParams(
        service_time=args.service_time,
        # the reference CLI's heavy-tail default for pareto
        service_time_param=1.5 if args.service_time == "pareto" else 1.0,
    ))
    load = _load(args)
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
        summary, load, labels=_label(args.topology, env.name, load),
        response_size_bytes=float(compiled.services.response_size[entry]),
    )
    json.dump(doc, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0


def _load(args):
    from isotope_tpu_torch.sim import LoadModel

    return LoadModel(
        kind=args.load_kind,
        qps=None if args.qps == "max" else float(args.qps),
        connections=args.connections,
        duration_s=dur.parse_duration_seconds(args.duration),
    )


def run_check(args) -> int:
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics.alarms import (
        requests_sanity,
        run_queries,
        standard_queries,
        store_from_summary,
    )
    from isotope_tpu_torch.metrics.prometheus import MetricsCollector
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator, TorchDraws

    compiled = compile_graph(ServiceGraph.from_yaml_file(args.topology))
    load = _load(args)
    sim = Simulator(compiled, device=args.device)
    collector = MetricsCollector(compiled)
    rate = load.qps if load.qps is not None else sim.capacity_qps()
    n = max(1, min(int(rate * load.duration_s), args.max_requests))
    summary = sim.run_summary(
        load, n, TorchDraws(args.seed, sim.device),
        block_size=sim.default_block_size(), collector=collector,
    )
    label = pathlib.Path(args.topology).stem
    queries = standard_queries(
        label, cpu_lim=args.cpu_limit, mem_lim=args.mem_limit
    ) + [requests_sanity(label)]
    errors = run_queries(
        queries, store_from_summary(collector, summary), debug=args.debug,
        log=lambda m: print(m, file=sys.stderr),
    )
    for e in errors:
        print(f"ALARM: {e}", file=sys.stderr)
    print(
        f"{len(queries) - len(errors)}/{len(queries)} checks passed",
        file=sys.stderr,
    )
    return 1 if errors else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
