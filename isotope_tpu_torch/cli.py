"""``python -m isotope_tpu_torch simulate|check TOPOLOGY``.

The port of ``isotope-tpu simulate`` and ``isotope-tpu check`` for the
main path:

- ``simulate``: the topology is compiled, simulated in blocks on the
  device and summarized, and the Fortio-style result JSON is printed.
  The load flags and their defaults are the JAX command's (closed loop,
  64 connections, 1000 qps, 240 s); ``--qps max`` is Fortio's saturated
  closed loop; ``--environment`` picks a sidecar mode of
  ``runner/config.DEFAULT_ENVIRONMENTS`` (``NONE`` by default, ``ISTIO``
  adds the client and server proxy passes to every edge).  A
  topology's per-service ``lb:`` laws (``policies:`` block, ``sim/lb.py``)
  apply on every run, with no flag, as in the reference; an active law
  prints its table to stderr, ``--lb-out`` writes it as JSON, and
  ``--qps max`` is refused under one.  ``--timeline [WINDOW]`` adds the
  flight recorder's pass (``metrics/timeline.py``); ``--policies`` and
  ``--rollouts`` make the main run the protected co-simulation
  (``sim/policies.py``, ``sim/rollout.py``), its block capped near one
  recorder window (``runner/run.protected_window_block``); each prints
  its table to stderr and ``--timeline-out``, ``--policies-out`` and
  ``--rollouts-out`` write its document.  The JAX command's other flags
  raise ``NotImplementedError`` naming their ROADMAP item.
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


# the JAX command's flags whose layers are not ported: each raises
# NotImplementedError naming its ROADMAP item
_OBS, _FLEETS = "item 8, observability", "item 9, fleets"
_MULTI, _SERVICES = "item 11, multi-GPU", "item 12, framework services"
_REFUSED = [
    ("--flat", dict(action="store_true"), "item 10, runner and CLI"),
    ("--trace", dict(metavar="FILE"), _OBS),
    ("--trace-format", dict(), _OBS),
    ("--trace-requests", dict(type=int), _OBS),
    ("--attribution", dict(nargs="?", const="on"), _OBS),
    ("--blame-out", dict(metavar="FILE"), _OBS),
    ("--flamegraph", dict(metavar="FILE"), _OBS),
    ("--perfetto-blame", dict(metavar="FILE"), _OBS),
    ("--exemplar-trace", dict(metavar="FILE"), _OBS),
    ("--exemplar-format", dict(), _OBS),
    ("--timeline-perfetto", dict(metavar="FILE"), _OBS),
    ("--ensemble", dict(type=int), _FLEETS),
    ("--ensemble-jitter", dict(), _FLEETS),
    ("--ensemble-slo", dict(), _FLEETS),
    ("--ensemble-chaos-jitter", dict(), _FLEETS),
    ("--ensemble-split", dict(), _FLEETS),
    ("--split-horizon", dict(type=float), _FLEETS),
    ("--ensemble-out", dict(metavar="FILE"), _FLEETS),
    ("--mesh", dict(), _MULTI),
    ("--overlap", dict(action="store_true"), _MULTI),
    ("--telemetry", dict(nargs="?", const="on"), _SERVICES),
    ("--telemetry-out", dict(metavar="FILE"), _SERVICES),
    ("--max-retries", dict(type=int), _SERVICES),
    ("--no-degrade", dict(action="store_true"), _SERVICES),
    ("--vet", dict(nargs="?", const="on"), "item 13, static analysis"),
]


def _refuse_unported(args) -> None:
    for flag, _, item in _REFUSED:
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            raise NotImplementedError(
                f"simulate {flag} is not ported to isotope_tpu_torch yet "
                f"(ROADMAP.md queue 1: {item})"
            )


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
    s.add_argument("--service-time-param", type=float, default=None,
                   help="lognormal sigma / pareto alpha")
    s.add_argument("--cpu-time", default=None,
                   help='per-request CPU demand, e.g. "77us"')
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="accepted for the JAX command's sake and ignored: "
                        "it configures XLA's compilation cache")
    s.add_argument("--labels", default="")
    s.add_argument("--entry", default=None,
                   help="entrypoint service (for multi-instance "
                        "topologies; default: the first entrypoint)")
    s.add_argument("--prometheus", metavar="FILE",
                   help="also write the Prometheus text exposition here")
    s.add_argument("--timeline", nargs="?", const="10s", default=None,
                   metavar="WINDOW",
                   help="simulation flight recorder: after the main run, "
                        "a timeline pass (identical request streams) bins "
                        "every hop event into fixed sim-time windows on "
                        "the device and reports per-service x per-window "
                        "series plus the convoy detector.  Optional value "
                        "= window width (default 10s)")
    s.add_argument("--timeline-out", metavar="FILE", default=None,
                   help="write the windowed series as JSON "
                        "(isotope-timeline/v1)")
    s.add_argument("--timeline-prometheus", metavar="FILE", default=None,
                   help="write the timestamped Prometheus exposition "
                        "(one sample per window, like a scrape sequence)")
    s.add_argument("--policies", action="store_true",
                   help="co-simulate the topology's `policies:` block "
                        "(circuit breakers, retry budgets, outlier "
                        "ejection, HPA autoscalers) in the block loop: "
                        "the MAIN run becomes the PROTECTED system, "
                        "reacting window by window to the flight "
                        "recorder's signals (implies --timeline)")
    s.add_argument("--policies-out", metavar="FILE", default=None,
                   help="write the policy actuation series as JSON "
                        "(isotope-policies/v1)")
    s.add_argument("--rollouts", action="store_true",
                   help="co-simulate the topology's `rollouts:` block "
                        "(reactive canary rollouts: PROMOTE on passing "
                        "SLO gates, HOLD while samples are short, ROLL "
                        "BACK on a gate trip) in the block loop (implies "
                        "--timeline; composes with --policies)")
    s.add_argument("--rollouts-out", metavar="FILE", default=None,
                   help="write the rollout trajectory as JSON "
                        "(isotope-rollout/v1)")
    for flag, kw, _ in _REFUSED:
        s.add_argument(flag, **kw)
    s.add_argument("--lb-out", metavar="FILE", default=None,
                   help="write the load-balancing laws and their static "
                        "per-backend load split as JSON (isotope-lb/v1); "
                        "laws come from the topology's per-service `lb:` "
                        "entries and apply to EVERY run kind (no flag "
                        "needed)")
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
    from isotope_tpu_torch.compiler import (
        compile_graph,
        compile_lb,
        compile_policies,
        compile_rollouts,
    )
    from isotope_tpu_torch.metrics.fortio import fortio_result_from_summary
    from isotope_tpu_torch.metrics.prometheus import MetricsCollector
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.runner.run import (
        num_requests,
        protected_window_block,
        run_label,
    )
    from isotope_tpu_torch.sim import SimParams, Simulator, TorchDraws
    from isotope_tpu_torch.sim import lb as lb_mod

    _refuse_unported(args)
    if args.compile_cache is not None:
        print("note: --compile-cache configures XLA's compilation cache; "
              "the torch port has none and ignores it", file=sys.stderr)
    if args.environment not in DEFAULT_ENVIRONMENTS:
        raise ValueError(
            f"unknown environment {args.environment!r} "
            f"(expected one of {sorted(DEFAULT_ENVIRONMENTS)})"
        )
    env = DEFAULT_ENVIRONMENTS[args.environment]
    defaults = SimParams()
    if args.service_time_param is not None:
        stp = args.service_time_param
    elif args.service_time == "pareto":
        stp = 1.5  # the reference CLI's heavy-tail default
    else:
        stp = defaults.service_time_param
    tl_window = (
        None if args.timeline is None
        else dur.parse_duration_seconds(args.timeline)
    )
    params = env.apply(SimParams(
        cpu_time_s=(
            defaults.cpu_time_s if args.cpu_time is None
            else dur.parse_duration_seconds(args.cpu_time)
        ),
        service_time=args.service_time,
        service_time_param=stp,
        # the policy/rollout loops observe through the recorder
        timeline=tl_window is not None or args.policies or args.rollouts,
    ))
    load = _load(args)
    graph = ServiceGraph.from_yaml_file(args.topology)
    compiled = compile_graph(graph, entry=args.entry)
    # a declared lb law is the data plane being measured, on every run
    lb = compile_lb(graph, compiled)
    pol_t = compile_policies(graph, compiled) if args.policies else None
    roll_t = compile_rollouts(graph, compiled) if args.rollouts else None
    sim = Simulator(compiled, params, policies=pol_t, rollouts=roll_t,
                    lb=lb, device=args.device)
    collector = MetricsCollector(compiled)
    n = num_requests(load, sim.capacity_qps(), args.max_requests)
    block = sim.default_block_size()
    source = TorchDraws(args.seed, sim.device)
    tl = pol = roll = None
    if pol_t is not None or roll_t is not None:
        # the PROTECTED physics is the measurement: the main run is the
        # co-simulation, its block capped near one recorder window
        win, blk = protected_window_block(
            sim, load, block, params.timeline_window_s, tl_window
        )
        runner = sim.run_rollouts if roll_t is not None else sim.run_policies
        out = list(runner(load, n, source, block_size=blk,
                          collector=collector, trim=True, window_s=win))
        summary, tl = out[0], out[1]
        roll = out.pop(2) if roll_t is not None else None
        pol = out[2] if pol_t is not None else None
    else:
        summary = sim.run_summary(load, n, source, block_size=block,
                                  collector=collector, trim=True)
        if tl_window is not None:
            # the recorder pass: the main run's draws and blocking
            _, tl = sim.run_timeline(load, n, source, block_size=block,
                                     trim=True, window_s=tl_window)
    if args.policies and pol is not None:
        from isotope_tpu_torch.sim import policies as policies_mod

        _emit(policies_mod.to_doc(compiled, pol, pol_t),
              policies_mod.format_table, args.policies_out, "policies")
    elif args.policies:
        print("warning: --policies set but the topology declares no "
              "policies block (unprotected run)", file=sys.stderr)
    if args.rollouts and roll is not None:
        from isotope_tpu_torch.sim import rollout as rollout_mod

        _emit(rollout_mod.to_doc(compiled, roll, roll_t),
              rollout_mod.format_table, args.rollouts_out, "rollouts")
    elif args.rollouts:
        print("warning: --rollouts set but the topology declares no "
              "active rollouts block (open-loop run)", file=sys.stderr)
    if lb is not None and lb.active:
        _emit(lb_mod.to_doc(lb, tl=tl, pol=pol), lb_mod.format_table,
              args.lb_out, "lb")
    elif args.lb_out:
        print(
            "warning: --lb-out set but the topology declares no "
            "lb entries (fifo everywhere)",
            file=sys.stderr,
        )
    if tl is not None:
        from isotope_tpu_torch.metrics import timeline as timeline_mod

        _emit(timeline_mod.to_doc(compiled, tl), timeline_mod.format_table,
              args.timeline_out, "timeline")
        if args.timeline_prometheus:
            with open(args.timeline_prometheus, "w") as f:
                f.write(timeline_mod.prometheus_text(compiled, tl))
            print(f"timestamped exposition -> {args.timeline_prometheus}",
                  file=sys.stderr)
    entry = compiled.entry_service
    doc = fortio_result_from_summary(
        summary, load,
        labels=run_label(args.topology, env.name, load, args.labels),
        response_size_bytes=float(compiled.services.response_size[entry]),
    )
    json.dump(doc, sys.stdout, indent=2)
    sys.stdout.write("\n")
    if args.prometheus:
        with open(args.prometheus, "w") as f:
            f.write(collector.full_text(summary))
    return 0


def _emit(doc: dict, table, path, what: str) -> None:
    """A layer's table to stderr and, with ``path``, its JSON document."""
    print(table(doc), file=sys.stderr)
    if path:
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"{what} -> {path}", file=sys.stderr)


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
