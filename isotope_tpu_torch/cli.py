"""``python -m isotope_tpu_torch simulate|check|timeline TOPOLOGY``.

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
  ``--rollouts-out`` write its document.  ``--attribution [tail]`` makes
  the main run the attributed one (``Simulator.run_attributed``, or the
  protected runs' ``attribution=True``: the same draws and blocking, so
  the same summary) and prints the critical-path blame table;
  ``--blame-out``, ``--flamegraph``, ``--perfetto-blame`` and
  ``--exemplar-trace`` write its documents.  ``--trace`` re-runs a small
  dense batch and writes its spans (``metrics/trace.py``), and
  ``--timeline-perfetto`` the recorder's counter tracks.  The JAX
  command's other flags raise ``NotImplementedError`` naming their
  ROADMAP item.
- ``check``: the run's Prometheus series (``MetricsCollector``) are
  queried by the reference's stability alarm suite; every alarm is
  printed to stderr and the exit code is 1 when one fires.
- ``timeline``: one recorded run reported as windowed series, with the
  stability alarms per window (``--alarms``: the first breach's
  sim-time onset, exit code 1) and a config push's convergence projected
  onto the same windows (``--controlplane N:M:P``,
  ``sim/controlplane.py``).

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
_FLEETS = "item 9, fleets"
_MULTI, _SERVICES = "item 11, multi-GPU", "item 12, framework services"
_REFUSED = [
    ("--flat", dict(action="store_true"), "item 10, runner and CLI"),
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
    s.add_argument("--trace", metavar="FILE",
                   help="write sampled per-request spans here (the "
                        "reference's OTel->Jaeger tracing, "
                        "service/main.go:76-109)")
    s.add_argument("--trace-format", choices=["chrome", "jaeger"],
                   default="chrome")
    s.add_argument("--trace-requests", type=int, default=32,
                   help="how many requests to trace (sampled dense run)")
    s.add_argument("--attribution", nargs="?", const="on",
                   choices=("on", "tail"), default=None,
                   help="critical-path blame attribution: the main run "
                        "also reduces per-service/per-edge blame on the "
                        "device and prints the blame table.  'tail' also "
                        "accumulates conditional-tail blame past an "
                        "estimated p99 cut and mines top-K slow "
                        "exemplars")
    s.add_argument("--blame-out", metavar="FILE", default=None,
                   help="write the blame tables as JSON (isotope-blame/v1)")
    s.add_argument("--flamegraph", metavar="FILE", default=None,
                   help="write the critical-path blame as a "
                        "collapsed-stack flamegraph file "
                        "(flamegraph.pl / speedscope input)")
    s.add_argument("--perfetto-blame", metavar="FILE", default=None,
                   help="write per-service blame-distribution counter "
                        "tracks as Perfetto/Chrome trace JSON")
    s.add_argument("--exemplar-trace", metavar="FILE", default=None,
                   help="write the mined top-K slowest requests as a "
                        "distributed trace (tail_rank/tail_cut annotated "
                        "spans; no dense re-run)")
    s.add_argument("--exemplar-format", choices=["chrome", "jaeger"],
                   default="jaeger")
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
    s.add_argument("--timeline-perfetto", metavar="FILE", default=None,
                   help="write the windowed series as Perfetto/Chrome "
                        "counter tracks over real sim time")
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
    _add_timeline_parser(sub)
    return parser


def _add_timeline_parser(sub) -> None:
    t = sub.add_parser(
        "timeline",
        help="record a run as windowed per-service time series",
    )
    t.add_argument("topology", help="path to the service graph YAML")
    t.add_argument("--qps", default="1000",
                   help='target QPS, or "max" (fortio -qps max)')
    t.add_argument("--connections", "-c", type=int, default=64)
    t.add_argument("--duration", "-t", default="240s",
                   help='run duration, e.g. "240s" or "5m"')
    t.add_argument("--load-kind", choices=["open", "closed"],
                   default="open")
    t.add_argument("--max-requests", type=int, default=200_000)
    t.add_argument("--window", "-w", default="10s",
                   help="sim-time window width (the scrape interval)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--entry", default=None,
                   help="entrypoint service override")
    t.add_argument("--out", metavar="FILE", default=None,
                   help="write the isotope-timeline/v1 JSON artifact")
    t.add_argument("--perfetto", metavar="FILE", default=None,
                   help="write Perfetto/Chrome counter tracks over "
                        "real sim time")
    t.add_argument("--prometheus", metavar="FILE", default=None,
                   help="write the timestamped Prometheus exposition "
                        "(one sample per window)")
    t.add_argument("--json", action="store_true",
                   help="print the timeline doc as JSON instead of "
                        "the table")
    t.add_argument("--alarms", action="store_true",
                   help="evaluate the standard stability alarms per "
                        "window and report the first breach's sim-time "
                        "onset")
    t.add_argument("--alarm-sink", metavar="FILE", default=None,
                   help="append per-window MonitorStatus rows to this "
                        "JSONL sink (with --alarms)")
    # the per-window CPU series is the BUSY OCCUPANCY integral (server
    # time incl. script sleeps and downstream blocking), an upper bound
    # on CPU burn: the defaults are sized in occupancy terms (one core)
    t.add_argument("--cpu-limit", type=float, default=1000.0,
                   help="per-service CPU-OCCUPANCY alarm threshold, "
                        "milli-cores (busy time incl. sleeps and "
                        "downstream blocking; default = 1 core)")
    t.add_argument("--mem-limit", type=float, default=1024.0,
                   help="per-service working-set alarm threshold, MiB")
    t.add_argument("--controlplane", metavar="N:M:P", default=None,
                   help="co-simulate a config push (N entries x M "
                        "endpoints to P proxies) onto the same window "
                        "axis")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    t.set_defaults(func=run_timeline_cmd)


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
        attribution=args.attribution is not None,
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
    tl = pol = roll = attr = None
    # an attributed main run: the same draws, blocking and (protected)
    # trajectory as the plain one, so the same summary; errors raise
    attr_kw = dict(
        attribution=args.attribution is not None,
        tail=args.attribution == "tail",
    )
    if pol_t is not None or roll_t is not None:
        # the PROTECTED physics is the measurement: the main run is the
        # co-simulation, its block capped near one recorder window
        win, blk = protected_window_block(
            sim, load, block, params.timeline_window_s, tl_window
        )
        runner = sim.run_rollouts if roll_t is not None else sim.run_policies
        out = list(runner(load, n, source, block_size=blk,
                          collector=collector, trim=True, window_s=win,
                          **attr_kw))
        attr = out.pop() if attr_kw["attribution"] else None
        summary, tl = out[0], out[1]
        roll = out.pop(2) if roll_t is not None else None
        pol = out[2] if pol_t is not None else None
    else:
        if attr_kw["attribution"]:
            summary, attr = sim.run_attributed(
                load, n, source, block_size=block, collector=collector,
                trim=True, tail=attr_kw["tail"],
            )
        else:
            summary = sim.run_summary(load, n, source, block_size=block,
                                      collector=collector, trim=True)
        if tl_window is not None:
            # the recorder pass: the main run's draws and blocking
            _, tl = sim.run_timeline(load, n, source, block_size=block,
                                     trim=True, window_s=tl_window)
    if attr is not None:
        _write_attribution_artifacts(args, compiled, attr)
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
        if args.timeline_perfetto:
            from isotope_tpu_torch.metrics.export import (
                write_timeline_perfetto,
            )

            ev = write_timeline_perfetto(args.timeline_perfetto, compiled,
                                         tl)
            print(f"timeline counters ({ev} events) -> "
                  f"{args.timeline_perfetto}", file=sys.stderr)
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
    if args.trace:
        from isotope_tpu_torch.metrics.trace import write_trace

        # traces are sampled: a small dense batch of the same model (the
        # reference's plain Simulator: no lb, policy or rollout tables)
        res = Simulator(compiled, params, device=sim.device).run(
            load, args.trace_requests, TorchDraws(args.seed, sim.device)
        )
        traced = write_trace(args.trace, compiled, res,
                             fmt=args.trace_format)
        print(f"traced {traced} requests -> {args.trace}", file=sys.stderr)
    return 0


def _write_attribution_artifacts(args, compiled, attr) -> None:
    """The blame table to stderr and the attributed run's documents."""
    from isotope_tpu_torch.metrics import attribution as attr_mod
    from isotope_tpu_torch.metrics.export import (
        write_flamegraph,
        write_perfetto_counters,
    )

    doc = attr_mod.to_doc(compiled, attr)
    _emit(doc, attr_mod.format_table, args.blame_out, "blame tables")
    if args.flamegraph:
        lines = write_flamegraph(args.flamegraph, compiled, attr)
        print(f"flamegraph ({lines} stacks) -> {args.flamegraph}",
              file=sys.stderr)
    if args.perfetto_blame:
        n = write_perfetto_counters(args.perfetto_blame, compiled, attr)
        print(f"perfetto counters ({n} events) -> {args.perfetto_blame}",
              file=sys.stderr)
    if args.exemplar_trace:
        if attr.exemplars is None:
            print("warning: no exemplars mined (attribution_top_k == 0)",
                  file=sys.stderr)
            return
        from isotope_tpu_torch.metrics.trace import write_trace

        traced = write_trace(args.exemplar_trace, compiled,
                             fmt=args.exemplar_format, exemplars=attr)
        print(f"traced {traced} tail exemplars -> {args.exemplar_trace}",
              file=sys.stderr)


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


def run_timeline_cmd(args) -> int:
    import dataclasses

    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics import timeline as timeline_mod
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import SimParams, Simulator, TorchDraws

    window_s = dur.parse_duration_seconds(args.window)
    compiled = compile_graph(
        ServiceGraph.from_yaml_file(args.topology), entry=args.entry
    )
    sim = Simulator(
        compiled,
        dataclasses.replace(
            SimParams(), timeline=True, timeline_window_s=window_s
        ),
        device=args.device,
    )
    load = _load(args)
    rate = load.qps if load.qps is not None else sim.capacity_qps()
    n = max(1, min(int(rate * load.duration_s), args.max_requests))
    _, tl = sim.run_timeline(load, n, TorchDraws(args.seed, sim.device),
                             block_size=sim.default_block_size())

    controlplane = None
    if args.controlplane:
        from isotope_tpu_torch.sim.controlplane import (
            PilotModel,
            push_convergence,
        )

        try:
            n_e, m_e, p_e = (int(x) for x in args.controlplane.split(":"))
        except ValueError:
            raise ValueError(
                f"--controlplane wants N:M:P integers, got "
                f"{args.controlplane!r}"
            )
        conv = push_convergence(PilotModel(), n_e, m_e, p_e,
                                seed=args.seed, device=sim.device)
        controlplane = conv.window_series(float(tl.window_s),
                                          tl.num_windows)

    doc = timeline_mod.to_doc(compiled, tl, controlplane=controlplane)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"timeline -> {args.out}", file=sys.stderr)
    if args.perfetto:
        from isotope_tpu_torch.metrics.export import write_timeline_perfetto

        ev = write_timeline_perfetto(args.perfetto, compiled, tl)
        print(f"timeline counters ({ev} events) -> {args.perfetto}",
              file=sys.stderr)
    if args.prometheus:
        with open(args.prometheus, "w") as f:
            f.write(timeline_mod.prometheus_text(compiled, tl))
        print(f"timestamped exposition -> {args.prometheus}",
              file=sys.stderr)

    if args.json:
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        print(timeline_mod.format_table(doc))
        if controlplane is not None:
            frac = controlplane["converged_fraction"]
            print(
                f"controlplane: push converged in window "
                f"{controlplane['converged_window']} "
                f"({controlplane['proxies']} proxies) "
                f"{timeline_mod.sparkline(frac)}"
            )

    rc = 0
    if args.alarms:
        from isotope_tpu_torch.metrics import monitor
        from isotope_tpu_torch.metrics.alarms import standard_queries

        label = pathlib.Path(args.topology).stem
        queries = standard_queries(
            label, cpu_lim=args.cpu_limit, mem_lim=args.mem_limit
        )
        rows = monitor.evaluate_windows(
            queries, timeline_mod.window_stores(compiled, tl),
            run_label=label,
        )
        if args.alarm_sink:
            monitor.MonitorSink(args.alarm_sink).write(rows)
            print(f"{len(rows)} monitor rows -> {args.alarm_sink}",
                  file=sys.stderr)
        onset = monitor.first_alarm_onset(rows)
        n_alarms = sum(1 for r in rows if r.status == monitor.STATUS_ALARM)
        if onset is not None:
            print(
                f"ALARM onset at window {onset.window_index} "
                f"(t={onset.sim_time_s:g}s): {onset.monitor} = "
                f"{onset.value:g} ({n_alarms} alarming "
                f"window-checks total)",
                file=sys.stderr,
            )
            rc = 1
        else:
            print("alarms: all windows clean", file=sys.stderr)
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
