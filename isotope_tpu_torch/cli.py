"""``python -m isotope_tpu_torch simulate|check|sweep|timeline|search ...``.

The port of ``isotope-tpu``'s commands (``suite``, ``report``,
``telemetry``, ``fidelity``, ``ingest``, ``explain``, ``vet``,
``kubernetes``, ``graphviz``, ``security-policies``, ``generate``,
``pilot-load`` and ``plot`` live in ``commands/``):

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
  ``--timeline-perfetto`` the recorder's counter tracks.  ``--ensemble
  N`` serves the case as a Monte Carlo fleet (``sim/ensemble.py``; with
  ``--policies`` / ``--rollouts`` a protected fleet whose member 0 runs
  on the run's own draws, with ``--attribution`` / ``--timeline`` an
  observed one): the document pools the members, the ``ensemble:`` line
  gives the p99 band and, with ``--ensemble-slo``, the SLO-violation
  probability, ``--ensemble-out`` writes ``isotope-ensemble/v2``, and
  the tables and documents of the other flags are the worst member's.
  ``--ensemble-jitter`` perturbs the members' qps, cpu and error rates;
  ``--ensemble-chaos-jitter`` is parsed and, with no chaos schedule in
  ``simulate``, has nothing to jitter.  ``--ensemble-split SPEC``
  (``--split-horizon``) adds the importance-splitting estimate of the
  fleet's rare outage to the ensemble document's ``splitting`` block
  (``runner/run.splitting_pass``).  ``simulate`` is a one-case
  ``runner/run.run_experiment``, under the run supervisor
  (``--max-retries``, ``--no-degrade``); ``--flat`` prints the flat row
  and ``--telemetry`` the engine's own series.  ``--vet[=strict]``
  runs the pre-flight gate (``analysis/vet.py``) before the case.
  ``--mesh SPEC`` (``DATAxSVC[xSLICE]`` or ``data=..,svc=..,slice=..``;
  also ``$ISOTOPE_MESH``) serves the case on a device mesh of as many
  ranks (``parallel/``), launched as ``torchrun --standalone
  --nproc-per-node N -m isotope_tpu_torch ...``; only rank 0 prints.
  ``--overlap`` pipelines the mesh's metric merge behind the next
  block.  ``--mesh auto`` picks each topology's factorization by the
  layout search (``parallel/layout.py``) and prints it to stderr.
- ``sweep``: a TOML grid of topology x environment x load through
  ``run_experiment`` (checkpointed, resumable; ``--fresh``,
  ``--profile``, ``--export``; ``--mesh`` / ``--overlap`` as in
  ``simulate``).
- ``check``: the run's Prometheus series (``MetricsCollector``) are
  queried by the reference's stability alarm suite; every alarm is
  printed to stderr and the exit code is 1 when one fires.
- ``timeline``: one recorded run reported as windowed series, with the
  stability alarms per window (``--alarms``: the first breach's
  sim-time onset, exit code 1) and a config push's convergence projected
  onto the same windows (``--controlplane N:M:P``,
  ``sim/controlplane.py``).
- ``search``: one successive-halving bracket (``sim/search.py``) over a
  jittered candidate population of the topology; prints the per-rung
  survivor lineage and the winner's config, ``--out`` writes
  ``isotope-search/v1``.

``--device`` picks the device (``cuda`` by default).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from isotope_tpu_torch.commands.common import (
    add_resilience_args,
    add_telemetry_arg,
    add_vet_arg,
    arm_telemetry,
    ignore_compile_cache,
    resilience_policy,
)
from isotope_tpu_torch.parallel.mesh import rank_console
from isotope_tpu_torch.utils import duration as dur


def _add_mesh_args(parser) -> None:
    """The mesh-layout knobs (parallel/mesh.py), shared by simulate and
    sweep."""
    parser.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="device-mesh factorization for sharded runs, one rank per "
             "device (torchrun --standalone --nproc-per-node N -m "
             "isotope_tpu_torch ...): 'DATAxSVC[xSLICE]' (e.g. 4x2 or "
             "2x2x2 — the slice axis crosses hosts), or "
             "'data=4,svc=2,slice=1', or 'auto' (the layout search "
             "over the world's devices and hosts, against each "
             "topology's service count).  Also env $ISOTOPE_MESH; "
             "default: the TOML "
             "mesh_data/mesh_svc keys, else every rank on the data "
             "axis")
    parser.add_argument(
        "--overlap", action="store_true",
        help="overlap the sharded metric-merge collectives with the "
             "next request block's compute.  Identical results up to "
             "f32 reduction order; off by default.  Applies to the "
             "main summary run — the --attribution/--timeline passes "
             "keep their single post-scan merge")


def _add_ensemble_args(s) -> None:
    """The scenario-ensemble knobs (sim/ensemble.py, sim/splitting.py),
    shared by simulate and sweep."""
    s.add_argument(
        "--ensemble", type=int, default=None, metavar="N",
        help="Monte Carlo fleet: run the case as N members (member k "
             "draws from the run's source folded by seed k); the "
             "printed document pools the members, --ensemble-out "
             "writes per-member quantiles, quantile bands and the "
             "SLO-violation probability with a Wilson interval "
             "(isotope-ensemble/v2)")
    s.add_argument(
        "--ensemble-jitter", default=None, metavar="SPEC",
        help="per-member perturbations as axis=sigma pairs, e.g. "
             "'qps=0.1,cpu=0.05,error=0.2[,seed=K]': mean-preserving "
             "lognormal factors on the offered qps, per-request CPU "
             "demand, and per-hop error rates (deterministic per "
             "seed K)")
    s.add_argument(
        "--ensemble-slo", default=None, metavar="LATENCY",
        help="SLO latency (e.g. '250ms') the ensemble document's "
             "P(p99 > SLO) estimate targets")
    s.add_argument(
        "--ensemble-chaos-jitter", default=None, metavar="SPEC",
        help="per-member chaos schedules: jitter each member's kill "
             "timing / target / magnitude as key=value pairs, e.g. "
             "'time=0.2,magnitude=0.5,target=0.3[,seed=K]' (needs a "
             "TOML [chaos] schedule; simulate has none: there it is "
             "parsed and checked, as the JAX command does)")
    s.add_argument(
        "--ensemble-split", default=None, metavar="SPEC",
        help="importance splitting (multilevel) over the fleet: "
             "estimate a rare outage's probability, e.g. "
             "'levels=4,members=64,keep=0.25,threshold=0.5,"
             "sev=err_peak'; the estimate lands in the ensemble "
             "document's 'splitting' key")
    s.add_argument(
        "--split-horizon", default=None, type=float, metavar="FRAC",
        help="splitting screening-horizon fraction in (0, 1] "
             "(default 0.25): each splitting level simulates FRAC of "
             "the case's request count — overrides the 'horizon=' "
             "key of --ensemble-split")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="isotope-tpu-torch")
    sub = parser.add_subparsers(dest="command")
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
    s.add_argument("--flat", action="store_true",
                   help="print the flattened single-line record instead "
                        "of the full Fortio JSON")
    add_telemetry_arg(s, "appended to --prometheus output, a "
                          "telemetry.jsonl record, and a summary line on "
                          "stderr")
    s.add_argument("--telemetry-out", metavar="FILE",
                   default="telemetry.jsonl",
                   help="where --telemetry appends its JSONL record")
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
    _add_ensemble_args(s)
    s.add_argument("--ensemble-out", metavar="FILE", default=None,
                   help="write the ensemble's distributional summary "
                        "as JSON (isotope-ensemble/v2)")
    add_resilience_args(s)
    _add_mesh_args(s)
    add_vet_arg(s)
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
    _add_sweep_parser(sub)
    _add_timeline_parser(sub)
    _add_search_parser(sub)
    from isotope_tpu_torch.commands import (
        convert_cmd,
        explain_cmd,
        fidelity_cmd,
        generate_cmd,
        ingest_cmd,
        plot_cmd,
        report_cmd,
        suite_cmd,
        telemetry_cmd,
        vet_cmd,
    )

    suite_cmd.register(sub)
    report_cmd.register(sub)
    telemetry_cmd.register(sub)
    fidelity_cmd.register(sub)
    ingest_cmd.register(sub)
    explain_cmd.register(sub)
    convert_cmd.register(sub)
    generate_cmd.register(sub)
    generate_cmd.register_pilot(sub)
    plot_cmd.register(sub)
    vet_cmd.register(sub)
    return parser


def _add_sweep_parser(sub) -> None:
    w = sub.add_parser("sweep", help="run a TOML-configured experiment")
    w.add_argument("config",
                   help="experiment TOML (example-config.toml shape)")
    w.add_argument("--out", "-o", default="results",
                   help="output directory (default: ./results)")
    w.add_argument("--fresh", action="store_true",
                   help="ignore an existing checkpoint and rerun "
                        "everything (default: resume a killed sweep)")
    w.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="accepted for the JAX command's sake and ignored: "
                        "it configures XLA's compilation cache")
    w.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace per run into "
                        "DIR/<label>/trace.json (the reference's per-run "
                        "flame capture, runner.py:405-417)")
    w.add_argument("--export", action="append", default=[],
                   metavar="SPEC",
                   help="post-run exporter(s), e.g. "
                        "bigquery:project.dataset.table or "
                        "gcs:gs://bucket/path (the collector's upload "
                        "hook, fortio.py:235-242); repeatable")
    add_telemetry_arg(w, "in each .prom artifact plus "
                          "<out>/telemetry.jsonl")
    w.add_argument("--attribution", nargs="?", const="on",
                   choices=("on", "tail"), default=None,
                   help="critical-path blame attribution of every case "
                        "(<label>.blame.json, <label>.flame.txt)")
    w.add_argument("--timeline", nargs="?", const="10s", default=None,
                   metavar="WINDOW",
                   help="flight-recorder pass of every case "
                        "(<label>.timeline.json); value = window width")
    w.add_argument("--policies", action="store_true",
                   help="co-simulate the topologies' `policies:` blocks")
    w.add_argument("--rollouts", action="store_true",
                   help="co-simulate the topologies' `rollouts:` blocks")
    _add_ensemble_args(w)
    _add_mesh_args(w)
    add_vet_arg(w)
    add_resilience_args(w)
    w.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    w.set_defaults(func=run_sweep)


def run_sweep(args) -> int:
    """The JAX ``sweep``: a TOML grid of topology x environment x load
    through :func:`~isotope_tpu_torch.runner.run.run_experiment`."""
    import dataclasses

    from isotope_tpu_torch.runner.config import load_toml
    from isotope_tpu_torch.runner.run import run_experiment

    arm_telemetry(args.telemetry)
    ignore_compile_cache(args)
    config = load_toml(args.config)
    if args.mesh:
        config = dataclasses.replace(config, mesh_spec=args.mesh)
    if args.overlap and not config.overlap:
        config = dataclasses.replace(config, overlap=True)
    if args.attribution and not config.attribution:
        config = dataclasses.replace(config, attribution=True)
    if args.policies and not config.policies:
        config = dataclasses.replace(config, policies=True)
    if args.rollouts and not config.rollouts:
        config = dataclasses.replace(config, rollouts=True)
    ens_kw = _ensemble_config_kwargs(args)
    if ens_kw:
        config = dataclasses.replace(config, **ens_kw)
    tl_window = (
        None if args.timeline is None
        else dur.parse_duration_seconds(args.timeline)
    )
    if tl_window is None and config.timeline:
        # [sim] timeline = true in the TOML arms the pass without a flag
        tl_window = config.timeline_window_s
    if tl_window is not None and not config.timeline:
        config = dataclasses.replace(
            config, timeline=True, timeline_window_s=tl_window
        )
    results = run_experiment(
        config,
        out_dir=args.out,
        progress=lambda label: print(f"running {label}", file=sys.stderr),
        resume=not args.fresh,
        profile_dir=args.profile,
        export=args.export,
        policy=resilience_policy(args),
        vet=args.vet,
        attribution=args.attribution,
        timeline=tl_window,
        device=args.device,
    )
    discarded = [r.label for r in results if r.window.discarded]
    failed = [r.label for r in results if r.failed]
    degraded = [r.label for r in results if r.degraded_to is not None]
    print(
        f"{len(results)} runs -> {args.out}/ "
        f"({len(discarded)} would be discarded by the collector)",
        file=sys.stderr,
    )
    if degraded:
        print(
            f"{len(degraded)} run(s) completed DEGRADED: "
            f"{', '.join(degraded)}",
            file=sys.stderr,
        )
    if failed:
        # the failed cases are checkpointed: the same invocation
        # retries exactly them
        print(
            f"{len(failed)} run(s) FAILED (recorded in the checkpoint; "
            f"re-run to retry): {', '.join(failed)}",
            file=sys.stderr,
        )
        return 1
    return 0


def _add_search_parser(sub) -> None:
    s = sub.add_parser(
        "search",
        help="screen a jittered config population with a "
             "successive-halving bracket",
    )
    s.add_argument("topology", help="path to the service graph YAML")
    s.add_argument("--qps", default="1000",
                   help="target QPS (the population's base rate)")
    s.add_argument("--connections", "-c", type=int, default=64)
    s.add_argument("--duration", "-t", default="240s",
                   help='full-horizon duration, e.g. "240s" or "5m"')
    s.add_argument("--load-kind", choices=["open", "closed"],
                   default="open")
    s.add_argument("--max-requests", type=int, default=200_000)
    s.add_argument("--candidates", "-n", type=int, default=64,
                   help="population size (the rung-0 width)")
    s.add_argument("--eta", type=int, default=4,
                   help="halving rate: each rung keeps the best "
                        "ceil(width/eta)")
    s.add_argument("--rungs", type=int, default=3,
                   help="screening levels incl. the full-horizon rung")
    s.add_argument("--growth", type=int, default=None,
                   help="horizon growth between rungs (default: eta)")
    s.add_argument("--rank", default="err_share",
                   help="severity channel candidates rank by "
                        "(err_share | p99 | err_peak)")
    s.add_argument("--slo", default=None,
                   help='p99 rank SLO latency, e.g. "250ms" '
                        "(required for --rank p99)")
    s.add_argument("--jitter", default=None,
                   help='population perturbations, e.g. '
                        '"qps=0.2,cpu=0.1,error=0.3,seed=1"')
    s.add_argument("--chunk", type=int, default=None,
                   help="members per rung chunk (default: "
                        "carry-aware cost model)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--entry", default=None,
                   help="entrypoint service override")
    s.add_argument("--out", metavar="FILE", default=None,
                   help="write the isotope-search/v1 JSON artifact")
    s.add_argument("--json", action="store_true",
                   help="print the search doc as JSON instead of the "
                        "lineage table")
    s.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    s.set_defaults(func=run_search_cmd)


def run_search_cmd(args) -> int:
    """The reference's ``search`` command: one bracket, its lineage
    table and winner line (or ``--json``), ``--out``."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
    from isotope_tpu_torch.sim import TorchDraws
    from isotope_tpu_torch.sim.ensemble import (
        EnsembleSpec,
        parse_jitter_spec,
    )
    from isotope_tpu_torch.sim.search import SearchSpec

    sim = Simulator(
        compile_graph(ServiceGraph.from_yaml_file(args.topology),
                      entry=args.entry),
        SimParams(), device=args.device,
    )
    jitter = parse_jitter_spec(args.jitter)
    if not any(jitter.get(k) for k in
               ("qps_jitter", "cpu_jitter", "error_jitter")):
        # an unjittered population is N copies of one config: the
        # bracket would rank noise; default to a broad screen
        jitter = dict(jitter, qps_jitter=0.2, cpu_jitter=0.1,
                      error_jitter=0.3)
        print(
            "search: no --jitter given; screening the default "
            "qps=0.2,cpu=0.1,error=0.3 population",
            file=sys.stderr,
        )
    spec = SearchSpec(
        candidates=EnsembleSpec.from_jitter(args.candidates, **jitter),
        eta=args.eta,
        rungs=args.rungs,
        growth=args.growth,
        rank=args.rank,
        slo_s=(
            dur.parse_duration_seconds(args.slo) if args.slo else None
        ),
        seed=args.seed,
        chunk=args.chunk,
    )
    spec.check()
    load = LoadModel(
        kind=args.load_kind,
        qps=float(args.qps),
        connections=args.connections,
        duration_s=dur.parse_duration_seconds(args.duration),
    )
    n = max(1, min(int(load.qps * load.duration_s), args.max_requests))
    # the rung schedule needs growth^(rungs-1) blocks to be strictly
    # increasing: shrink the memory-sized block to fit the bracket
    need = spec.resolved_growth() ** (spec.rungs - 1)
    block = max(1, min(sim.default_block_size(), n // need))
    srch = sim.run_search(load, n, TorchDraws(args.seed, sim.device), spec,
                          block_size=block)
    doc = srch.to_doc(pathlib.Path(args.topology).stem)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"search -> {args.out}", file=sys.stderr)
    if args.json:
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0
    print(
        f"search: {spec.members} candidates, {spec.rungs} rungs "
        f"(eta={spec.eta}, growth={spec.resolved_growth()}), "
        f"rank={doc['rank_effective']}, {srch.traces} engine "
        f"trace(s), mode={srch.mode}"
    )
    for r in srch.rungs:
        surv = ", ".join(str(int(x)) for x in r.survivors[:8])
        more = len(r.survivors) - 8
        print(
            f"  rung {r.rung}: {r.width} candidate(s) x "
            f"{r.cum_requests} req (+{r.num_blocks} block(s), "
            f"chunk {r.chunk}) -> "
            f"{'winner' if r.rung == spec.rungs - 1 else 'survivors'}"
            f" [{surv}{f', +{more} more' if more > 0 else ''}]"
        )
    win = srch.winner_config()
    parts = [
        f"{k}={win[k]:.4f}" for k in
        ("qps_scale", "cpu_scale", "error_scale")
        if win[k] is not None
    ]
    print(
        f"winner: candidate {win['candidate']} (seed {win['seed']}) "
        f"severity={win['severity']:.6f} "
        f"offered={win['offered_qps']:.1f}qps "
        + " ".join(parts)
    )
    return 0


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
    """One labeled run: a one-case :func:`~isotope_tpu_torch.runner.run.
    run_experiment`, as the JAX command routes it, then the run's
    tables and documents."""
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.runner.config import (
        DEFAULT_ENVIRONMENTS,
        ExperimentConfig,
    )
    from isotope_tpu_torch.runner.run import run_experiment

    ens_kw = _ensemble_config_kwargs(args)
    arm_telemetry(args.telemetry)
    ignore_compile_cache(args)
    if args.environment not in DEFAULT_ENVIRONMENTS:
        raise ValueError(
            f"unknown environment {args.environment!r} "
            f"(expected one of {sorted(DEFAULT_ENVIRONMENTS)})"
        )
    extra = {}
    if args.cpu_time is not None:
        extra["cpu_time_s"] = dur.parse_duration_seconds(args.cpu_time)
    if args.service_time_param is not None:
        extra["service_time_param"] = args.service_time_param
    elif args.service_time == "pareto":
        extra["service_time_param"] = 1.5  # the reference's heavy tail
    tl_window = (
        None if args.timeline is None
        else dur.parse_duration_seconds(args.timeline)
    )
    load = _load(args)
    config = ExperimentConfig(
        topology_paths=(args.topology,),
        environments=(DEFAULT_ENVIRONMENTS[args.environment],),
        qps=(load.qps,),
        connections=(args.connections,),
        duration_s=load.duration_s,
        load_kind=args.load_kind,
        num_requests=args.max_requests,
        seed=args.seed,
        labels=args.labels,
        service_time=args.service_time,
        entry=args.entry,
        attribution=args.attribution is not None,
        timeline=tl_window is not None,
        policies=args.policies,
        rollouts=args.rollouts,
        mesh_spec=args.mesh,
        overlap=args.overlap,
        **ens_kw,
        **extra,
    )
    (result,) = run_experiment(config, policy=resilience_policy(args),
                               vet=args.vet,
                               attribution=args.attribution,
                               timeline=tl_window, device=args.device)
    if result.failed:
        print(f"error: run failed: {result.error}", file=sys.stderr)
        # in process the case's own error; through the module entry an
        # exit code of 1, as the JAX command's
        raise result.cause
    if result.blame is not None:
        _write_attribution_artifacts(args, result.compiled,
                                     result.attribution, result.blame)
    if args.policies and result.policies is not None:
        from isotope_tpu_torch.sim import policies as policies_mod

        _emit(result.policies, policies_mod.format_table,
              args.policies_out, "policies")
    elif args.policies:
        print("warning: --policies set but the topology declares no "
              "policies block (unprotected run)", file=sys.stderr)
    if args.rollouts and result.rollouts is not None:
        from isotope_tpu_torch.sim import rollout as rollout_mod

        _emit(result.rollouts, rollout_mod.format_table,
              args.rollouts_out, "rollouts")
    elif args.rollouts:
        print("warning: --rollouts set but the topology declares no "
              "active rollouts block (open-loop run)", file=sys.stderr)
    if result.ensemble is not None:
        _emit_fleet(args, result.ensemble)
    if result.lb is not None:
        from isotope_tpu_torch.sim import lb as lb_mod

        _emit(result.lb, lb_mod.format_table, args.lb_out, "lb")
    elif args.lb_out:
        print(
            "warning: --lb-out set but the topology declares no "
            "lb entries (fifo everywhere)",
            file=sys.stderr,
        )
    if result.timeline is not None:
        _write_timeline_artifacts(args, result)
    doc = result.flat if args.flat else result.fortio_json
    json.dump(doc, sys.stdout, indent=None if args.flat else 2)
    sys.stdout.write("\n")
    if args.prometheus:
        with open(args.prometheus, "w") as f:
            f.write(result.prometheus_text)
    if args.telemetry and result.telemetry is not None:
        rec = telemetry.RunTelemetry.from_dict(result.telemetry)
        rec.append_jsonl(args.telemetry_out)
        print(f"{telemetry.summary_line()} -> {args.telemetry_out}",
              file=sys.stderr)
    if args.trace:
        _write_trace(args, config)
    if result.window.discarded:
        print(
            f"warning: run would be discarded by the collector: "
            f"{result.window.discard_reason}",
            file=sys.stderr,
        )
    return 0


def _write_trace(args, config) -> None:
    """``--trace``: traces are sampled, a small dense batch of the same
    model (the reference's plain Simulator: no lb, policy or rollout
    tables) on ``TorchDraws(seed)``, the reference's ``PRNGKey(seed)``."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics.trace import write_trace
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator, TorchDraws

    compiled = compile_graph(ServiceGraph.from_yaml_file(args.topology),
                             entry=config.entry)
    sim = Simulator(compiled,
                    config.environments[0].apply(config.sim_params()),
                    config.chaos, config.churn, mtls=config.mtls,
                    device=args.device)
    (load,) = config.load_models()
    res = sim.run(load, args.trace_requests,
                  TorchDraws(args.seed, sim.device))
    traced = write_trace(args.trace, compiled, res, fmt=args.trace_format)
    print(f"traced {traced} requests -> {args.trace}", file=sys.stderr)


def _ensemble_config_kwargs(args) -> dict:
    """``ExperimentConfig`` overrides from the ``--ensemble*`` flags;
    each spec is parsed here first, so a bad flag fails before anything
    simulates (also without ``--ensemble``, as the JAX command does)."""
    out: dict = {}
    if args.ensemble is not None:
        out["ensemble"] = int(args.ensemble)
    if args.ensemble_jitter is not None:
        from isotope_tpu_torch.sim.ensemble import parse_jitter_spec

        j = parse_jitter_spec(args.ensemble_jitter)
        out["ensemble_qps_jitter"] = j["qps_jitter"]
        out["ensemble_cpu_jitter"] = j["cpu_jitter"]
        out["ensemble_error_jitter"] = j["error_jitter"]
        out["ensemble_jitter_seed"] = j.get("jitter_seed", 0)
    if args.ensemble_slo is not None:
        out["ensemble_slo_s"] = dur.parse_duration_seconds(
            args.ensemble_slo
        )
    if args.ensemble_chaos_jitter is not None:
        from isotope_tpu_torch.resilience.faults import parse_chaos_jitter

        parse_chaos_jitter(args.ensemble_chaos_jitter)  # fail fast
        out["ensemble_chaos_jitter"] = args.ensemble_chaos_jitter
    if args.ensemble_split is not None:
        from isotope_tpu_torch.sim.splitting import parse_split_spec

        parse_split_spec(args.ensemble_split)  # fail fast
        out["ensemble_split"] = args.ensemble_split
    if args.split_horizon is not None:
        h = float(args.split_horizon)
        if not 0.0 < h <= 1.0:
            raise SystemExit("--split-horizon must lie in (0, 1]")
        out["ensemble_split_horizon"] = h
    return out


def _fleet_args(args):
    """The fleet the ``--ensemble*`` flags ask for, as ``(EnsembleSpec,
    slo_s, SplitSpec or None)``, or None without ``--ensemble``: the
    run config's own specs of :func:`_ensemble_config_kwargs`'s
    overrides."""
    from isotope_tpu_torch.runner.config import ExperimentConfig

    config = ExperimentConfig((), (), (), (), 0.0,
                              **_ensemble_config_kwargs(args))
    spec = config.ensemble_spec()
    if spec is None:
        return None
    return spec, config.ensemble_slo_s, config.split_spec()


def _emit_fleet(args, d) -> None:
    """The ``ensemble:`` line to stderr and ``--ensemble-out``."""
    band = d["quantile_band_p99"]
    line = (
        f"ensemble: {d['members']} members (chunk {d['chunk']}): "
        f"p99 band [{band['lo_s'] * 1e3:.2f}, "
        f"{band['mid_s'] * 1e3:.2f}, {band['hi_s'] * 1e3:.2f}] ms"
    )
    if "slo" in d:
        s = d["slo"]
        line += (
            f"; P(p{s['quantile'] * 100:g} > "
            f"{s['slo_s'] * 1e3:g}ms) = {s['p_violation']:.3f} "
            f"[{s['ci_lo']:.3f}, {s['ci_hi']:.3f}] "
            f"@{s['confidence']:.0%}"
        )
    print(line, file=sys.stderr)
    if args.ensemble_out:
        with open(args.ensemble_out, "w") as f:
            json.dump(d, f, indent=2)
        print(f"ensemble -> {args.ensemble_out}", file=sys.stderr)


def _write_attribution_artifacts(args, compiled, attr, doc=None) -> None:
    """The blame table to stderr and the attributed run's documents
    (``doc``: the run's blame document, stamped with a fleet's worst
    member; by default the attribution's own)."""
    from isotope_tpu_torch.metrics import attribution as attr_mod
    from isotope_tpu_torch.metrics.export import (
        write_flamegraph,
        write_perfetto_counters,
    )

    if doc is None:
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


def _write_timeline_artifacts(args, result) -> None:
    """The flight recorder's table on stderr and its documents."""
    from isotope_tpu_torch.metrics import timeline as timeline_mod

    compiled, tl = result.compiled, result.timeline_summary
    _emit(result.timeline, timeline_mod.format_table, args.timeline_out,
          "timeline")
    if args.timeline_perfetto:
        from isotope_tpu_torch.metrics.export import write_timeline_perfetto

        ev = write_timeline_perfetto(args.timeline_perfetto, compiled, tl)
        print(f"timeline counters ({ev} events) -> "
              f"{args.timeline_perfetto}", file=sys.stderr)
    if args.timeline_prometheus:
        with open(args.timeline_prometheus, "w") as f:
            f.write(timeline_mod.prometheus_text(compiled, tl))
        print(f"timestamped exposition -> {args.timeline_prometheus}",
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
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2
    # under a world of several ranks (torchrun) only rank 0 prints
    with rank_console():
        try:
            return args.func(args) or 0
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1


if __name__ == "__main__":
    sys.exit(main())
