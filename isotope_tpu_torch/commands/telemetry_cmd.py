"""``python -m isotope_tpu_torch telemetry`` — engine self-telemetry probe.

The port of ``isotope_tpu.commands.telemetry_cmd``: runs a short,
labeled simulation with engine telemetry armed and reports what the
ENGINE did (phase seconds, the block plan, device-memory high-water) —
the introspection counterpart of ``simulate``, which reports what the
simulated *workload* did.  ``--xla-trace DIR`` (the reference's flag
name) captures a ``torch.profiler`` trace of warmed steps instead of
``jax.profiler``'s (:mod:`isotope_tpu_torch.telemetry.profile`).
"""
from __future__ import annotations

import json
import sys


def register(sub) -> None:
    t = sub.add_parser(
        "telemetry",
        help="probe the engine's self-telemetry on one topology",
    )
    t.add_argument("topology", nargs="?", default=None,
                   help="service-graph YAML (default: the flagship "
                        "~120-service tree)")
    t.add_argument("--qps", type=float, default=1000.0)
    t.add_argument("--requests", type=int, default=4096)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--detail", action="store_true",
                   help="fence at every level of the block's sweeps "
                        "(per-level wall times; diagnosis, not "
                        "benchmarking)")
    t.add_argument("--json", action="store_true",
                   help="print the RunTelemetry record as JSON instead "
                        "of the Prometheus exposition")
    t.add_argument("--out", metavar="FILE", default=None,
                   help="also append the record to this JSONL file")
    t.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="accepted for the JAX command's sake and ignored: "
                        "it configures XLA's compilation cache")
    t.add_argument("--xla-trace", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of warmed steps "
                        "into DIR (Chrome trace format)")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    t.set_defaults(func=run_telemetry)


def run_telemetry(args) -> int:
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.commands.common import (
        arm_telemetry,
        ignore_compile_cache,
    )
    from isotope_tpu_torch.sim import LoadModel, TorchDraws
    from isotope_tpu_torch.telemetry import profile

    # shared detail plumbing: --detail composes with any
    # --telemetry=detail armed earlier in this process
    arm_telemetry("on", detail=args.detail)
    ignore_compile_cache(args)

    sim = profile.build_simulator(args.topology, device=args.device)
    label = args.topology or "flagship-tree121"
    load = LoadModel(kind="open", qps=args.qps)
    summary = sim.run_summary(
        load, args.requests, TorchDraws(args.seed, sim.device),
        block_size=min(sim.default_block_size(), args.requests),
    )
    float(summary.count)  # wait for the run

    if args.xla_trace:
        with telemetry.phase("xla_trace_capture"):
            traces = profile.capture_torch_trace(
                args.xla_trace, sim=sim,
                num_requests=args.requests, qps=args.qps, seed=args.seed,
            )
        print(f"torch trace: {len(traces)} trace file(s) -> "
              f"{args.xla_trace}", file=sys.stderr)

    rec = telemetry.snapshot(label=label)
    if args.out:
        rec.append_jsonl(args.out)
        print(f"telemetry record -> {args.out}", file=sys.stderr)
    if args.json:
        json.dump(rec.to_dict(), sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(rec.prometheus_text())
    print(telemetry.summary_line(), file=sys.stderr)
    return 0
