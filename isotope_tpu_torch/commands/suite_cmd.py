"""``python -m isotope_tpu_torch suite`` — the CI benchmark-job pipeline.

The port of ``isotope_tpu.commands.suite_cmd`` (the run_benchmark_job.sh
analogue): run every given experiment config, collect artifacts under
one ``<date>_<loadgen>_<branch>_<ver>`` publish id, evaluate the
stability alarms on every run into a monitor-status sink, and render
per-config reports plus a manifest.  Exit code 1 when an alarm fired or
a case failed.
"""
from __future__ import annotations

import sys

from isotope_tpu_torch.commands.common import (
    add_resilience_args,
    add_telemetry_arg,
    add_vet_arg,
    arm_telemetry,
    ignore_compile_cache,
    resilience_policy,
)


def register(sub) -> None:
    s = sub.add_parser(
        "suite",
        help="run a set of experiment configs as one published "
             "benchmark job",
    )
    s.add_argument("configs", nargs="+",
                   help="experiment TOML files to run, in order")
    s.add_argument("--out", "-o", default="publish",
                   help="publish root (default: ./publish)")
    s.add_argument("--id", default=None,
                   help="publish id (default: <date>_sim_<labels>_dev)")
    s.add_argument("--labels", default="master")
    s.add_argument("--cpu-limit", type=float, default=50.0,
                   help="alarm threshold, milli-cores")
    s.add_argument("--mem-limit", type=float, default=64.0,
                   help="alarm threshold, MiB")
    s.add_argument("--fresh", action="store_true",
                   help="ignore existing per-config checkpoints")
    s.add_argument("--compile-cache", metavar="DIR", default=None,
                   help="accepted for the JAX command's sake and ignored: "
                        "it configures XLA's compilation cache")
    add_telemetry_arg(s, "in each .prom artifact plus a "
                              "telemetry.jsonl per config")
    add_resilience_args(s)
    add_vet_arg(s)
    s.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    s.set_defaults(func=run_suite_cmd)


def run_suite_cmd(args) -> int:
    from isotope_tpu_torch.runner.suite import run_suite

    arm_telemetry(args.telemetry)
    ignore_compile_cache(args)
    result = run_suite(
        args.configs,
        args.out,
        id=args.id,
        labels=args.labels,
        cpu_limit_mcores=args.cpu_limit,
        mem_limit_mib=args.mem_limit,
        progress=lambda label: print(f"running {label}", file=sys.stderr),
        resume=not args.fresh,
        policy=resilience_policy(args),
        vet=args.vet,
        device=args.device,
    )
    m = result.manifest
    print(
        f"suite {m['id']}: {m['total_runs']} runs across "
        f"{len(m['configs'])} configs, {m['total_alarms']} alarms, "
        f"{m['total_failed']} failed, {m['total_degraded']} degraded -> "
        f"{result.publish_dir}",
        file=sys.stderr,
    )
    return 1 if (m["total_alarms"] or m["total_failed"]) else 0
