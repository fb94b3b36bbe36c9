"""``vet`` — static program & config analysis.

The port of ``isotope_tpu.commands.vet_cmd``.  Lints topology YAMLs and
sweep TOMLs, records one pilot block of the engine op by op and audits
it (``analysis/op_audit.py``), and runs the pre-flight cost model.  The
pilot runs on ``--device`` (the card unless ``--device cpu``).  Exit
status: 0 clean, 1 when any error-severity finding survives
suppression (``--strict`` promotes warnings), 2 on usage errors.
"""
from __future__ import annotations

import sys

from isotope_tpu_torch.utils import duration as dur


def register(sub) -> None:
    s = sub.add_parser(
        "vet",
        help="static analysis: lint topologies/configs, audit a pilot "
             "block of the engine, model pre-flight cost",
    )
    s.add_argument("paths", nargs="+", metavar="PATH",
                   help="topology YAMLs and/or experiment TOMLs "
                        "(.toml runs the config linter over the whole "
                        "sweep grid first)")
    s.add_argument("--strict", action="store_true",
                   help="promote warnings to blocking (exit 1)")
    s.add_argument("--suppress", default=None, metavar="RULES",
                   help="comma-separated rule ids/globs to suppress, "
                        "e.g. VET-J003,VET-T00* (also "
                        "$ISOTOPE_VET_SUPPRESS)")
    s.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout")
    s.add_argument("--no-trace", action="store_true",
                   help="skip the pilot block's op audit and traced "
                        "cost model (lint + plan-table estimates only)")
    s.add_argument("--grad", action="store_true",
                   help="run the gradient audit (VET-G rules): "
                        "classify every registered design knob as "
                        "differentiable / gradient-dead / "
                        "trace-constant (off by default: records a "
                        "second, knob-armed pilot block)")
    s.add_argument("--grad-json", default=None, metavar="PATH",
                   help="write the isotope-gradaudit/v1 artifact to "
                        "PATH; implies --grad")
    s.add_argument("--entry", default=None,
                   help="entrypoint override for multi-entry "
                        "topologies")
    s.add_argument("--qps", default="1000",
                   help='planned load for the audit/cost model, or '
                        '"max"')
    s.add_argument("--connections", "-c", type=int, default=64)
    s.add_argument("--load-kind", choices=["open", "closed"],
                   default="open")
    s.add_argument("--duration", "-t", default="240s")
    s.add_argument("--device-bytes", type=float, default=None,
                   metavar="N",
                   help="device memory capacity for the OOM verdict "
                        "(default: $ISOTOPE_VET_DEVICE_BYTES, then the "
                        "card's total memory; unknown on the CPU)")
    s.add_argument("--device", default=None,
                   help="torch device of the pilot block (default: "
                        "cuda; raises without a GPU)")
    s.set_defaults(func=run_vet)


def _collect_grad_docs(path, meta, out) -> None:
    """Pull per-topology gradient-audit documents out of a report's
    meta (a topology vet puts the doc at ``meta['grad']``; a sweep
    TOML nests one per referenced topology path)."""
    if "grad" in meta:
        out.append(dict(meta["grad"], topology=str(path)))
    for k, v in meta.items():
        if k != "grad" and isinstance(v, dict) and "grad" in v:
            out.append(dict(v["grad"], topology=str(k)))


def run_vet(args) -> int:
    from isotope_tpu_torch.analysis import (
        Report,
        default_suppressions,
        suppression_patterns,
        vet_config_path,
        vet_topology_path,
    )
    from isotope_tpu_torch.sim.config import LoadModel

    suppress = default_suppressions()
    if args.suppress:
        suppress += suppression_patterns(args.suppress)
    load = LoadModel(
        kind=args.load_kind,
        qps=None if args.qps == "max" else float(args.qps),
        connections=args.connections,
        duration_s=dur.parse_duration_seconds(args.duration),
    )

    grad = bool(args.grad or args.grad_json)
    merged = Report(suppress=())
    grad_docs = []
    for path in args.paths:
        if str(path).endswith(".toml"):
            rep = vet_config_path(
                path, trace=not args.no_trace,
                device_bytes=args.device_bytes, suppress=suppress,
                grad=grad, device=args.device,
            )
        else:
            rep = vet_topology_path(
                path, load=load, entry=args.entry,
                trace=not args.no_trace,
                device_bytes=args.device_bytes, suppress=suppress,
                grad=grad, device=args.device,
            )
        merged.findings.extend(rep.findings)
        merged.suppressed.extend(rep.suppressed)
        if rep.meta:
            merged.meta[str(path)] = rep.meta
        _collect_grad_docs(path, rep.meta, grad_docs)

    if args.grad_json:
        import json

        from isotope_tpu_torch.analysis.grad_audit import SCHEMA

        with open(args.grad_json, "w") as f:
            json.dump(
                {"schema": SCHEMA, "audits": grad_docs},
                f, indent=2, sort_keys=True,
            )
            f.write("\n")

    if args.json:
        print(merged.to_json())
    else:
        for f in merged.sorted():
            print(f.render())
        print(merged.summary_line(), file=sys.stderr)

    blocking = merged.blocking(strict=args.strict)
    return 1 if blocking else 0
