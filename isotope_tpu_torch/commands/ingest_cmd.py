"""``ingest``: telemetry in, runnable topology out (the port of
``isotope_tpu.commands.ingest_cmd``).

Host-only: reads Prometheus/OpenMetrics expositions, Envoy
``/stats`` cluster JSON, and CSV span traces (see README "Trace-driven
ingest" for the schema), fits a topology + load schedule, and writes

- ``<label>.yaml``   — the fitted topology (validated through
  ServiceGraph.decode before it is written);
- ``<label>.toml``   — a runnable ``[client]``/``[sim]`` experiment
  config (validated through runner.config.load_toml);
- ``<label>.ingest.json`` — the isotope-ingest/v1 fit-fidelity report
  (coverage, residuals, per-service fitted-vs-observed), rendered by
  ``isotope-tpu explain``.

The fitted topology is linted on the way out (topology rules plus the
ingest-specific VET-T027/VET-T028); findings print to stderr but do
not fail the command — the artifacts carry the evidence either way.
"""
from __future__ import annotations

import os
import sys

import yaml

from isotope_tpu_torch.utils import duration as dur


def register(sub) -> None:
    p = sub.add_parser(
        "ingest",
        help="fit observed telemetry into a topology + load schedule",
    )
    p.add_argument(
        "inputs", nargs="+",
        help="telemetry files: Prometheus/OpenMetrics text, Envoy "
             "/stats JSON (.json), or CSV span traces (.csv)",
    )
    p.add_argument(
        "--format", default="auto",
        choices=["auto", "prometheus", "envoy", "csv"],
        help="pin the input format (default: sniff per file extension)",
    )
    p.add_argument("--label", default="ingested")
    p.add_argument("-o", "--out-dir", default=".")
    p.add_argument(
        "--entry", default=None,
        help="entrypoint service (default: inferred from client edges)",
    )
    p.add_argument(
        "--duration", default=None,
        help="observation duration (Go duration) for inputs without "
             "timestamps (Envoy stats)",
    )
    p.add_argument(
        "--window", default="1s",
        help="qps schedule window for CSV timestamp bucketing",
    )
    p.add_argument(
        "--cpu-time", default=None,
        help="override the fitted station cpu_time (Go duration)",
    )
    p.add_argument("--connections", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--json", action="store_true",
        help="print the isotope-ingest/v1 report to stdout",
    )
    p.set_defaults(func=run_ingest)


def run_ingest(args) -> int:
    from isotope_tpu_torch.analysis.topo_lint import lint_graph, lint_ingest
    from isotope_tpu_torch.ingest import fitters, readers, report
    from isotope_tpu_torch.runner.config import load_toml

    window_s = dur.parse_duration_seconds(args.window)
    obs = None
    for path in args.inputs:
        fmt = None if args.format == "auto" else args.format
        obs = readers.read_path(
            path, obs=obs, fmt=fmt, window_s=window_s
        )
    opts = fitters.FitOptions(
        label=args.label,
        entry=args.entry,
        duration_s=(
            dur.parse_duration_seconds(args.duration)
            if args.duration else None
        ),
        window_s=window_s,
        cpu_time_s=(
            dur.parse_duration_seconds(args.cpu_time)
            if args.cpu_time else None
        ),
        connections=args.connections,
        seed=args.seed,
    )
    fr = fitters.fit(obs, opts)

    os.makedirs(args.out_dir, exist_ok=True)
    topo_path = os.path.join(args.out_dir, f"{args.label}.yaml")
    toml_path = os.path.join(args.out_dir, f"{args.label}.toml")
    json_path = os.path.join(args.out_dir, f"{args.label}.ingest.json")
    with open(topo_path, "w") as f:
        f.write(yaml.safe_dump(
            fr.topology_doc, default_flow_style=False, sort_keys=False
        ))
    with open(toml_path, "w") as f:
        f.write(fr.toml_text)
    # the emitted TOML must decode through the real config loader
    load_toml(toml_path)

    doc = report.to_doc(fr, obs)
    findings = lint_graph(fr.graph, entry=fr.entry)
    findings += lint_ingest(fr.graph, doc)
    if findings:
        doc["findings"] = [f.to_dict() for f in findings]
        for f in findings:
            print(f.render(), file=sys.stderr)
    report.save_doc(doc, json_path)

    if args.json:
        import json as json_mod

        json_mod.dump(doc, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        print(report.format_report(doc))
        print(
            f"wrote {topo_path}, {toml_path}, {json_path}"
        )
    return 0
