"""``python -m isotope_tpu_torch report`` — dashboard-lite over sweep
artifacts.

The port of ``isotope_tpu.commands.report_cmd``: the one-file
replacement for the reference's Django dashboard
(perf_dashboard/benchmarks/views.py): latency/CPU/error charts per
series, the full results table, and a run-vs-run regression view when a
baseline sweep directory is given.
"""
from __future__ import annotations

import sys


def register(sub) -> None:
    r = sub.add_parser(
        "report",
        help="render a sweep's results.jsonl as a static HTML report",
    )
    r.add_argument("results", help="sweep output directory (or, with "
                                   "--history, a directory of publish "
                                   "trees)")
    r.add_argument("--baseline", metavar="DIR",
                   help="another sweep to diff against (regression view)")
    r.add_argument("--history", action="store_true",
                   help="treat RESULTS as a directory of "
                        "<date>_<loadgen>_<branch>_<ver> publish trees "
                        "and render metric-over-time series (the "
                        "reference dashboard's day-over-day view)")
    r.add_argument("--lineage", default=None, metavar="SUBSTR",
                   help="with --history: select one publish lineage "
                        "(substring of the id suffix after the date) "
                        "when the directory holds several")
    r.add_argument("--title", default=None)
    r.add_argument("-o", "--output", default="report.html")
    r.set_defaults(func=run_report)


def run_report(args) -> int:
    from isotope_tpu_torch.report import write_history_report, write_report

    if args.history:
        if args.baseline:
            print("--baseline is ignored with --history", file=sys.stderr)
        count = write_history_report(
            args.results, args.output, title=args.title,
            lineage=args.lineage,
        )
        print(f"{count} publishes -> {args.output}", file=sys.stderr)
        return 0
    if args.lineage:
        print("--lineage is ignored without --history", file=sys.stderr)
    count = write_report(
        args.results, args.output,
        baseline_dir=args.baseline, title=args.title,
    )
    print(f"{count} runs -> {args.output}", file=sys.stderr)
    return 0
