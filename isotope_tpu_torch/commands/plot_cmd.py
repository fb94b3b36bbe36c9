"""``plot``: latency or CPU curves from a sweep's ``benchmark.csv``.

The port of the reference's ``plot`` subcommand
(``isotope_tpu.commands.simulate_cmd``).  Host only: matplotlib and
pandas are imported by the handler, so importing the CLI does not need
them.
"""
from __future__ import annotations

import sys


def register(sub) -> None:
    p = sub.add_parser(
        "plot", help="plot latency/CPU curves from a sweep's benchmark.csv"
    )
    p.add_argument("csv", help="benchmark.csv from a sweep")
    p.add_argument("--x", choices=["conn", "qps"], default="conn")
    p.add_argument("--metrics", default="p50,p90,p99",
                   help="comma-separated columns (latency in us, or e.g. "
                        "cpu_cores_<service>)")
    p.add_argument("--series", default=None,
                   help="comma-separated series (default: all)")
    p.add_argument("--title", default=None)
    p.add_argument("-o", "--output", default="benchmark.png")
    p.set_defaults(func=run_plot)


def run_plot(args) -> int:
    from isotope_tpu_torch.plotting import plot_benchmark

    plotted = plot_benchmark(
        args.csv,
        args.output,
        x_axis=args.x,
        metrics=[m.strip() for m in args.metrics.split(",") if m.strip()],
        series=(
            [s.strip() for s in args.series.split(",")]
            if args.series
            else None
        ),
        title=args.title,
    )
    print(f"plotted {len(plotted)} series -> {args.output}", file=sys.stderr)
    return 0
