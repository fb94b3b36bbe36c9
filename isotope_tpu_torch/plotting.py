"""Benchmark CSV plotting.

Capability parity with the reference's graph plotter
(perf/benchmark/graph_plotter/graph_plotter.py): latency percentiles or
CPU vs connections or QPS, one line per series label, from the
``benchmark.csv`` the sweep driver writes.  Matplotlib with the Agg
backend — output is a PNG, no display needed.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

LATENCY_METRICS = ("p50", "p75", "p90", "p99", "p999")
X_AXES = ("conn", "qps")

# our sweep labels: <topology>_<env>_<qps>qps_<conn>c[_extra]; the qps is
# rendered with {:g}, which switches to exponent form above 1e6 ("1e+06")
_LABEL_RE = re.compile(
    r"^(?P<series>.+?)_(?P<qps>[0-9.]+(?:e[+-]?[0-9]+)?|max)qps_\d+c"
)


def _series_of(label: str) -> str:
    m = _LABEL_RE.match(str(label))
    return m.group("series") if m else str(label)


def plot_benchmark(
    csv_path,
    out_path,
    x_axis: str = "conn",
    metrics: Sequence[str] = ("p50", "p90", "p99"),
    series: Optional[Sequence[str]] = None,
    title: Optional[str] = None,
) -> List[str]:
    """Plot ``metrics`` vs ``x_axis`` per series; returns series plotted.

    Latency columns are integer microseconds (the flattened fortio
    schema); they are shown in milliseconds.  Any other numeric column
    (e.g. the per-service ``cpu_cores_*`` columns) plots raw.
    """
    if x_axis not in X_AXES:
        raise ValueError(f"x_axis must be one of {X_AXES}")
    df = pd.read_csv(csv_path)
    if df.empty:
        raise ValueError(f"no rows in {csv_path}")
    df["series"] = df["Labels"].map(_series_of)
    xcol = "NumThreads" if x_axis == "conn" else "ActualQPS"

    wanted = list(series) if series else sorted(df["series"].unique())
    plotted: List[str] = []
    dpi = 100
    plt.figure(figsize=(1138 / dpi, 871 / dpi), dpi=dpi)
    for s in wanted:
        rows = df[df["series"] == s].sort_values(xcol)
        if rows.empty:
            continue
        drew = False
        for metric in metrics:
            if metric not in rows.columns:
                raise ValueError(f"no column {metric!r} in {csv_path}")
            # record-dependent columns (cpu_cores_<svc>) are "-"-padded on
            # rows from topologies without that service — skip those rows
            y = pd.to_numeric(rows[metric], errors="coerce")
            keep = y.notna()
            if not keep.any():
                continue
            label = f"{s} {metric}"
            if metric in LATENCY_METRICS:
                y = y / 1000.0  # us -> ms
            plt.plot(rows[xcol][keep], y[keep], marker="o", label=label)
            drew = True
        if drew:
            plotted.append(s)
    if not plotted:
        raise ValueError(f"no matching series in {csv_path}")
    plt.xlabel(
        "Connections" if x_axis == "conn" else "QPS"
    )
    unit = (
        "Latency (ms)"
        if all(m in LATENCY_METRICS for m in metrics)
        else ", ".join(metrics)
    )
    plt.ylabel(unit)
    if title:
        plt.title(title)
    plt.legend()
    plt.grid(True)
    plt.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close()
    return plotted
