"""Fortio-compatible result formatting for a run summary.

The part of ``isotope_tpu.metrics.fortio`` the port's main path needs:
``fortio_result_from_summary`` renders a RunSummary as the result JSON
``fortio load -json`` writes (perf/benchmark/runner/fortio.py consumes
it), and ``trim_window_bounds`` places the collector's steady-state
window (fortio.py:116-121).  Same constants, same document.
"""
from __future__ import annotations

from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np

from isotope_tpu_torch.metrics.histogram import (
    bucket_centers,
    quantile_from_histogram,
)
from isotope_tpu_torch.sim.config import LoadModel

# fortio.py:116-121
METRICS_START_SKIP_DURATION = 62
METRICS_END_SKIP_DURATION = 30
METRICS_SUMMARY_DURATION = 180

# ints for the round percentiles: the reference's flattener builds keys
# with str(Percentile) (fortio.py:60-62), so 50 must print as "50" -> p50.
PERCENTILES = (50, 75, 90, 99, 99.9)

# fortio histogram resolution: runner.py:136-137 passes -r 0.001 (1ms).
HISTOGRAM_RESOLUTION_S = 0.001


def _fortio_doc(
    load: LoadModel,
    labels: str,
    start_time: Optional[datetime],
    response_size_bytes: float,
    *,
    n: int,
    errors: int,
    actual_duration_s: float,
    lat_min: float,
    lat_max: float,
    lat_sum: float,
    lat_avg: float,
    lat_std: float,
    data: List[dict],
    percentiles: List[dict],
) -> dict:
    """The shared Fortio result-JSON scaffolding for both derivations."""
    start_time = start_time or datetime.now(timezone.utc)
    ret_codes: Dict[str, int] = {}
    if n - errors:
        ret_codes["200"] = n - errors
    if errors:
        ret_codes["500"] = errors
    return {
        "RunType": "HTTP",
        "Labels": labels,
        "StartTime": start_time.isoformat(),
        "RequestedQPS": "max" if load.qps is None else str(load.qps),
        "RequestedDuration": f"{load.duration_s}s",
        "ActualQPS": (n / actual_duration_s) if actual_duration_s > 0 else 0.0,
        "ActualDuration": int(actual_duration_s * 1e9),  # nanoseconds
        "NumThreads": load.connections,
        "DurationHistogram": {
            "Count": n,
            "Min": lat_min if n else 0.0,
            "Max": lat_max if n else 0.0,
            "Sum": lat_sum,
            "Avg": lat_avg if n else 0.0,
            "StdDev": lat_std if n else 0.0,
            "Data": data,
            "Percentiles": percentiles,
        },
        "RetCodes": ret_codes,
        # the payload the client receives: the entrypoint's responseSize
        "Sizes": {"Count": n, "Avg": float(response_size_bytes)},
    }


def fortio_result_from_summary(
    summary,
    load: LoadModel,
    labels: str = "",
    start_time: Optional[datetime] = None,
    response_size_bytes: float = 0.0,
) -> dict:
    """Render a :class:`~isotope_tpu_torch.sim.summary.RunSummary` as a Fortio
    result JSON — the scan-path counterpart of :func:`fortio_result`.

    Exact where Fortio is exact (Count, Min, Max, Sum, Avg, StdDev,
    RetCodes, ActualQPS); Percentiles and the bucket rows come from the
    fine log-spaced device histogram (~0.6% relative bucket width), the
    same reduction Fortio itself applies at 1ms resolution
    (runner.py:136-137).
    """
    n = int(summary.count)
    hist = summary.latency_hist.detach().cpu().numpy().astype(np.float64)
    qs = quantile_from_histogram(hist, [p / 100.0 for p in PERCENTILES])
    percentiles = [
        {"Percentile": p, "Value": float(v)} for p, v in zip(PERCENTILES, qs)
    ]

    # re-bucket the fine histogram into Fortio's 1ms rows
    data: List[dict] = []
    if n:
        res_s = HISTOGRAM_RESOLUTION_S
        lat_max = float(summary.latency_max)
        hi = max(min(int(np.ceil(lat_max / res_s)), 1000), 1)
        bins = np.minimum(
            (bucket_centers() / res_s).astype(np.int64), hi - 1
        )
        counts = np.zeros(hi)
        np.add.at(counts, bins, hist)
        for i, c in enumerate(counts):
            if c == 0:
                continue
            data.append(
                {
                    "Start": float(i * res_s),
                    "End": float((i + 1) * res_s),
                    "Percent": float(100.0 * c / n),
                    "Count": int(round(c)),
                }
            )

    return _fortio_doc(
        load, labels, start_time, response_size_bytes,
        n=n,
        errors=int(summary.error_count),
        actual_duration_s=float(summary.end_max) if n else 0.0,
        lat_min=float(summary.latency_min),
        lat_max=float(summary.latency_max),
        lat_sum=float(summary.latency_sum),
        lat_avg=summary.mean_latency_s,
        lat_std=summary.stddev_latency_s,
        data=data,
        percentiles=percentiles,
    )


def trim_window_bounds(
    num_requests: int, offered_qps: float
) -> "tuple[float, float]":
    """The ``[lo, hi)`` client-start interval of the collector's trim
    window, placed from the run's expected duration (fortio.py:116-121)."""
    d_exp = num_requests / max(float(offered_qps), 1e-12)
    min_dur = METRICS_START_SKIP_DURATION + METRICS_END_SKIP_DURATION
    w_len = min(max(d_exp - min_dur, 0.0), METRICS_SUMMARY_DURATION)
    lo = float(METRICS_START_SKIP_DURATION)
    return lo, lo + w_len
