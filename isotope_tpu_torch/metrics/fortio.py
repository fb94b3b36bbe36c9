"""Fortio-compatible result formatting for a run summary.

The port of ``isotope_tpu.metrics.fortio``:

- ``fortio_result_from_summary`` renders a RunSummary as the result JSON
  ``fortio load -json`` writes (perf/benchmark/runner/fortio.py
  consumes it), and ``trim_window_bounds`` places the collector's
  steady-state window (fortio.py:116-121);
- ``convert_data``: the reference's single-line flattening
  (fortio.py:38-75), the flat row of ``results.jsonl`` and the CSV;
- ``trim_window_summary`` / ``window_summary_from_summary``: the
  collector's window (skip the first 62 s and the last 30 s, at most
  180 s, runs with >10% errors discarded) from dense results or from a
  summary's window accumulators;
- ``write_csv``: fortio.py:215-232's key-list CSV writer.

Same constants, same documents.
"""
from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Dict, List, Optional

import numpy as np
import torch

from isotope_tpu_torch.metrics.histogram import (
    bucket_centers,
    quantile_from_histogram,
)
from isotope_tpu_torch.sim.config import LoadModel

# fortio.py:116-121
METRICS_START_SKIP_DURATION = 62
METRICS_END_SKIP_DURATION = 30
METRICS_SUMMARY_DURATION = 180
# fortio.py:175-177
MAX_ERROR_PERCENT = 10.0

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


def convert_data(data: dict) -> Optional[dict]:
    """Flatten a Fortio result JSON exactly like fortio.py:38-75."""
    obj: dict = {}
    for key in (
        "Labels",
        "StartTime",
        "RequestedQPS",
        "ActualQPS",
        "NumThreads",
        "RunType",
        "ActualDuration",
    ):
        if key == "RequestedQPS" and data[key] == "max":
            obj[key] = 99999999
            continue
        if key in ("RequestedQPS", "ActualQPS"):
            obj[key] = int(round(float(data[key])))
            continue
        if key == "ActualDuration":
            obj[key] = int(data[key] / 10 ** 9)
            continue
        obj[key] = data[key]

    h = data["DurationHistogram"]
    obj["min"] = int(h["Min"] * 10 ** 6)
    obj["max"] = int(h["Max"] * 10 ** 6)
    for pp in h["Percentiles"]:
        obj["p" + str(pp["Percentile"]).replace(".", "")] = int(
            pp["Value"] * 10 ** 6
        )
    success = int(data["RetCodes"].get("200", 0))
    if data["RunType"] == "HTTP":
        count = int(data["Sizes"]["Count"])
        obj["errorPercent"] = 100 * (count - success) / count if count else 0.0
        obj["Payload"] = int(data["Sizes"]["Avg"])
    return obj


@dataclasses.dataclass(frozen=True)
class WindowSummary:
    """Steady-state window statistics (the sim's stand-in for the
    Prometheus CPU/mem join of fortio.py:178-195)."""

    start_s: float
    duration_s: float
    count: int
    qps: float
    error_percent: float
    discarded: bool           # >10% errors or run shorter than 92s
    discard_reason: str
    percentiles_us: Dict[str, int]
    # simulated per-service CPU (cores): utilization x replicas — what the
    # reference measures off cadvisor (prom.py:116-120)
    cpu_cores: Dict[str, float]


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _window_summary(
    *,
    count: int,
    error_count: float,
    actual_duration: float,
    w_start: float,
    w_len: float,
    wcount: int,
    werr: float,
    percentiles: Dict[str, int],
    utilization,
    service_names,
    replicas,
) -> WindowSummary:
    """Shared discard logic + shaping for both window derivations."""
    min_duration = METRICS_START_SKIP_DURATION + METRICS_END_SKIP_DURATION
    error_percent = 100.0 * float(error_count) / count if count else 0.0

    discarded, reason = False, ""
    if error_percent > MAX_ERROR_PERCENT:
        discarded, reason = True, f"{error_percent:.1f}% errors"
    elif actual_duration < min_duration:
        discarded, reason = (
            True,
            f"duration={actual_duration:.0f}s is less than minimum "
            f"{min_duration}s",
        )

    util = _host(utilization).astype(np.float64)
    reps = (
        np.asarray(replicas, np.float64)
        if replicas is not None
        else np.ones_like(util)
    )
    cpu = {
        name: float(util[i] * reps[i])
        for i, name in enumerate(service_names)
    }
    return WindowSummary(
        start_s=w_start,
        duration_s=w_len,
        count=wcount,
        qps=(wcount / w_len) if w_len > 0 else 0.0,
        error_percent=(
            100.0 * float(werr) / wcount if wcount else error_percent
        ),
        discarded=discarded,
        discard_reason=reason,
        percentiles_us=percentiles,
        cpu_cores=cpu,
    )


def trim_window_summary(
    res,
    load: LoadModel,
    service_names=(),
    replicas=None,
) -> WindowSummary:
    """The collector's window of dense ``SimResults`` (per request)."""
    lat = _host(res.client_latency).astype(np.float64)
    starts = _host(res.client_start).astype(np.float64)
    err = _host(res.client_error)
    actual_duration = (
        float(_host(res.client_end).max()) if len(lat) else 0.0
    )

    w_start = float(METRICS_START_SKIP_DURATION)
    min_duration = METRICS_START_SKIP_DURATION + METRICS_END_SKIP_DURATION
    w_len = min(
        max(actual_duration - min_duration, 0.0), METRICS_SUMMARY_DURATION
    )
    mask = (starts >= w_start) & (starts < w_start + w_len)
    wlat = lat[mask]
    wcount = int(mask.sum())
    percentiles = {}
    if wcount:
        qs = np.quantile(wlat, [p / 100.0 for p in PERCENTILES])
        percentiles = {
            "p" + str(p).replace(".", ""): int(v * 1e6)
            for p, v in zip(PERCENTILES, qs)
        }
    return _window_summary(
        count=len(lat),
        error_count=float(err.sum()),
        actual_duration=actual_duration,
        w_start=w_start,
        w_len=w_len,
        wcount=wcount,
        werr=float(err[mask].sum()),
        percentiles=percentiles,
        utilization=res.utilization,
        service_names=service_names,
        replicas=replicas,
    )


def window_summary_from_summary(
    summary,
    service_names=(),
    replicas=None,
) -> WindowSummary:
    """Trim-window statistics from a RunSummary's ``win_*``
    accumulators (the block loop's counterpart of
    :func:`trim_window_summary`).

    The reported window is the one the device accumulated
    (``summary.win_lo``/``win_hi``, placed from the expected duration),
    never a recomputed one, so windowed QPS stays consistent with
    ``win_count``.  Produced with ``trim=False`` the window covers the
    whole run and the length falls back to the actual duration.
    """
    count = int(summary.count)
    actual_duration = float(summary.end_max) if count else 0.0
    win_lo = float(summary.win_lo)
    win_hi = float(summary.win_hi)
    if np.isfinite(win_hi):
        w_start, w_len = win_lo, win_hi - win_lo
    else:  # trim was off: the "window" is the whole run
        w_start, w_len = 0.0, actual_duration
    wcount = int(summary.win_count)
    percentiles = {}
    if wcount:
        qs = quantile_from_histogram(
            summary.win_latency_hist, [p / 100.0 for p in PERCENTILES],
        )
        percentiles = {
            "p" + str(p).replace(".", ""): int(v * 1e6)
            for p, v in zip(PERCENTILES, qs)
        }
    return _window_summary(
        count=count,
        error_count=float(summary.error_count),
        actual_duration=actual_duration,
        w_start=w_start,
        w_len=w_len,
        wcount=wcount,
        werr=float(summary.win_error_count),
        percentiles=percentiles,
        utilization=summary.utilization,
        service_names=service_names,
        replicas=replicas,
    )


DEFAULT_CSV_KEYS = (
    "Labels,StartTime,RequestedQPS,ActualQPS,NumThreads,min,max,"
    "p50,p75,p90,p99,p999,errorPercent"
)


def write_csv(keys: str, data: List[dict], path) -> None:
    """fortio.py:215-232: header then one row per record, '-' for gaps."""
    lst = keys.split(",")
    with open(path, "w") as out:
        out.write(keys + "\n")
        for gd in data:
            out.write(",".join(str(gd.get(k, "-")) for k in lst) + "\n")
