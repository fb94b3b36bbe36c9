"""Numeric sentinels: validate run outputs before they reach artifacts.

The port of ``isotope_tpu.resilience.sentinels``.  A NaN escaping one
segment of the block would propagate silently into histograms,
quantiles and the benchmark CSV.  The sentinels check the O(buckets)
summary (never the per-request tensors) right after the run, on the
host (one copy of each field):

- every scalar / histogram field is finite;
- latencies and counts are non-negative (a negative latency means the
  downward start-time pass went wrong, not that the workload is odd).

Violations raise :class:`NumericSentinelError` — DETERMINISTIC in the
taxonomy: the same run reproduces the same NaN, so the supervisor
fails the case instead of retrying it.  Localization to the offending
segment happens in ``--telemetry=detail`` mode, where the engine's
per-level fences see each level's output (telemetry.core
``segment_fence`` records ``numeric_sentinel{segment=...}`` gauges).
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.resilience.taxonomy import NumericSentinelError

#: summary fields that must be finite AND non-negative
_NONNEG_FIELDS = (
    "count", "error_count", "hop_events", "latency_sum", "latency_m2",
    "latency_min", "latency_max", "latency_hist", "end_max",
    "win_count", "win_error_count", "win_latency_hist",
)


def _violations(named: Iterable[Tuple[str, object]],
                nonneg: bool) -> list:
    bad = []
    for name, v in named:
        if v is None:
            continue
        a = (
            v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)
        )
        if not np.issubdtype(a.dtype, np.floating):
            continue
        # win_hi is +inf when the trim window is off: finite-or-+inf is
        # the contract for bounds; NaN is never acceptable
        if np.isnan(a).any():
            bad.append(f"{name}: NaN")
        elif np.isneginf(a).any():
            bad.append(f"{name}: -inf")
        elif nonneg and (a < 0).any():
            bad.append(f"{name}: negative ({float(a.min()):g})")
    return bad


def check_summary(summary, label: str = "run") -> None:
    """Validate a :class:`~isotope_tpu_torch.sim.summary.RunSummary`."""
    fields = summary._asdict()
    bad = _violations(
        ((n, fields.get(n)) for n in _NONNEG_FIELDS), nonneg=True
    )
    # utilization may legitimately exceed 1 (overload) but never NaN
    bad += _violations((("utilization", fields.get("utilization")),),
                       nonneg=True)
    if bad:
        telemetry.counter_inc("numeric_sentinel_violations")
        raise NumericSentinelError(
            f"numeric sentinel tripped on {label}: {'; '.join(bad)} "
            "(re-run with --telemetry=detail to localize the offending "
            "segment)"
        )


def check_results(res, label: str = "run") -> None:
    """Validate raw :class:`~isotope_tpu_torch.sim.engine.SimResults`
    (the non-summary entry points: ``Simulator.run``, tracing)."""
    bad = _violations(
        (
            ("client_latency", res.client_latency),
            ("client_start", res.client_start),
            ("hop_latency", res.hop_latency),
            ("utilization", res.utilization),
        ),
        nonneg=True,
    )
    if bad:
        telemetry.counter_inc("numeric_sentinel_violations")
        raise NumericSentinelError(
            f"numeric sentinel tripped on {label}: {'; '.join(bad)} "
            "(re-run with --telemetry=detail to localize the offending "
            "segment)"
        )
