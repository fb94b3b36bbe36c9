"""Run summaries: the small, reducible view of a simulation, in torch.

The port of ``isotope_tpu.sim.summary``.  Everything in a
:class:`RunSummary` is O(buckets), never O(N), so any number of request
blocks accumulates into one summary: each block is reduced by
:func:`summarize` (with the per-service Prometheus series of a
``MetricsCollector`` when one is given), the block summaries are stacked
with :func:`stack` and reduced by :func:`reduce_stacked`;
:func:`zeros_summary` is the identity of :func:`summary_accumulate`, the
primer of the mesh runs' overlapped merge (``parallel/sharded.py``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isotope_tpu_torch.metrics.histogram import (
    NUM_BUCKETS,
    bucket_index,
    latency_histogram,
    quantile_from_histogram,
)
from isotope_tpu_torch.metrics.prometheus import (
    MetricsCollector,
    ServiceMetrics,
)

F32 = torch.float32


class RunSummary(NamedTuple):
    """Reduced run summary; every leaf is a tensor on the run's device."""

    count: torch.Tensor          # scalar — requests simulated
    error_count: torch.Tensor    # scalar — client-visible 500s
    hop_events: torch.Tensor     # scalar — executed hops (the benchmark unit)
    latency_sum: torch.Tensor    # scalar
    latency_m2: torch.Tensor     # scalar — centered second moment (Welford)
    latency_min: torch.Tensor
    latency_max: torch.Tensor
    latency_hist: torch.Tensor   # (NUM_BUCKETS,) fine log-spaced
    end_max: torch.Tensor        # scalar — max client_end (run duration)
    win_lo: torch.Tensor         # scalar — trim-window bounds actually used
    win_hi: torch.Tensor         # scalar — (inf when trim was off)
    win_count: torch.Tensor      # scalar — requests in the trim window
    win_error_count: torch.Tensor
    win_latency_hist: torch.Tensor  # (NUM_BUCKETS,)
    metrics: Optional[ServiceMetrics]  # per-service series (None = skipped)
    utilization: torch.Tensor    # (S,)
    unstable: torch.Tensor       # (S,) bool

    def quantiles_s(self, qs=(0.5, 0.75, 0.9, 0.99, 0.999)) -> np.ndarray:
        return quantile_from_histogram(self.latency_hist, qs)

    @property
    def mean_latency_s(self) -> float:
        return float(self.latency_sum) / max(float(self.count), 1.0)

    @property
    def stddev_latency_s(self) -> float:
        n = max(float(self.count), 1.0)
        return float(np.sqrt(max(float(self.latency_m2), 0.0) / n))


def summarize(
    res,
    collector: Optional[MetricsCollector] = None,
    window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> RunSummary:
    """Reduce one block's SimResults to a RunSummary.

    ``window`` is the ``[lo, hi)`` client-start interval whose requests
    also accumulate into the ``win_*`` fields (the collector's trim
    window); ``None`` aliases the window fields to the whole block.
    """
    lat = res.client_latency
    dev = lat.device
    n = lat.shape[0]
    count = torch.tensor(float(n), dtype=F32, device=dev)
    error_count = res.client_error.sum().to(F32)
    lat_sum = lat.sum()
    # centered second moment: conditioned for cv << 1 where the raw
    # E[x^2] - mean^2 form cancels catastrophically in f32
    mean = lat_sum / float(max(n, 1))
    m2 = ((lat - mean) ** 2).sum()
    hist = latency_histogram(lat)
    if window is None:
        win_lo = torch.tensor(0.0, dtype=F32, device=dev)
        win_hi = torch.tensor(np.inf, dtype=F32, device=dev)
        win_count, win_error_count, win_hist = count, error_count, hist
    else:
        win_lo, win_hi = window
        in_win = (res.client_start >= win_lo) & (res.client_start < win_hi)
        win_w = in_win.to(F32)
        win_count = win_w.sum()
        win_error_count = (res.client_error & in_win).sum().to(F32)
        win_hist = latency_histogram(lat, win_w)
    return RunSummary(
        count=count,
        error_count=error_count,
        # the executed-hop count is exact as an integer; f32 like the
        # reference's summary leaf
        hop_events=res.hop_events.to(F32),
        latency_sum=lat_sum,
        latency_m2=m2,
        latency_min=lat.min(),
        latency_max=lat.max(),
        latency_hist=hist,
        end_max=res.client_end.max(),
        win_lo=win_lo,
        win_hi=win_hi,
        win_count=win_count,
        win_error_count=win_error_count,
        win_latency_hist=win_hist,
        metrics=collector.collect(res) if collector is not None else None,
        utilization=res.utilization,
        unstable=res.unstable,
    )


def summarize_members(res, members: int,
                      window: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> RunSummary:
    """Reduce a folded fleet block (``members`` x N request rows,
    member-major) to each member's RunSummary, stacked along a leading
    member axis: :func:`summarize` on each member's rows, in row
    reductions over an (M, N) view.  ``window`` is the members'
    ``(lo, hi)`` trim bounds, two (M,) tensors.  Counts, extrema and
    histograms equal the per-member summaries; the float sums may
    differ in float32 summation order."""
    M = members
    lat = res.client_latency.view(M, -1)
    dev = lat.device
    n = lat.shape[1]
    count = torch.full((M,), float(n), dtype=F32, device=dev)
    err = res.client_error.view(M, -1)
    error_count = err.sum(1).to(F32)
    lat_sum = lat.sum(1)
    mean = lat_sum / float(max(n, 1))
    m2 = ((lat - mean[:, None]) ** 2).sum(1)
    offset = (
        torch.arange(M, device=dev) * NUM_BUCKETS
    )[:, None]

    def hist(weights):
        return torch.zeros(
            M * NUM_BUCKETS, dtype=F32, device=dev
        ).index_add_(
            0, (bucket_index(lat) + offset).reshape(-1),
            weights.reshape(-1).to(F32),
        ).view(M, NUM_BUCKETS)

    h = hist(torch.ones_like(lat))
    if window is None:
        win_lo = torch.zeros(M, dtype=F32, device=dev)
        win_hi = torch.full((M,), np.inf, dtype=F32, device=dev)
        win_count, win_error_count, win_hist = count, error_count, h
    else:
        win_lo, win_hi = window
        start = res.client_start.view(M, -1)
        in_win = (start >= win_lo[:, None]) & (start < win_hi[:, None])
        win_w = in_win.to(F32)
        win_count = win_w.sum(1)
        win_error_count = (err & in_win).sum(1).to(F32)
        win_hist = hist(win_w)
    return RunSummary(
        count=count,
        error_count=error_count,
        hop_events=res.hop_sent.view(M, -1).sum(1).to(F32),
        latency_sum=lat_sum,
        latency_m2=m2,
        latency_min=lat.amin(1),
        latency_max=lat.amax(1),
        latency_hist=h,
        end_max=res.client_end.view(M, -1).amax(1),
        win_lo=win_lo,
        win_hi=win_hi,
        win_count=win_count,
        win_error_count=win_error_count,
        win_latency_hist=win_hist,
        metrics=None,
        utilization=res.utilization,
        unstable=res.unstable,
    )


def _stack_leaves(leaves):
    if leaves[0] is None:
        return None
    if isinstance(leaves[0], ServiceMetrics):
        return ServiceMetrics(*(torch.stack(x) for x in zip(*leaves)))
    return torch.stack(leaves)


def stack(parts: List[RunSummary]) -> RunSummary:
    """Stack per-block summaries along a new leading block axis."""
    return RunSummary(*(_stack_leaves(leaves) for leaves in zip(*parts)))


def summary_accumulate(acc: RunSummary, part: RunSummary) -> RunSummary:
    """Streaming two-summary merge (no leading axis): the Chan/Welford
    pairwise form of :func:`reduce_stacked`, in the reference's op
    order.  Integer fields, histograms, minima and maxima equal the
    stacked reduction's; the float sums may differ by reduction order
    (the search brackets merge a winner's rung segments with it)."""
    n = acc.count + part.count
    mean_a = acc.latency_sum / torch.clamp(acc.count, min=1.0)
    mean_b = part.latency_sum / torch.clamp(part.count, min=1.0)
    delta = mean_b - mean_a
    m2 = (
        acc.latency_m2
        + part.latency_m2
        + delta * delta * acc.count * part.count / torch.clamp(n, min=1.0)
    )
    metrics = None
    if acc.metrics is not None:
        metrics = ServiceMetrics(*(
            a + b for a, b in zip(acc.metrics, part.metrics)
        ))
    return RunSummary(
        count=n,
        error_count=acc.error_count + part.error_count,
        hop_events=acc.hop_events + part.hop_events,
        latency_sum=acc.latency_sum + part.latency_sum,
        latency_m2=m2,
        latency_min=torch.minimum(acc.latency_min, part.latency_min),
        latency_max=torch.maximum(acc.latency_max, part.latency_max),
        latency_hist=acc.latency_hist + part.latency_hist,
        end_max=torch.maximum(acc.end_max, part.end_max),
        win_lo=torch.maximum(acc.win_lo, part.win_lo),
        win_hi=torch.maximum(acc.win_hi, part.win_hi),
        win_count=acc.win_count + part.win_count,
        win_error_count=acc.win_error_count + part.win_error_count,
        win_latency_hist=acc.win_latency_hist + part.win_latency_hist,
        metrics=metrics,
        utilization=torch.maximum(acc.utilization, part.utilization),
        unstable=acc.unstable | part.unstable,
    )


def merge_m2(counts, sums, m2s, axis=0):
    """Chan/Welford merge of per-part centered second moments."""
    n_tot = counts.sum(axis)
    s_tot = sums.sum(axis)
    mean_i = sums / torch.clamp(counts, min=1.0)
    mean_tot = s_tot / torch.clamp(n_tot, min=1.0)
    return m2s.sum(axis) + (counts * (mean_i - mean_tot) ** 2).sum(axis)


def reduce_stacked(parts: RunSummary) -> RunSummary:
    """Reduce a summary whose leaves carry a leading block axis to a
    single RunSummary."""
    metrics = None
    if parts.metrics is not None:
        metrics = ServiceMetrics(*(x.sum(0) for x in parts.metrics))
    return RunSummary(
        count=parts.count.sum(0),
        error_count=parts.error_count.sum(0),
        hop_events=parts.hop_events.sum(0),
        latency_sum=parts.latency_sum.sum(0),
        latency_m2=merge_m2(parts.count, parts.latency_sum,
                            parts.latency_m2),
        latency_min=parts.latency_min.amin(0),
        latency_max=parts.latency_max.amax(0),
        latency_hist=parts.latency_hist.sum(0),
        end_max=parts.end_max.amax(0),
        win_lo=parts.win_lo.amax(0),   # identical across blocks
        win_hi=parts.win_hi.amax(0),
        win_count=parts.win_count.sum(0),
        win_error_count=parts.win_error_count.sum(0),
        win_latency_hist=parts.win_latency_hist.sum(0),
        metrics=metrics,
        utilization=parts.utilization.amax(0),
        unstable=parts.unstable.any(0),
    )


def zeros_summary(
    collector: Optional[MetricsCollector],
    num_services: int,
    svc_rows: Optional[int] = None,
    device="cpu",
) -> RunSummary:
    """The identity element of :func:`summary_accumulate`.

    Primes the collective/compute overlap pipeline (parallel/
    sharded.py): sums start at 0, mins at +inf, maxes at -inf, so
    accumulating any real block summary over this leaves the block
    unchanged.  ``svc_rows`` overrides the leading dimension of the
    svc-sharded per-service histograms (after the reduce-scatter each
    rank holds an ``s_pad / svc``-row tile, not the full ``S``).
    """
    metrics = None
    if collector is not None:
        metrics = collector.zeros(device)
        if svc_rows is not None:
            metrics = metrics._replace(
                duration_hist=torch.zeros(
                    (svc_rows,) + tuple(metrics.duration_hist.shape[1:]),
                    dtype=F32, device=device,
                ),
                response_size_hist=torch.zeros(
                    (svc_rows,)
                    + tuple(metrics.response_size_hist.shape[1:]),
                    dtype=F32, device=device,
                ),
            )

    def z():
        return torch.zeros((), dtype=F32, device=device)

    return RunSummary(
        count=z(),
        error_count=z(),
        hop_events=z(),
        latency_sum=z(),
        latency_m2=z(),
        latency_min=torch.tensor(np.inf, dtype=F32, device=device),
        latency_max=torch.tensor(-np.inf, dtype=F32, device=device),
        latency_hist=torch.zeros(NUM_BUCKETS, dtype=F32, device=device),
        end_max=z(),
        win_lo=z(),
        win_hi=z(),
        win_count=z(),
        win_error_count=z(),
        win_latency_hist=torch.zeros(NUM_BUCKETS, dtype=F32, device=device),
        metrics=metrics,
        utilization=torch.zeros(num_services, dtype=F32, device=device),
        unstable=torch.zeros(num_services, dtype=torch.bool, device=device),
    )
