"""Run summaries: the small, reducible view of a simulation, in torch.

The port of ``isotope_tpu.sim.summary`` without the per-service
``MetricsCollector`` series (a later slice).  Everything in a
:class:`RunSummary` is O(buckets), never O(N), so any number of request
blocks accumulates into one summary: each block is reduced by
:func:`summarize`, the block summaries are stacked with :func:`stack`
and reduced by :func:`reduce_stacked`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isotope_tpu_torch.metrics.histogram import (
    latency_histogram,
    quantile_from_histogram,
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
        utilization=res.utilization,
        unstable=res.unstable,
    )


def stack(parts: List[RunSummary]) -> RunSummary:
    """Stack per-block summaries along a new leading block axis."""
    return RunSummary(*(torch.stack(leaves) for leaves in zip(*parts)))


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
        utilization=parts.utilization.amax(0),
        unstable=parts.unstable.any(0),
    )
