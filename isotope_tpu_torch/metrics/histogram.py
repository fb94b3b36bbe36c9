"""Log-spaced latency histograms with quantile recovery, in torch.

The port of ``isotope_tpu.metrics.histogram``: 2048 geometric buckets
over 1us..10s (~0.6% relative width), so a run keeps one (B,) count
vector per block instead of per-request latencies, and p50..p999 come
back from it within a fraction of a percent.  The bucket layout is the
reference's, so histograms of both packages are directly comparable.
"""
from __future__ import annotations

import numpy as np
import torch

NUM_BUCKETS = 2048
_LO, _HI = 1e-6, 10.0  # seconds

# bucket i covers [EDGES[i], EDGES[i+1]); underflow in 0, overflow in last.
# bucket_index computes membership with float32 log arithmetic, so a value
# lying exactly on an edge may land in the adjacent bucket.
EDGES = np.concatenate(
    [[0.0], np.geomspace(_LO, _HI, NUM_BUCKETS - 1), [np.inf]]
)
_LOG_LO = float(np.log(_LO))
_INV_LOG_R = float((NUM_BUCKETS - 2) / np.log(_HI / _LO))


def bucket_index(latencies: torch.Tensor) -> torch.Tensor:
    """Bucket index per latency (int64), pure elementwise math."""
    t = (torch.log(latencies) - _LOG_LO) * _INV_LOG_R
    t = torch.clamp(t, -1.0, NUM_BUCKETS - 2)  # catches 0 / -inf
    idx = torch.floor(torch.nan_to_num(t, nan=0.0)).to(torch.int64) + 1
    # NaN lands in the overflow bucket, like a searchsorted would put it
    return torch.where(torch.isnan(t), NUM_BUCKETS - 1, idx)


def latency_histogram(latencies: torch.Tensor, weights=None) -> torch.Tensor:
    """Scatter-add latencies (seconds) into the fine log-spaced buckets."""
    idx = bucket_index(latencies)
    w = weights if weights is not None else torch.ones_like(latencies)
    return torch.zeros(
        NUM_BUCKETS, dtype=torch.float32, device=latencies.device
    ).index_add_(0, idx, w.to(torch.float32))


def bucket_centers() -> np.ndarray:
    """Representative value per bucket (geometric mean of its edges)."""
    centers = np.empty(NUM_BUCKETS)
    centers[0] = EDGES[1] / 2
    centers[1:-1] = np.sqrt(EDGES[1:-2] * EDGES[2:-1])
    centers[-1] = EDGES[-2]
    return centers


def quantile_from_histogram(hist, qs) -> np.ndarray:
    """Recover quantiles from bucket counts (geometric-mean bucket value).

    ``hist`` is a host array or a tensor on any device; the recovery runs
    in float64 on the host, as in the reference.
    """
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total == 0:
        return np.zeros(len(qs))
    cum = np.cumsum(hist)
    idx = np.searchsorted(cum, np.asarray(qs) * total, side="left")
    return bucket_centers()[np.minimum(idx, NUM_BUCKETS - 1)]
