"""Coarse log-spaced latency buckets, in torch.

A partial port of ``isotope_tpu.metrics.attribution``: only the bucket
helpers the flight recorder's per-window latency histogram bins with
(``metrics/timeline.py``).  The critical-path blame attribution itself
(``run_attributed``, ``estimate_tail_cut``, the top-K exemplars) is
ROADMAP item 8 and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

# Coarse log-spaced buckets: (W, NUM_BLAME_BUCKETS) per-window histograms
NUM_BLAME_BUCKETS = 64
_BLO, _BHI = 1e-6, 10.0  # seconds
_B_LOG_LO = float(np.log(_BLO))
_B_INV_LOG_R = float((NUM_BLAME_BUCKETS - 2) / np.log(_BHI / _BLO))

BLAME_EDGES = np.concatenate(
    [[0.0], np.geomspace(_BLO, _BHI, NUM_BLAME_BUCKETS - 1), [np.inf]]
)


def blame_bucket_index(v: torch.Tensor) -> torch.Tensor:
    """Bucket index per value (int64): the float32 arithmetic-index
    trick of ``metrics/histogram.bucket_index`` at the coarse width."""
    t = (torch.log(v) - _B_LOG_LO) * _B_INV_LOG_R
    t = torch.clamp(t, -1.0, NUM_BLAME_BUCKETS - 2)
    idx = torch.floor(torch.nan_to_num(t, nan=0.0)).to(torch.int64) + 1
    return torch.where(torch.isnan(t), NUM_BLAME_BUCKETS - 1, idx)


def blame_bucket_centers() -> np.ndarray:
    centers = np.empty(NUM_BLAME_BUCKETS)
    centers[0] = BLAME_EDGES[1] / 2
    centers[1:-1] = np.sqrt(BLAME_EDGES[1:-2] * BLAME_EDGES[2:-1])
    centers[-1] = BLAME_EDGES[-2]
    return centers
