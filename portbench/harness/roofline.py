"""The yardstick of a kernel's share of its roofline.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
(dense rates).  The census join's least time is reckoned from the
topology and the rows alone, so the share reads the same work whatever
implements the join: for every hop that has a script, each of its steps
reads its call census once (4 B) and writes its exclusive prefix once
(4 B), and the hop writes its busy time once (4 B), reads a fail step
(4 B) where one of its calls has a timeout and an error flag (1 B) where
its service can fail; the step tables (sleep floor and mask, 8 B a step)
are read once a block.  No step is padded.
"""
from __future__ import annotations

import math
from typing import Optional

from portbench.reference.topology import parse, unroll

#: card name -> (HBM bytes/s, float32 operations/s outside tensor cores)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
    "NVIDIA H100": (3.35e12, 67e12),
}


def peaks(device_name: str) -> Optional[tuple]:
    return PEAKS.get(device_name)


class CensusWork:
    """Bytes and operations of the census join of one row (request)."""

    def __init__(self, config: dict):
        topo = parse(config["topology"])
        tree = unroll(topo)
        steps = rows = tables = 0
        for h in range(tree.num_hops):
            script = tree.steps[h]
            if not script:
                continue
            calls = [tree.calls[c] for _, ids in script for c in ids]
            if not calls:
                continue      # a script of sleeps alone is static
            steps += len(script)
            rows += 4
            if any(math.isfinite(t) for _, _, t, _ in calls):
                rows += 4
            if topo.error_rate[tree.service[h]] > 0:
                rows += 1
            tables += 8 * len(script)
        self.bytes_per_row = 8 * steps + rows
        self.table_bytes = tables
        self.ops_per_row = 4 * steps

    def least_seconds(self, rows: int, blocks: int, device_name: str
                      ) -> Optional[float]:
        """Least time of ``rows`` rows in ``blocks`` blocks."""
        pk = peaks(device_name)
        if pk is None:
            return None
        nbytes = rows * self.bytes_per_row + blocks * self.table_bytes
        return max(nbytes / pk[0], rows * self.ops_per_row / pk[1])
