"""Run planning of the ``simulate`` command.

A partial port of ``isotope_tpu.runner.run``: the run label, the
request count a load implies, and the protected runs' window and block
sizing.  The experiment runner itself (``run_experiment``, sweeps,
checkpoints, flat rows) is ROADMAP item 10.
"""
from __future__ import annotations

import pathlib
from typing import Tuple


def run_label(topo_path: str, env: str, load, extra: str = "") -> str:
    """The reference's run label: topology stem, environment, load, and
    the ``--labels`` suffix."""
    stem = pathlib.Path(topo_path).stem
    qps = "max" if load.qps is None else f"{load.qps:g}"
    base = f"{stem}_{env.lower()}_{qps}qps_{load.connections}c"
    return f"{base}_{extra}" if extra else base


def num_requests(load, capacity: float, cap: int) -> int:
    """Size the batch so the simulated run spans ``load.duration_s``."""
    rate = capacity if load.qps is None else min(load.qps, capacity)
    return max(1, min(int(rate * load.duration_s), cap))


def protected_window_block(sim, load, block: int,
                           timeline_window_s: float,
                           timeline=None) -> Tuple[float, int]:
    """The protected runs' ``(window_s, block)``: the control loops act
    at block boundaries, so the block is capped near ONE recorder window
    of requests (the default memory-sized block would give a whole-run
    actuation lag).  Without an explicit ``--timeline`` width the window
    is ``min(timeline_window_s, duration / 8)``, so a run spans at least
    ~8 windows: a window that never completes is a control loop that
    never observes."""
    if timeline is not None:
        win = float(timeline)
    else:
        win = min(timeline_window_s, max(load.duration_s / 8.0, 1e-3))
    rate = load.qps if load.qps is not None else sim.capacity_qps()
    return win, max(256, min(block, int(max(rate * win, 1.0))))
