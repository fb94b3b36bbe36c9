"""Run planning of the ``simulate`` command.

A partial port of ``isotope_tpu.runner.run``: the run label, the
request count a load implies, the protected runs' window and block
sizing, and a fleet-served case's importance-splitting pass.  The
experiment runner itself (``run_experiment``, sweeps, checkpoints, flat
rows) is ROADMAP item 10.
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


def splitting_pass(sim, load, n: int, source, block: int, split,
                   protected: bool = False, roll: bool = False,
                   timeline_window_s: float = 10.0, timeline=None,
                   chaos_jitter=None) -> dict:
    """The importance-splitting estimate of one fleet-served case
    (``sim/splitting.py``, the reference's ``_splitting_pass``): one
    SHORT-HORIZON fleet a level (``max(256, int(n * split.horizon))``
    requests a member), members ranked by ``split``'s severity, the
    worst quantile cloned with redrawn seeds.  The fleets draw from a
    lane of their own, member ``w`` under ``RootedSource(source,
    SPLIT_INDEX)`` extended by ``w`` (the reference's ``fold_in(
    fold_in(run_key, 777_000_001), w)``).  A protected case runs
    ``run_policies_ensemble`` / ``run_rollouts_ensemble`` (``roll``) on
    its window and block (:func:`protected_window_block`); under the
    Simulator's chaos schedule and ``chaos_jitter`` each member's
    schedule is jittered from its chaos seeds.  Returns the
    ``isotope-splitting/v1`` document.  Unlike the reference's
    best-effort pass, a failure raises."""
    import numpy as np

    from isotope_tpu_torch.sim import splitting as split_mod
    from isotope_tpu_torch.sim.draws import SPLIT_INDEX, RootedSource
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    n_short = max(256, int(n * split.horizon))
    chaos = tuple(sim._chaos_events)
    jitter = chaos_jitter if chaos else None
    base = RootedSource(source, SPLIT_INDEX)
    kwargs = {}
    blk = block
    if protected:
        win, blk = protected_window_block(sim, load, block,
                                          timeline_window_s, timeline)
        method = (
            sim.run_rollouts_ensemble if roll
            else sim.run_policies_ensemble
        )
        kwargs["window_s"] = win
    else:
        method = sim.run_ensemble
    if jitter is not None:
        from isotope_tpu_torch.resilience import faults

        reps = sim.compiled.services.replicas_by_name()

    def evaluate(chaos_seeds, work_seeds):
        espec = EnsembleSpec.of(len(work_seeds))
        mkeys = [RootedSource(base, int(w)) for w in work_seeds]
        mc = None
        if jitter is not None:
            mc = [
                faults.jitter_chaos_events(chaos, jitter, row, reps)
                for row in np.asarray(chaos_seeds)
            ]
        out = method(
            load, n_short, base, espec, block_size=blk, trim=False,
            member_keys=mkeys, member_chaos=mc, **kwargs,
        )
        return split_mod.severity_scores(split, out.summaries,
                                         out.timelines)

    return split_mod.subset_estimate(
        evaluate, split, chaos_components=max(len(chaos), 1),
    )
