"""The cost model's plan-only memory estimate and the fleet auto chunk.

The part of ``isotope_tpu.analysis.costmodel`` that a Monte Carlo fleet
needs to size its member chunk (``Simulator.ensemble_chunk_size``):
the plan-only peak bytes of one member's block (``estimate_run``
without a traced program: ten float32 (block, H) event tensors plus the
flight recorder's carries), the protected and observed fleets' carry
bytes per member, the device's memory, and the balanced split
:func:`ensemble_chunk`.  Copied on the host, numbers for numbers; the
traced-program parts are ROADMAP item 13.  A chunk never changes a
result: chunked and unchunked fleets are equal.
"""
from __future__ import annotations

import os
from typing import Optional

#: env override of the per-device memory (bytes), as in the reference
ENV_DEVICE_BYTES = "ISOTOPE_VET_DEVICE_BYTES"

#: share of the device's memory a fleet chunk may fill
CAPACITY_FILL = 0.85


def device_capacity_bytes(override: Optional[float] = None,
                          device=None) -> Optional[float]:
    """Per-device memory in bytes, or None when unknown: the explicit
    override, then ``ISOTOPE_VET_DEVICE_BYTES``, then the CUDA device's
    total memory.  The CPU reports nothing, so a fleet on the CPU runs
    as one chunk, as in the reference."""
    if override is not None:
        return float(override)
    env = os.environ.get(ENV_DEVICE_BYTES, "").strip()
    if env:
        return float(env)
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return float(torch.cuda.get_device_properties(
            torch.device(device)
        ).total_memory)
    return None


def timeline_bytes(sim, num_windows: Optional[int] = None) -> float:
    """Worst-case bytes of the flight recorder's windowed carries: the
    per-service (S, W) series (5 fields), the client (W,) series and
    the (W, 64) latency histogram; zero when ``SimParams.timeline`` is
    off.  ``num_windows`` defaults to the planner's worst case."""
    params = sim.params
    if not getattr(params, "timeline", False):
        return 0.0
    from isotope_tpu_torch.metrics.timeline import (
        ELEM_BUDGET,
        NUM_BLAME_BUCKETS,
    )

    s = max(sim.compiled.num_services, 1)
    w = (
        int(num_windows)
        if num_windows
        else max(
            1,
            min(int(params.timeline_max_windows), ELEM_BUDGET // s),
        )
    )
    elems = 5 * s * w + 4 * w + w * NUM_BLAME_BUCKETS
    return 4.0 * elems


def peak_bytes_at_block(sim, block_requests: int) -> float:
    """The plan-only peak of ``estimate_run``: the live working set is
    a few event tensors wide (ten float32 (block, H) tensors), plus the
    recorder's carries."""
    h = max(sim.compiled.num_hops, 1)
    return 10.0 * 4.0 * block_requests * h + timeline_bytes(sim)


def protected_carry_bytes(sim, num_windows: int,
                          roll: bool = False) -> float:
    """Per-member bytes of a protected fleet's carry: the recorder's
    windowed accumulator plus the policy / rollout state, observation
    channels and actuation series.  All float32."""
    s = max(sim.compiled.num_services, 1)
    w = max(int(num_windows), 1)
    total = timeline_bytes(sim, num_windows=w)
    if getattr(sim, "_policies", None) is not None:
        total += 4.0 * (7 * s + s * w + 6 * s * w + w + 3 * s)
    if roll and getattr(sim, "_rollouts", None) is not None:
        total += 4.0 * (6 * s + s * 2 * w * 4 + 6 * s * w + w
                        + 3 * s * 2 * w)
    return total


def observability_carry_bytes(sim, attr: bool = False,
                              timeline_windows: Optional[int] = None
                              ) -> float:
    """Per-member bytes of an observed fleet's reductions: the reduced
    ``AttributionSummary`` leaves (5 scalars, 11 per-hop vectors, two
    (S, 64) blame histograms) with the top-K exemplar carry, and the
    recorder's windowed accumulator."""
    from isotope_tpu_torch.metrics.attribution import NUM_BLAME_BUCKETS

    total = 0.0
    if attr:
        s = max(sim.compiled.num_services, 1)
        h = max(sim.compiled.num_hops, 1)
        k = max(int(getattr(sim.params, "attribution_top_k", 0)), 0)
        total += 4.0 * (5 + 11 * h + 2 * s * NUM_BLAME_BUCKETS)
        total += 4.0 * (k * (3 + 4 * h))
    if timeline_windows is not None:
        total += timeline_bytes(sim, num_windows=timeline_windows)
    return total


def search_carry_bytes(connections: int) -> float:
    """Per-member bytes of a search bracket's carry (``sim/search.py``):
    the block offset (int32) plus the ``(t0, conn_t0, req_off)`` clocks
    (float32; ``conn_t0`` holds one slot a closed-loop connection)."""
    return 4.0 * (3 + max(int(connections), 1))


def ensemble_chunk(
    members: int,
    peak_bytes_per_member: float,
    capacity_bytes: Optional[float],
    fill: float = CAPACITY_FILL,
    carry_bytes_per_member: float = 0.0,
) -> int:
    """Members per chunk of a fleet: ``members * peak_bytes`` must fit
    the capacity budget.  Balanced split: the chunk count is minimized
    first and members spread evenly across chunks (33 members over a
    16-member budget run 11 + 11 + 11).  Unknown capacity runs the
    whole fleet as one chunk."""
    members = max(int(members), 1)
    if (
        capacity_bytes is None
        or capacity_bytes <= 0
        or peak_bytes_per_member <= 0
    ):
        return members
    budget = fill * float(capacity_bytes)
    per_member = float(peak_bytes_per_member) + max(
        float(carry_bytes_per_member), 0.0
    )
    per_dispatch = int(budget // per_member)
    if per_dispatch >= members:
        return members
    per_dispatch = max(per_dispatch, 1)
    num_chunks = -(-members // per_dispatch)
    return -(-members // num_chunks)
