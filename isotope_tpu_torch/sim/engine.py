"""The vectorized event-tree simulation engine, in torch.

The port of ``isotope_tpu.sim.engine``'s main path.  One block of
requests is one tensor program over a (request x hop) grid:

- an upward sweep over the depth levels of the unrolled call tree
  computes each hop's server-side duration: concurrent fan-outs join by
  a scatter-max census per (parent, step) slot, serial retry attempts
  sum, a finite timeout clamps and transport-fails an attempt, and the
  census join (max with the sleep floor, step mask, fail/error
  truncation, row sum, exclusive step prefix) runs in the hand-written
  CUDA kernel of ``native/census.py`` on the card;
- a level whose dense (hops x steps) grid is pathological (one wide hub
  among thousands of short scripts) is tiled: hops binned by script
  width run the dense census on fixed-width tiles, and scripts wider
  than the tile cap keep the sparse call-slot encoding (packed segment
  sums over the call-bearing steps only);
- a downward sweep decides which hops were actually sent, and a second
  one assigns absolute start times;
- arrivals are a Poisson cumsum (open loop) or per-connection pacing
  (closed loop, Fortio's workers);
- queueing waits are sampled from the M/M/k law at each service's
  offered load, with the sibling, hierarchical and retry Gaussian
  copulas of the reference; the saturated closed loop (``-qps max``)
  samples the finite-population law of ``sim/closed.py`` instead;
- scenario physics: chaos phases (piecewise-constant replica counts,
  outages that refuse calls and truncate their callers' scripts, drain
  windows after an overloaded phase, ungraceful kills that reset the
  requests resident at the kill instant), traffic-split churn (per-hop
  send-probability weights) and the phased mTLS tax; each request takes
  its (chaos x churn) phase row from its nominal arrival time;
- per-service load-balancing laws (``sim/lb.py``: least_request,
  ring_hash, wrr) replace the M/M/k wait law where a topology declares
  them, and panic routing under chaos fast-fails the dead-backend share
  of a pool below its threshold through the 500 path.

Random numbers come from a draw source (``sim/draws.py``), so the same
draws can drive this engine and the JAX one.  The JAX engine groups
close-shaped levels into ``lax.scan`` buckets to bound its trace size;
this port sweeps every level one by one, which computes the same
values (the JAX package pins buckets against unrolled levels).

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): policies, rollouts, attribution, timelines and
ensembles.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import (
    Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple,
)

import numpy as np
import torch
import torch.nn.functional as F

from isotope_tpu_torch.compiler import buckets
from isotope_tpu_torch.compiler.program import CompiledGraph, hop_wire_times
from isotope_tpu_torch.native.census import census
from isotope_tpu_torch.sim import closed, queueing
from isotope_tpu_torch.sim import lb as lb_mod
from isotope_tpu_torch.sim.config import (
    CLOSED_LOOP,
    OPEN_LOOP,
    SERVICE_TIME_DETERMINISTIC,
    SERVICE_TIME_LOGNORMAL,
    SERVICE_TIME_PARETO,
    ChaosEvent,
    LoadModel,
    MtlsSchedule,
    SimParams,
    TrafficSplit,
)
from isotope_tpu_torch.sim.draws import (
    BLOCK_INDEX_BASE,
    SAT_PILOT_SEED,
    SVC_EXPONENTIAL,
    SVC_NORMAL,
    Draws,
    DrawSpec,
)
from isotope_tpu_torch.sim.feedback import RetryFeedback

F32 = torch.float32


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to isotope_tpu_torch yet "
        f"(ROADMAP.md queue 1: {item})"
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another one.  Without a GPU and without an explicit device this
    raises instead of quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "isotope_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class SimResults(NamedTuple):
    """Raw per-request / per-hop outcomes of one simulated block.

    Hop axis order is the compiled BFS order (level-concatenated).  All
    times are seconds; ``hop_start`` is when the request arrives at the
    service (before queueing), ``hop_latency`` the server-side duration
    (wait + script + cpu).
    """

    client_start: torch.Tensor    # (N,) client send time
    client_latency: torch.Tensor  # (N,) client-observed round trip
    client_error: torch.Tensor    # (N,) bool — entry returned a 500
    hop_sent: torch.Tensor        # (N, H) bool — hop actually executed
    hop_error: torch.Tensor       # (N, H) bool — hop returned 500 (where sent)
    hop_latency: torch.Tensor     # (N, H) f32
    hop_start: torch.Tensor       # (N, H) f32
    utilization: torch.Tensor     # (S,) rho per service at the offered load
    unstable: torch.Tensor        # (S,) bool — offered load >= capacity
    offered_qps: torch.Tensor     # scalar f32 — the rate the queues saw

    @property
    def client_end(self) -> torch.Tensor:
        return self.client_start + self.client_latency

    @property
    def hop_events(self) -> torch.Tensor:
        """Total executed hops — the benchmark's unit of work."""
        return self.hop_sent.sum()


@dataclasses.dataclass(frozen=True)
class _Level:
    """Device-resident constants for one depth level."""

    offset: int                     # start of this level's slice in hop order
    size: int
    pmax: int
    # dense step grid; None for a tiled or sparse level, whose (L, Pmax)
    # grid is exactly what those encodings avoid materializing
    step_mask: Optional[torch.Tensor]  # (L, Pmax) f32 — 1 where a real step
    step_base: Optional[torch.Tensor]  # (L, Pmax) f32
    child_seg: torch.Tensor         # (C,) i64 — parent_local * Pmax + step
    child_parent_local: torch.Tensor  # (C,) i64
    child_step: torch.Tensor        # (C,) i32 — step index within the parent
    child_rtt: torch.Tensor         # (C,) f32 — request + response wire time
    child_net_out: torch.Tensor     # (C,) f32 — one-way request wire time
    child_send_prob: torch.Tensor   # (C,) f32
    call_seg: torch.Tensor          # (K,) i64 — parent_local * Pmax + step
    call_hop: torch.Tensor          # (K,) i64 — parent_local
    call_step: torch.Tensor         # (K,) i32
    call_timeout: torch.Tensor      # (K,) f32, +inf when none
    att_child: Tuple[torch.Tensor, ...]  # per attempt: (K,) i64 in [0, C]
    att_valid: Tuple[torch.Tensor, ...]  # per attempt: (K,) bool
    # single-attempt levels where call k's only child is child k: the
    # attempt loop degenerates to elementwise ops
    ident_attempts: bool = False
    # any call with a finite timeout (else timeouts can't fire)
    finite_timeout: bool = False
    # c when call_seg == repeat(arange(size*pmax), c): the per-step
    # aggregation is a reshape-reduce instead of a scatter
    uniform_calls: Optional[int] = None
    # call-free levels: busy time is fully static — (L,) seconds
    leaf_busy: Optional[torch.Tensor] = None
    # sparse call-slot step encoding of a skewed wide level; None = dense
    sparse: Optional["_SparseSteps"] = None
    # dense-blocked tiling of a skewed wide level; exclusive with sparse
    tiled: Optional["_TiledSteps"] = None
    # (C,) i64 churn-weight column of each child (sentinel E: weight 1);
    # None without traffic splits
    child_churn_entry: Optional[torch.Tensor] = None

    @property
    def num_children(self) -> int:
        return len(self.child_seg)

    @property
    def num_calls(self) -> int:
        return len(self.call_seg)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, accurate in both tails in float32.

    ``torch.special.ndtr`` computes ``(1 + erf(x / sqrt 2)) / 2`` and
    loses all relative precision in the lower tail (it returns 0 at
    x = -6 in float32, which would turn a wait draw into a 46/rate
    outlier).  This is the reference's formulation: ``erfc`` of |x|
    away from the centre.
    """
    half_sqrt_2 = float(np.float32(0.5) * np.sqrt(np.float32(2.0)))
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(
        z < half_sqrt_2,
        1.0 + torch.erf(w),
        torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)),
    )
    return 0.5 * y


def _call_outcome(t, timeout, down_child):
    """(transport_failure, duration) of one call attempt.

    A finite ``timeout`` clamps the round trip ``t`` and fails the call
    past it; a down callee (``down_child``) transport-fails at zero cost
    (the connection is refused, nothing runs).  ``None`` inputs mean the
    failure mode is statically impossible, and a ``None`` transport
    result means no transport failure can occur at all.
    """
    transport = None
    dur = t
    if timeout is not None:
        transport = t > timeout
        dur = torch.minimum(t, timeout)
    if down_child is not None:
        transport = (
            down_child if transport is None else (down_child | transport)
        )
        dur = torch.where(down_child, 0.0, dur)
    return transport, dur


def _tree_product(compiled: CompiledGraph, own: np.ndarray) -> np.ndarray:
    """(..., H) products of ``own`` down the unrolled tree: the root's
    entry is 1 and each hop's is its parent's times its own (one multiply
    per hop, level by level in BFS order)."""
    out = np.ones_like(own)
    for lvl in compiled.levels:
        cids = lvl.child_ids
        if len(cids):
            out[..., cids] = (
                out[..., compiled.hop_parent[cids]] * own[..., cids]
            )
    return out


def _clock_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 prefix sums accumulated in float64, as torch's CPU
    ``cumsum`` accumulates float32: the request clocks (which place
    requests into phases and against kill instants) then agree between
    the card and the CPU, where a float32 scan on the card would drift
    from them by several ULP over a block."""
    return torch.cumsum(x, dim, dtype=torch.float64).to(torch.float32)


def _const(x, dtype, device) -> torch.Tensor:
    """A host array as a constant tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _slot_max(dur_call, n, rows, width, call_seg, uniform):
    """(n, rows, width) per-step census of concurrent calls: the max
    duration of the calls at each (parent, step) slot, 0 where none."""
    if uniform is not None:
        # call_seg == repeat(arange(rows * width), c): reshape-reduce
        return dur_call.reshape(n, rows, width, uniform).amax(-1)
    return torch.zeros(
        (n, rows * width), dtype=F32, device=dur_call.device
    ).scatter_reduce_(
        1, call_seg.expand(n, -1), dur_call, "amax", include_self=True,
    ).reshape(n, rows, width)


def _fail_min(final_transport, call_step, call_row, n, rows, width, P,
              uniform):
    """(n, rows) first transport-failed step of each row; sentinel ``P``
    where no call failed."""
    fail_contrib = torch.where(final_transport, call_step, P).to(torch.int32)
    if uniform is not None:
        return fail_contrib.reshape(n, rows, width * uniform).amin(-1)
    return torch.full(
        (n, rows), P, dtype=torch.int32, device=final_transport.device
    ).scatter_reduce_(
        1, call_row.expand(n, -1), fail_contrib, "amin", include_self=True,
    )


# -- non-dense step encodings of skewed wide levels ---------------------------


@dataclasses.dataclass(frozen=True)
class _SparseSteps:
    """Call-slot step encoding for skewed wide levels.

    One dynamic slot per CALL-BEARING step only: pure-sleep steps fold
    into static per-hop totals and prefixes, per-hop busy times are
    packed segment sums (cumsum minus segment starts — no (L x P)
    tensor ever materializes) and child start offsets gather static
    sleep prefixes plus the dynamic call prefix at their slot.

    A transport failure can only originate at a call-bearing step, so
    the first failing slot of a hop (a scatter-min over the slot axis)
    is its truncation point: slots past it are zeroed before the packed
    prefix sums, the executed pure-sleep part comes from a static
    per-slot sleep prefix, and children past the fail step take the
    parent's truncated busy time as their offset (the dense grid's flat
    prefix past the failure).
    """

    n_slots: int
    slot_base: torch.Tensor          # (S,) f32 sleep floor of each call step
    call_slot: Optional[torch.Tensor]  # (K,) i64 call -> slot; None: identity
    has_slots: torch.Tensor          # (L,) bool
    seg_first: torch.Tensor          # (L,) i64 first slot of the hop (safe 0)
    seg_last: torch.Tensor           # (L,) i64 last slot of the hop (safe 0)
    sleep_total: torch.Tensor        # (L,) f32 static pure-sleep busy seconds
    child_sleep_prefix: torch.Tensor  # (C,) f32 static sleep before the step
    child_slot: torch.Tensor         # (C,) i64 slot of the child's step
    child_seg_first: torch.Tensor    # (C,) i64 first slot of the parent
    slot_hop: torch.Tensor           # (S,) i64 local hop index of each slot
    slot_step: torch.Tensor          # (S,) i32 step index of each slot
    slot_sleep_prefix: torch.Tensor  # (S,) f32 static sleep before the slot


@dataclasses.dataclass(frozen=True)
class _Tile:
    """One dense sub-grid of a tiled level (see :class:`_TiledSteps`):
    the level's step rows restricted to the tile's hops and truncated to
    the tile width, so its census is the dense grid's on those rows."""

    hops: np.ndarray                 # (T,) level-local hop indices, sorted
    width: int                       # W — padded step width of the bin
    step_mask: torch.Tensor          # (T, W) f32
    step_base: torch.Tensor          # (T, W) f32
    num_calls: int
    call_sel: torch.Tensor           # (Kt,) i64 indices into level call order
    call_pos: torch.Tensor           # (Kt,) i64 parent position within tile
    call_step: torch.Tensor          # (Kt,) i32 step index within the parent
    call_seg: torch.Tensor           # (Kt,) i64 call_pos * W + call_step
    num_children: int
    child_flat: torch.Tensor         # (Ct,) i64 child_pos * W + child_step
    child_hop: torch.Tensor          # (Ct,) i64 level-local parent hop
    uniform_calls: Optional[int]     # c when call_seg == repeat(arange, c)


@dataclasses.dataclass(frozen=True)
class _TiledSteps:
    """Dense-blocked encoding of a skewed wide level.

    Hops are binned by script-width class into fixed-width tiles
    (``compiler/buckets.plan_tiles``) and each tile runs the dense census
    restricted to its rows; only scripts wider than the tile cap keep
    the sparse call-slot encoding as a ``residual``.  Per-part busy,
    fail and offset columns are put back into level order by the static
    ``hop_inv`` / ``child_inv`` gathers.
    """

    tiles: Tuple[_Tile, ...]
    residual: Optional[_SparseSteps]       # over the residual hops only
    res_size: int                          # R, residual hop count
    res_hops: Optional[torch.Tensor]       # (R,) i64 level-local indices
    res_call_sel: Optional[torch.Tensor]   # (Kr,) i64 level call indices
    res_num_children: int
    res_child_pos: Optional[torch.Tensor]  # (Cr,) i64 parent among residual
    res_child_step: Optional[torch.Tensor]  # (Cr,) i32
    hop_inv: torch.Tensor                  # (L,) i64 concat -> level order
    child_inv: torch.Tensor                # (C,) i64 concat -> level order


def _sparse_tables(
    num_hops: int,
    pmax: int,
    sleep_real: np.ndarray,      # (L, >=pmax) f64 — step_is_real * base
    step_base: np.ndarray,       # (L, >=pmax)
    call_seg_p: np.ndarray,      # (K,) parent_local * pmax + step
    parent_local: np.ndarray,    # (C,)
    child_step: np.ndarray,      # (C,)
    device,
) -> _SparseSteps:
    """The sparse call-slot tables of one (possibly restricted) hop set:
    the pure sparse encoding's, or a tiled level's residual part (inputs
    already renumbered to the restricted order)."""
    slot_segs = np.unique(call_seg_p)  # sorted
    n_slots = len(slot_segs)
    slot_hop = slot_segs // pmax
    slot_step = slot_segs % pmax
    call_slot_np = np.searchsorted(slot_segs, call_seg_p)
    # slots are sorted by hop: the first and last slot of each hop
    # (0 for a hop without slots)
    hops = np.arange(num_hops)
    lo = np.searchsorted(slot_hop, hops, "left")
    hi = np.searchsorted(slot_hop, hops, "right")
    has = hi > lo
    seg_first = np.where(has, lo, 0)
    seg_last = np.where(has, hi - 1, 0)
    has_call_step = np.zeros((num_hops, pmax), bool)
    has_call_step[slot_hop, slot_step] = True
    sleep_only = sleep_real[:, :pmax] * ~has_call_step
    sleep_prefix = np.cumsum(sleep_only, 1) - sleep_only
    child_slot_np = np.searchsorted(
        slot_segs, parent_local * pmax + child_step
    )

    def t(x, dtype):
        return _const(x, dtype, device)

    return _SparseSteps(
        n_slots=n_slots,
        slot_base=t(step_base[slot_hop, slot_step], F32),
        call_slot=(
            None
            if np.array_equal(call_slot_np, np.arange(len(call_seg_p)))
            else t(call_slot_np, torch.int64)
        ),
        has_slots=t(has, torch.bool),
        seg_first=t(seg_first, torch.int64),
        seg_last=t(seg_last, torch.int64),
        sleep_total=t(sleep_only.sum(1), F32),
        child_sleep_prefix=t(sleep_prefix[parent_local, child_step], F32),
        child_slot=t(child_slot_np, torch.int64),
        child_seg_first=t(seg_first[parent_local], torch.int64),
        slot_hop=t(slot_hop, torch.int64),
        slot_step=t(slot_step, torch.int32),
        slot_sleep_prefix=t(sleep_prefix[slot_hop, slot_step], F32),
    )


def _uniform_calls(call_seg: np.ndarray, slots: int) -> Optional[int]:
    """c when ``call_seg == repeat(arange(slots), c)``: every slot holds c
    calls in order, and the per-slot max is a reshape-reduce."""
    n_calls = len(call_seg)
    if n_calls == 0 or n_calls % slots:
        return None
    c = n_calls // slots
    if np.array_equal(call_seg, np.repeat(np.arange(slots), c)):
        return c
    return None


def _build_tiled_steps(
    plan,                        # buckets.TilePlan
    pmax: int,
    step_is_real: np.ndarray,    # (L, >=pmax) bool
    step_base: np.ndarray,       # (L, >=pmax)
    sleep_real: np.ndarray,      # (L, >=pmax) f64
    call_seg_p: np.ndarray,      # (K,)
    parent_local: np.ndarray,    # (C,)
    child_step: np.ndarray,      # (C,)
    device,
) -> _TiledSteps:
    """Lower one level's tile plan into device constants."""

    def t(x, dtype):
        return _const(x, dtype, device)

    call_parent = call_seg_p // pmax
    call_step_all = call_seg_p % pmax
    # one-pass hop -> part map: selecting each part's calls and children
    # is then a vectorized compare
    num_hops = len(step_is_real)
    part_of_hop = np.full(num_hops, -1, np.int64)
    for ti, (_, hop_idx) in enumerate(plan.tiles):
        part_of_hop[hop_idx] = ti
    if len(plan.residual):
        part_of_hop[plan.residual] = len(plan.tiles)
    part_of_call = part_of_hop[call_parent]
    part_of_child = part_of_hop[parent_local]
    tiles: List[_Tile] = []
    hop_parts: List[np.ndarray] = []
    child_parts: List[np.ndarray] = []
    for ti, (w, hop_idx) in enumerate(plan.tiles):
        w = int(w)
        call_sel = np.nonzero(part_of_call == ti)[0]
        call_pos = np.searchsorted(hop_idx, call_parent[call_sel])
        cstep = call_step_all[call_sel]
        call_seg_t = call_pos * w + cstep
        child_sel = np.nonzero(part_of_child == ti)[0]
        child_pos = np.searchsorted(hop_idx, parent_local[child_sel])
        tiles.append(_Tile(
            hops=hop_idx,
            width=w,
            step_mask=t(step_is_real[hop_idx, :w], F32),
            step_base=t(step_base[hop_idx, :w], F32),
            num_calls=len(call_sel),
            call_sel=t(call_sel, torch.int64),
            call_pos=t(call_pos, torch.int64),
            call_step=t(cstep, torch.int32),
            call_seg=t(call_seg_t, torch.int64),
            num_children=len(child_sel),
            child_flat=t(child_pos * w + child_step[child_sel], torch.int64),
            child_hop=t(hop_idx[child_pos], torch.int64),
            uniform_calls=_uniform_calls(call_seg_t, len(hop_idx) * w),
        ))
        hop_parts.append(hop_idx)
        child_parts.append(child_sel)
    residual = None
    res_hops = res_call_sel = res_child_pos = res_child_step = None
    res_num_children = 0
    if len(plan.residual):
        res = plan.residual
        res_part = len(plan.tiles)
        call_sel_r = np.nonzero(part_of_call == res_part)[0]
        call_pos_r = np.searchsorted(res, call_parent[call_sel_r])
        call_seg_r = call_pos_r * pmax + call_step_all[call_sel_r]
        child_sel_r = np.nonzero(part_of_child == res_part)[0]
        parent_r = np.searchsorted(res, parent_local[child_sel_r])
        child_step_r = child_step[child_sel_r]
        residual = _sparse_tables(
            len(res), pmax, sleep_real[res], step_base[res],
            call_seg_r, parent_r, child_step_r, device,
        )
        res_hops = t(res, torch.int64)
        res_call_sel = t(call_sel_r, torch.int64)
        res_num_children = len(child_sel_r)
        res_child_pos = t(parent_r, torch.int64)
        res_child_step = t(child_step_r, torch.int32)
        hop_parts.append(res)
        child_parts.append(child_sel_r)
    return _TiledSteps(
        tiles=tuple(tiles),
        residual=residual,
        res_size=len(plan.residual),
        res_hops=res_hops,
        res_call_sel=res_call_sel,
        res_num_children=res_num_children,
        res_child_pos=res_child_pos,
        res_child_step=res_child_step,
        hop_inv=t(np.argsort(np.concatenate(hop_parts)), torch.int64),
        child_inv=t(np.argsort(np.concatenate(child_parts)), torch.int64),
    )


def _sparse_level_sweep(
    sp: _SparseSteps,
    n: int,
    P: int,
    size: int,
    dur_call: torch.Tensor,                  # (n, K)
    final_transport: Optional[torch.Tensor],  # (n, K) bool
    err_par: Optional[torch.Tensor],          # (n, size) parent 500 coins
    child_parent_local: torch.Tensor,         # (C,) parent in [0, size)
    child_step: torch.Tensor,                 # (C,) i32
):
    """The sparse call-slot sweep over one hop set.

    Returns ``(busy, fail_step, off)``: per-hop busy seconds (not yet
    500-zeroed; the level applies the error mask), the per-hop fail step
    (sentinel ``P`` = no transport failure; ``None`` when none can
    occur), and per-child start offsets (fail- and error-adjusted,
    before any retry attempt offset).
    """
    dev = dur_call.device
    S = sp.n_slots
    if S == 0:
        # call-free hop set (pure-sleep scripts wider than the tile
        # cap): busy is static, nothing can fail, no children
        busy = sp.sleep_total.expand(n, size)
        off = torch.zeros((n, child_step.shape[0]), dtype=F32, device=dev)
        return busy, None, off
    if sp.call_slot is None:
        slot_agg = dur_call
        slot_fail = final_transport
    else:
        idx = sp.call_slot.expand(n, -1)
        slot_agg = torch.zeros((n, S), dtype=F32, device=dev).scatter_reduce_(
            1, idx, dur_call, "amax", include_self=True
        )
        slot_fail = (
            torch.zeros((n, S), dtype=torch.int32, device=dev)
            .scatter_reduce_(
                1, idx, final_transport.to(torch.int32), "amax",
                include_self=True,
            ) > 0
            if final_transport is not None
            else None
        )
    dyn = torch.maximum(sp.slot_base, slot_agg)
    fail_step = None
    if slot_fail is not None:
        slots = torch.arange(S, dtype=torch.int32, device=dev)
        fail_slot = torch.full(
            (n, size), S, dtype=torch.int32, device=dev
        ).scatter_reduce_(
            1, sp.slot_hop.expand(n, -1), torch.where(slot_fail, slots, S),
            "amin", include_self=True,
        )
        failed = fail_slot < S
        safe = torch.clamp(fail_slot, max=S - 1).to(torch.int64)
        fail_step = torch.where(failed, sp.slot_step[safe], P)
        # slots past the hop's fail step do not execute
        dyn = torch.where(
            sp.slot_step[None, :] <= fail_step[:, sp.slot_hop], dyn, 0.0
        )
        sleep_exec = torch.where(
            failed, sp.slot_sleep_prefix[safe], sp.sleep_total
        )
    else:
        sleep_exec = sp.sleep_total
    # packed segment sums: one cumsum over every slot of every hop
    pcs = torch.cumsum(dyn, 1)
    excl = pcs - dyn
    seg_sum = torch.where(
        sp.has_slots, pcs[:, sp.seg_last] - excl[:, sp.seg_first], 0.0
    )
    busy = sleep_exec + seg_sum
    off = (
        sp.child_sleep_prefix
        + excl[:, sp.child_slot]
        - excl[:, sp.child_seg_first]
    )
    if fail_step is not None:
        # children past the fail step are not sent; the dense grid's
        # prefix is flat there (== the truncated busy time)
        off = torch.where(
            child_step <= fail_step[:, child_parent_local],
            off, busy[:, child_parent_local],
        )
    if err_par is not None:
        # a 500ing parent runs no steps (dense zeroes the grid before
        # the prefix)
        off = off * ~err_par[:, child_parent_local]
    return busy, fail_step, off


class Simulator:
    """Holds a compiled graph's device tables and runs blocks on them."""

    def __init__(
        self,
        compiled: CompiledGraph,
        params: SimParams = SimParams(),
        chaos: Sequence[ChaosEvent] = (),
        churn: Sequence[TrafficSplit] = (),
        mtls: Optional[MtlsSchedule] = None,
        policies=None,
        rollouts=None,
        lb=None,
        *,
        device=None,
    ):
        if policies is not None or rollouts is not None:
            raise _unsupported(
                "policies and rollouts", "protected layers"
            )
        if params.attribution or params.timeline:
            raise _unsupported(
                "attribution and the timeline recorder", "observability"
            )
        if params.ensemble:
            raise _unsupported("scenario ensembles", "fleets")
        self.device = resolve_device(device)
        dev = self.device
        self.compiled = compiled
        self.params = params
        t = compiled.services
        net = params.network
        self._k_max = int(t.replicas.max())
        self._mu = 1.0 / params.cpu_time_s

        def tensor(x, dtype):
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        # -- auto-mTLS switching --------------------------------------------
        # a time-phased extra one-way latency on every edge, indexed by
        # the request's nominal arrival time: pure wire tax, so the
        # queueing tables are untouched (config.MtlsSchedule)
        self._mtls = mtls
        self._mtls_taxes = (
            tensor(mtls.taxes_s, F32) if mtls is not None else None
        )

        # -- traffic splits: per-hop schedule entries ------------------------
        name_to_idx = {n: i for i, n in enumerate(t.names)}
        self._churn = tuple(churn)
        hop_mult, mult_combo, own_combo = self._churn_tables(name_to_idx)
        self._visits = tensor(compiled.expected_visits(hop_mult), F32)

        # -- chaos phases: piecewise-constant effective replica counts -------
        for ev in chaos:
            if ev.service not in name_to_idx:
                raise ValueError(f"chaos for unknown service: {ev.service!r}")
        cuts = sorted(
            {0.0}
            | {ev.start_s for ev in chaos}
            | {ev.end_s for ev in chaos}
        )
        eff = np.tile(t.replicas.astype(np.int64), (len(cuts), 1))  # (P, S)
        for ev in chaos:
            s = name_to_idx[ev.service]
            for p, start in enumerate(cuts):
                if ev.start_s <= start < ev.end_s:
                    eff[p, s] -= (
                        int(t.replicas[s])
                        if ev.replicas_down is None
                        else ev.replicas_down
                    )
        eff = np.maximum(eff, 0)
        svc_down = eff == 0                                   # (P, S)
        # the phase starts in float32, as the JAX engine holds them (its
        # drain windows and -qps max warp read them back in float64)
        self._phase_starts = np.asarray(cuts, np.float32)     # (P,)
        self.has_chaos = bool(chaos)

        # -- post-storm drain windows -----------------------------------------
        # An overloaded phase leaves a backlog that the next phase drains
        # at its freed capacity before waits return to that phase's
        # stationary law: a (2, W) (bounds, row) window table, passed per
        # run, keeps the congested row live past its cut
        # (_windows_arg).  W is static: P real windows + up to P-1
        # drains.
        P_static = len(cuts)
        self._num_windows = 2 * P_static - 1 if P_static > 1 else 1
        ident_b = list(cuts) + [cuts[-1]] * (self._num_windows - P_static)
        ident_r = list(range(P_static)) + [P_static - 1] * (
            self._num_windows - P_static
        )
        self._ident_windows = tensor(
            np.stack([np.asarray(ident_b), np.asarray(ident_r, np.float64)])
            .astype(np.float32),
            F32,
        )
        self._window_cache: Dict[tuple, torch.Tensor] = {}

        # -- ungraceful kills (drain=False): resident-request resets ---------
        self._kill_tables(chaos, name_to_idx, cuts, eff)

        # -- per-(chaos x churn)-phase offered load --------------------------
        # A total outage changes where load flows, not just capacity: a
        # transport error truncates its caller's script, so services in
        # later steps (and the down subtree) see less traffic during the
        # window.
        mult_phase = self._phase_reach_multipliers(svc_down)  # (P, H)
        P = mult_phase.shape[0]
        Cc = self._num_combos
        visits_pc = np.empty((P * Cc, compiled.num_services), np.float64)
        mult_pc = np.empty((P * Cc, compiled.num_hops), np.float64)
        for p in range(P):
            for c in range(Cc):
                mult_pc[p * Cc + c] = mult_phase[p] * mult_combo[c]
                visits_pc[p * Cc + c] = compiled.expected_visits(
                    mult_pc[p * Cc + c]
                )
        self._visits_pc_np = visits_pc
        self._mult_pc = mult_pc
        self._visits_pc = tensor(visits_pc, F32)
        # (P*Cc, S) effective replicas (>= 1) and outage flags
        self._eff_pc_np = np.repeat(np.maximum(eff, 1), Cc, axis=0)
        self._down_pc_np = np.repeat(svc_down, Cc, axis=0)
        self._replicas_pc = tensor(self._eff_pc_np, torch.int32)
        self._svc_down_pc = tensor(self._down_pc_np, torch.bool)

        # -- load-balancing laws (sim/lb.py) ----------------------------------
        # ``lb`` (compiler.compile_lb's tables) swaps the wait law per
        # service; None or an all-fifo table with no panic leaves every
        # wait on the M/M/k law.  Panic routing needs something that can
        # unhealth a pool: here, chaos.  Its inputs are the alive
        # replicas per phase row (unclamped: a fully-killed pool is 0
        # healthy, not 1) and the static pool size.
        self._lb = lb
        self._lb_dev = None
        self._lb_profile_np = None
        if lb is not None and lb.active:
            self._lb_profile_np = lb_mod.effective_profile(lb, self._k_max)
            self._lb_dev = lb_mod.device_tables(lb, self._k_max, dev)
        self._lb_panic = (
            self._lb_dev is not None and lb.any_panic and self.has_chaos
        )
        if self._lb_panic:
            self._lb_alive_pc = tensor(np.repeat(eff, Cc, axis=0), F32)
            self._lb_total_row = tensor(t.replicas, F32)[None, :]

        # -- retry-storm feedback (load-dependent visits) -------------------
        # With finite call timeouts the retry/truncation probabilities
        # are load-dependent, so the visit table is a per-rate fixed
        # point (sim/feedback.py); without them the static table is exact.
        self._feedback = None
        if any(
            bool(np.isfinite(l.call_timeout).any()) for l in compiled.levels
        ):
            self._feedback = RetryFeedback(
                compiled, params, self._mu,
                self._eff_pc_np, self._down_pc_np, own_combo, visits_pc,
                mtls=mtls,
                # the fixed point sees the same per-station wait laws
                # (sim/lb.np_wait_stats), or a hot ring-hash arc's retry
                # storm goes statically unseen
                lb=(
                    (lb, self._lb_profile_np)
                    if self._lb_profile_np is not None
                    else None
                ),
            )
            if not self._feedback.active:  # pragma: no cover - guard match
                self._feedback = None

        hs = compiled.hop_service
        self._hop_service = torch.tensor(hs, dtype=torch.int64, device=dev)
        # (P*Cc, H) outage flag of each hop's callee per phase row
        self._down_ph = self._svc_down_pc[:, self._hop_service]
        self._hop_err_rate = torch.tensor(
            t.error_rate[hs], dtype=F32, device=dev
        )
        net_out, net_back = hop_wire_times(compiled, net)
        self._root_net = float(net_out[0] + net_back[0])
        self._entry_one_way = net.entry_one_way(0.0)

        # -- static RNG elimination -----------------------------------------
        # Coins that cannot land both ways are not drawn: no sub-1 send
        # probability and no traffic split -> no send coins, no
        # errorRate -> no error coins.
        self._need_send = bool(churn) or bool(
            (compiled.hop_send_prob[1:] < 1.0).any()
        )
        self._need_err = bool((t.error_rate[hs] > 0.0).any())

        levels: List[_Level] = []
        offset = 0
        for lvl in compiled.levels:
            cids = lvl.child_ids
            # per-level step width: the widest script among THIS level's
            # services, not the graph-wide max_steps stride
            pmax = max(int(lvl.step_is_real.sum(1).max(initial=0)), 1)
            parent_local = lvl.child_seg // compiled.max_steps
            child_step = lvl.child_seg % compiled.max_steps
            call_local = lvl.call_seg // compiled.max_steps
            call_step = lvl.call_seg % compiled.max_steps
            n_calls = len(lvl.call_seg)
            ident = (
                lvl.att_child.shape[0] == 1
                and n_calls == len(cids)
                and bool(lvl.att_valid.all())
                and np.array_equal(
                    lvl.att_child[0], np.arange(n_calls, dtype=np.int32)
                )
            )
            call_seg_p = call_local * pmax + call_step
            sleep_real = lvl.step_is_real.astype(np.float64) * (
                lvl.step_base
            )
            # a level whose dense (hops x Pmax) grid is pathological
            # leaves the dense path: the dense-blocked tiling by default,
            # the pure sparse call-slot encoding with tiling off (the
            # decision is compiler/buckets.level_encoding, shared with
            # the reference's vet linter)
            leaf_busy = None
            enc = "dense"
            sparse = tiled = None
            if n_calls == 0:
                leaf_busy = tensor(sleep_real.sum(1), F32)
            else:
                enc, tile_plan = buckets.level_encoding(
                    lvl.num_hops, pmax, len(np.unique(call_seg_p)),
                    lvl.step_is_real[:, :pmax].sum(1),
                    sparse_level_elems=params.sparse_level_elems,
                    tiling=params.sparse_tiling,
                    tile_pmax=params.sparse_tile_pmax,
                )
                if enc == "tiled":
                    tiled = _build_tiled_steps(
                        tile_plan, pmax, lvl.step_is_real,
                        lvl.step_base, sleep_real, call_seg_p,
                        parent_local, child_step, dev,
                    )
                elif enc == "sparse":
                    sparse = _sparse_tables(
                        lvl.num_hops, pmax, sleep_real, lvl.step_base,
                        call_seg_p, parent_local, child_step, dev,
                    )
            dense = enc == "dense"
            levels.append(
                _Level(
                    offset=offset,
                    size=lvl.num_hops,
                    pmax=pmax,
                    step_mask=(
                        tensor(lvl.step_is_real[:, :pmax], F32)
                        if dense else None
                    ),
                    step_base=(
                        tensor(lvl.step_base[:, :pmax], F32)
                        if dense else None
                    ),
                    child_seg=tensor(
                        parent_local * pmax + child_step, torch.int64
                    ),
                    child_parent_local=tensor(parent_local, torch.int64),
                    child_step=tensor(child_step, torch.int32),
                    child_rtt=tensor(
                        net_out[cids] + net_back[cids], F32
                    ),
                    child_net_out=tensor(net_out[cids], F32),
                    child_send_prob=tensor(
                        compiled.hop_send_prob[cids], F32
                    ),
                    call_seg=tensor(call_seg_p, torch.int64),
                    call_hop=tensor(call_local, torch.int64),
                    call_step=tensor(call_step, torch.int32),
                    call_timeout=tensor(lvl.call_timeout, F32),
                    att_child=tuple(
                        tensor(a, torch.int64) for a in lvl.att_child
                    ),
                    att_valid=tuple(
                        tensor(v, torch.bool) for v in lvl.att_valid
                    ),
                    ident_attempts=ident,
                    finite_timeout=bool(
                        np.isfinite(lvl.call_timeout).any()
                    ),
                    uniform_calls=(
                        _uniform_calls(call_seg_p, lvl.num_hops * pmax)
                        if dense else None
                    ),
                    leaf_busy=leaf_busy,
                    sparse=sparse,
                    tiled=tiled,
                    child_churn_entry=(
                        tensor(self._hop_churn_entry[cids], torch.int64)
                        if churn else None
                    ),
                )
            )
            offset += lvl.num_hops
        self._levels: Tuple[_Level, ...] = tuple(levels)

        # -- sibling copula: static hop -> group id map ---------------------
        # Concurrent sibling hops (children spawned by the same parent
        # step, retry attempts included) share correlated wait draws.
        # Group normals are drawn as (n, G) and expanded by a static
        # column gather; hops outside any group get their own slot.
        group = np.zeros(compiled.num_hops, np.int64)
        n_multi = 0
        off = 1  # hop 0 is the root; level d's children follow in order
        gid = {("root",): 0}
        gparent = [0]  # group -> parent group (the root group is its own)
        for d, lvl in enumerate(compiled.levels):
            segs = np.asarray(lvl.child_seg)
            counts: Dict[int, int] = {}
            for seg in segs:
                counts[int(seg)] = counts.get(int(seg), 0) + 1
            for local, seg in enumerate(segs):
                key = (d, int(seg))
                if key not in gid:
                    gid[key] = len(gid)
                    parent_hop = lvl.hop_ids[
                        int(seg) // compiled.max_steps
                    ]
                    gparent.append(int(group[parent_hop]))
                    if counts[int(seg)] > 1:
                        n_multi += 1
                group[off + local] = gid[key]
            off += lvl.num_children
        self._sib_group = torch.tensor(group, device=dev)
        self._num_sib_groups = len(gid)
        self._copula_active = n_multi > 0 and params.sibling_copula_r > 0.0

        # -- hierarchical copula mix (SimParams.hierarchical_copula_gamma) --
        # Same-depth sibling groups whose lowest common ancestor sits L
        # levels up correlate at gamma^L; groups at different depths stay
        # independent.  Every (ancestor group, depth offset) pair gets its
        # own unit normal; only multi-member groups join the hierarchy.
        self._copula_mix = None
        self._copula_rows = None
        self._copula_dim = len(gid)
        gamma = params.hierarchical_copula_gamma
        sizes = np.bincount(group, minlength=len(gid))
        active_groups = np.nonzero(sizes > 1)[0]
        if (
            self._copula_active
            and gamma > 0.0
            and len(gid) > 1
            and len(active_groups)
        ):
            G = len(gid)
            pair_idx: Dict[Tuple[int, int], int] = {}
            rows = []  # (row-in-A, factor, coeff)
            for i, g in enumerate(active_groups):
                w, a, lev = 1.0, int(g), 0
                while a != 0:
                    if lev == 0:
                        f = a  # own base factor
                    else:
                        key = (a, lev)
                        if key not in pair_idx:
                            pair_idx[key] = G + len(pair_idx)
                        f = pair_idx[key]
                    rows.append((i, f, np.sqrt(w * (1.0 - gamma))))
                    w *= gamma
                    a = gparent[a]
                    lev += 1
                key = (0, lev)
                if key not in pair_idx:
                    pair_idx[key] = G + len(pair_idx)
                rows.append((i, pair_idx[key], np.sqrt(w)))
            mix = np.zeros((len(active_groups), G + len(pair_idx)))
            for i, f, c in rows:
                mix[i, f] = c
            self._copula_mix = tensor(mix, F32)
            self._copula_rows = tensor(active_groups, torch.int64)
            self._copula_dim = G + len(pair_idx)

        # -- retry copula: static hop -> call-group map ---------------------
        # Serial retry attempts of ONE call share an extra normal on top
        # of the sibling term; hops outside any multi-attempt call carry
        # weight 0 and gather a sentinel column.
        rg = np.zeros(compiled.num_hops, np.int64)
        in_rg = np.zeros(compiled.num_hops, bool)
        n_rg = 0
        for lvl in compiled.levels:
            if not len(lvl.call_seg):
                continue
            att_counts = lvl.att_valid.sum(0)
            for k in np.nonzero(att_counts > 1)[0]:
                gids = lvl.child_ids[lvl.att_child[lvl.att_valid[:, k], k]]
                rg[gids] = n_rg
                in_rg[gids] = True
                n_rg += 1
        self._retry_group = torch.tensor(
            np.where(in_rg, rg, n_rg), device=dev
        )
        self._num_retry_groups = n_rg
        self._retry_active = n_rg > 0 and params.retry_copula_r > 0.0
        if self._retry_active and (
            params.sibling_copula_r + params.retry_copula_r >= 1.0
        ):
            raise ValueError(
                "sibling_copula_r + retry_copula_r must be < 1 when the "
                "topology has multi-attempt calls (both correlations "
                "apply to retry hops)"
            )
        retry_w = np.where(
            in_rg, np.sqrt(params.retry_copula_r), 0.0
        ).astype(np.float32)
        # per-hop weights of the copula terms, computed on the host in
        # the reference's float precision
        r = params.sibling_copula_r if self._copula_active else 0.0
        own_sq = 1.0 - r
        if self._retry_active:
            own_sq = own_sq - retry_w**2
        self._retry_w = tensor(retry_w, F32)
        self._sib_w = float(np.sqrt(r))
        self._own_w = (
            tensor(np.sqrt(own_sq), F32)
            if self._retry_active
            else float(np.sqrt(own_sq))
        )
        self._rate_cache: Dict[tuple, float] = {}

        # -- saturated closed loop (-qps max) -------------------------------
        # The finite-population tables (sim/closed.py) are built lazily
        # per connection count; squared coefficient of variation of the
        # service time, which scales the census-conditional wait
        self._closed_cache: Dict[int, tuple] = {}
        self._closed_in: Optional[tuple] = None
        if params.service_time == SERVICE_TIME_DETERMINISTIC:
            self._svc_scv = 0.0
        elif params.service_time == SERVICE_TIME_LOGNORMAL:
            self._svc_scv = float(np.expm1(params.service_time_param**2))
        elif params.service_time == SERVICE_TIME_PARETO:
            a = params.service_time_param
            self._svc_scv = 1.0 / (a * (a - 2.0)) if a > 2.01 else 25.0
        else:
            self._svc_scv = 1.0

    # -- scenario tables (host, numpy) --------------------------------------

    def _churn_tables(self, name_to_idx):
        """Traffic-split tables: the per-hop schedule entry, the
        time-averaged hop multiplier (``None`` without churn), and per
        churn combo (the product of the schedules' cycle positions) the
        (Cc, H) reach multipliers and own weights.

        Each churned call's send probability is multiplied by its
        schedule's current weight; descendants inherit through the sent
        propagation.  Offered load uses the time-averaged weight
        propagated down the unroll, and the queues of each combo see
        that combo's own load.
        """
        compiled = self.compiled
        churn = self._churn
        self._num_combos = 1
        self._hop_churn_entry = None
        if not churn:
            ones = np.ones((1, compiled.num_hops), np.float64)
            return None, ones, ones
        entry_of_svc = np.full(compiled.num_services, -1, np.int64)
        for e_i, ts in enumerate(churn):
            if ts.service not in name_to_idx:
                raise ValueError(
                    f"traffic split for unknown service: {ts.service!r}"
                )
            if entry_of_svc[name_to_idx[ts.service]] >= 0:
                raise ValueError(
                    f"multiple traffic splits target {ts.service!r}"
                )
            entry_of_svc[name_to_idx[ts.service]] = e_i
        entry_of_hop = entry_of_svc[compiled.hop_service]
        entry_of_hop[0] = -1  # the client's edge is never churned
        for ts in churn:
            if not (entry_of_hop == entry_of_svc[
                    name_to_idx[ts.service]]).any():
                # only the root targets it (or nothing does): the split
                # would be a silent no-op
                raise ValueError(
                    f"traffic split for {ts.service!r} matches no "
                    "callable edge (the client -> entrypoint edge "
                    "cannot be churned)"
                )
        # sentinel column E holds weight 1.0 for unchurned calls
        self._hop_churn_entry = np.where(
            entry_of_hop >= 0, entry_of_hop, len(churn)
        ).astype(np.int32)
        self._churn_periods = tuple(float(ts.period_s) for ts in churn)
        self._churn_weights = tuple(
            torch.tensor(ts.weights, dtype=F32, device=self.device)
            for ts in churn
        )
        means = np.asarray([ts.mean_weight for ts in churn])
        own = np.where(
            entry_of_hop >= 0, means[np.clip(entry_of_hop, 0, None)], 1.0
        )
        hop_mult = _tree_product(compiled, own)
        ks = [len(ts.weights) for ts in churn]
        n_combos = int(np.prod(ks))
        if n_combos > 256:
            raise ValueError(
                f"traffic-split cycle product is {n_combos} "
                "combinations (> 256); shorten or align the "
                "weight schedules"
            )
        w_combo = np.asarray([
            [churn[e].weights[combo[e]] for e in range(len(churn))]
            for combo in itertools.product(*map(range, ks))
        ])  # (Cc, E)
        own_c = np.where(
            entry_of_hop >= 0,
            w_combo[:, np.clip(entry_of_hop, 0, None)],
            1.0,
        )  # (Cc, H)
        self._num_combos = n_combos
        return hop_mult, _tree_product(compiled, own_c), own_c

    def _kill_tables(self, chaos, name_to_idx, cuts, eff) -> None:
        """Ungraceful kills (``drain=False``): the canonical kill tables
        and each hop's payload-free return path to the client.

        A graceful kill only removes capacity; an ungraceful one also
        resets the requests resident on the killed replicas at the kill
        instant.  Applied after the sweeps to requests whose hop on the
        killed service straddles the kill time: each dies with
        probability down / alive-before and the client sees a transport
        failure at about the kill instant (retries of the killed call
        and truncation downstream are not re-simulated).  One row per
        ``drain=False`` event in kill-time order, surviving events first
        and fully-down targets as inert zero rows at the end; row ``e``
        draws its coins from fold-in ``9_990_000 + e``.
        """
        compiled = self.compiled
        t = compiled.services
        params = self.params
        back_cum = None
        if any(not ev.drain for ev in chaos):
            # payload-free return legs, one per ancestor edge; a
            # cross-cluster edge pays the gateway extra on its return
            leg = np.full(
                compiled.num_hops, params.network.base_latency_s,
                np.float64,
            )
            if t.num_clusters > 1:
                cl = t.cluster
                hs_all = compiled.hop_service
                par = compiled.hop_parent
                leg[1:] += np.where(
                    cl[hs_all[par[1:]]] != cl[hs_all[1:]],
                    float(params.network.cross_cluster_latency_s),
                    0.0,
                )
            leg[0] += params.network.entry_extra_latency_s
            back_cum = leg.copy()
            hi = 1  # level-by-level prefix over the BFS order
            for lvl in compiled.levels:
                nxt = hi + lvl.num_children
                if lvl.num_children:
                    back_cum[hi:nxt] += back_cum[compiled.hop_parent[hi:nxt]]
                hi = nxt
        kill_t: list = []
        kill_frac: list = []
        for ev in sorted(chaos, key=lambda e: e.start_s):
            if ev.drain:
                continue
            s = name_to_idx[ev.service]
            down = (
                int(t.replicas[s])
                if ev.replicas_down is None
                else ev.replicas_down
            )
            # the residents are spread over the replicas alive just
            # before this kill (the prior phase's effective count)
            p = cuts.index(ev.start_s)
            k_before = int(eff[p - 1, s]) if p > 0 else int(t.replicas[s])
            if k_before <= 0:
                continue  # already fully down: nothing resident to kill
            kill_t.append(float(ev.start_s))
            kill_frac.append(np.where(
                compiled.hop_service == s, min(down / k_before, 1.0), 0.0
            ))
        self._num_kill_events = sum(1 for ev in chaos if not ev.drain)
        while len(kill_t) < self._num_kill_events:
            kill_t.append(0.0)
            kill_frac.append(np.zeros(compiled.num_hops))
        self._kill_t = self._kill_frac = self._back_cum = None
        if self._num_kill_events:
            dev = self.device
            self._kill_t = torch.tensor(
                np.asarray(kill_t, np.float32), device=dev
            )
            self._kill_frac = torch.tensor(
                np.stack(kill_frac).astype(np.float32), device=dev
            )
            self._back_cum = torch.tensor(
                back_cum.astype(np.float32), device=dev
            )

    def _phase_reach_multipliers(self, svc_down: np.ndarray) -> np.ndarray:
        """(P, H) static reach multipliers from outage-driven script
        truncation: a call to a down service transport-fails, its caller
        stops after that step (concurrent siblings still run), and the
        down subtree serves nothing.  Level by level over the BFS order:
        the reference's loop over hops, with the same products."""
        compiled = self.compiled
        H = compiled.num_hops
        P = svc_down.shape[0]
        out = np.ones((P, H))
        parent = compiled.hop_parent
        step = compiled.hop_step
        send_prob = compiled.hop_send_prob.astype(np.float64)
        first_attempt = compiled.hop_attempt == 0
        for p in range(P):
            down = svc_down[p]
            if not down.any():
                continue
            tgt_down = down[compiled.hop_service]
            m = out[p]
            if tgt_down[0]:
                # a down entrypoint refuses every connection
                m[:] = 0.0
                continue
            # P(a step does NOT transport-fail): product over its
            # down-target calls' send coins (one coin per call; retry
            # attempts share it)
            no_fail: Dict[tuple, float] = {}
            for h in np.nonzero(tgt_down & first_attempt)[0]:
                key = (int(parent[h]), int(step[h]))
                no_fail[key] = no_fail.get(key, 1.0) * (
                    1.0 - float(send_prob[h])
                )
            per_parent: Dict[int, list] = {}
            for (q, j), pr in no_fail.items():
                per_parent.setdefault(q, []).append((j, pr))
            # surv[h]: the product, in step order, of the no-fail
            # probabilities of the parent's steps before h's step
            surv = np.ones(H)
            if per_parent:
                affected = np.zeros(H, bool)
                affected[list(per_parent)] = True
                kids = np.nonzero(affected[parent])[0]
                kids = kids[kids > 0]
                tables = {}
                for q, items in per_parent.items():
                    items.sort()
                    prods = [1.0]
                    for _, pj in items:
                        prods.append(prods[-1] * pj)
                    tables[q] = ([j for j, _ in items], prods)
                for h in kids:
                    js, prods = tables[int(parent[h])]
                    surv[h] = prods[bisect.bisect_left(js, int(step[h]))]
            for lvl in compiled.levels:
                cids = lvl.child_ids
                if len(cids):
                    m[cids] = np.where(
                        tgt_down[cids], 0.0, m[parent[cids]] * surv[cids]
                    )
        return out

    # -- draws ------------------------------------------------------------

    def draw_spec(self, n: int, kind: str,
                  saturated: bool = False) -> DrawSpec:
        """The random tensors one block of ``n`` requests consumes;
        ``saturated``: under the finite-population law of ``-qps max``,
        which takes the flat sibling normals (no hierarchical mix)."""
        copula = self._copula_active or self._retry_active
        kind_svc = self.params.service_time
        if kind_svc == SERVICE_TIME_DETERMINISTIC:
            svc = None
        elif kind_svc == SERVICE_TIME_LOGNORMAL:
            svc = SVC_NORMAL
        else:  # exponential and pareto both start from unit exponentials
            svc = SVC_EXPONENTIAL
        return DrawSpec(
            n=n,
            hops=self.compiled.num_hops,
            need_send=self._need_send,
            need_err=self._need_err,
            copula=copula,
            sib_dim=(
                (
                    self._copula_dim
                    if self._copula_mix is not None and not saturated
                    else self._num_sib_groups
                )
                if self._copula_active
                else 0
            ),
            retry_dim=(
                self._num_retry_groups + 1 if self._retry_active else 0
            ),
            svc=svc,
            arrivals=kind == OPEN_LOOP,
            saturated=saturated,
            kill_events=self._num_kill_events,
            panic=self._lb_panic and not saturated,
        )

    def _draws(self, source, index, n: int, kind: str,
               saturated: bool = False) -> Draws:
        spec = self.draw_spec(n, kind, saturated)
        draws = source.draws(index, spec).to(self.device)
        draws.check(spec)
        return draws

    # -- public entry points ----------------------------------------------

    def _vis_arg(self, offered: float) -> torch.Tensor:
        """The (P*Cc, S) visit table the queues see at ``offered``: the
        static table, or the retry-feedback fixed point at that rate."""
        if self._feedback is None:
            return self._visits_pc
        return torch.tensor(
            self._feedback.visits_pc(float(offered)), dtype=F32,
            device=self.device,
        )

    def _windows_arg(self, offered: float, sat: bool) -> torch.Tensor:
        """The (2, W) packed (bounds, row) phase-window table at
        ``offered``: identity unless an overloaded phase leaves a
        backlog, in which case drain windows keep the congested row
        active past its cut for backlog / freed-capacity seconds.

        Saturated (-qps max) runs skip drains: the closed population
        bounds the backlog at C, so queues drain within one cycle.
        """
        P = len(self._phase_starts)
        if P == 1 or sat or not self.has_chaos:
            return self._ident_windows
        key = (float(f"{float(offered):.4g}"),)
        if key not in self._window_cache:
            cuts = self._phase_starts.astype(np.float64)
            S = self.compiled.num_services
            Cc = self._num_combos
            visits = (
                self._feedback.visits_pc(offered)
                if self._feedback is not None
                else self._visits_pc_np
            )
            lam = offered * visits.reshape(P, Cc, S).mean(1)  # (P, S)
            eff = self._eff_pc_np[::Cc].astype(np.float64)  # clamped >= 1
            down = self._down_pc_np[::Cc]
            cap = np.where(down, 0.0, eff * self._mu)
            lam = np.where(down, 0.0, lam)

            seq = [(float(cuts[0]), 0)]
            backlog = np.zeros(S)
            for p in range(P - 1):
                dur = float(cuts[p + 1] - cuts[p])
                backlog += np.maximum(lam[p] - cap[p], 0.0) * dur
                free = cap[p + 1] - lam[p + 1]
                drainable = (backlog > 1e-9) & (free > 1e-9)
                nxt_end = float(cuts[p + 2]) if p + 2 < P else np.inf
                if drainable.any():
                    drain_t = float(
                        (backlog[drainable] / free[drainable]).max()
                    )
                    drain_end = min(cuts[p + 1] + drain_t, nxt_end)
                    if drain_end > cuts[p + 1] + 1e-9:
                        # the congested row stays live while draining
                        seq.append((float(cuts[p + 1]), p))
                        if drain_end < nxt_end:
                            seq.append((float(drain_end), p + 1))
                        drained = (
                            np.maximum(free, 0.0)
                            * (drain_end - cuts[p + 1])
                        )
                        backlog = np.maximum(backlog - drained, 0.0)
                        continue
                seq.append((float(cuts[p + 1]), p + 1))
            while len(seq) < self._num_windows:
                seq.append(seq[-1])
            self._window_cache[key] = _const(
                np.asarray(
                    [[b for b, _ in seq], [r for _, r in seq]], np.float32
                ),
                F32, self.device,
            )
        return self._window_cache[key]

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=F32, device=self.device)

    def _saturated(self, load: LoadModel) -> bool:
        """True when the run samples the finite-population (MVA) wait
        law: Fortio's ``-qps max`` closed loop, with per-phase tables
        under chaos and churn.  A phased mTLS tax falls back to the
        open-loop law (the MVA delay station is static)."""
        return (
            load.kind == CLOSED_LOOP
            and load.qps is None
            and self._mtls is None
        )

    def _check_lb_load(self, load: LoadModel) -> None:
        """An active lb law cannot run under the saturated ``-qps max``
        law, whose finite-population tables have no per-backend
        dispatch: refuse it rather than fall back to fifo."""
        if self._lb_dev is not None and self._saturated(load):
            raise ValueError(
                "lb laws do not support saturated -qps max loads: the "
                "finite-population wait tables have no per-backend "
                "dispatch; use a paced closed loop or open loop"
            )

    def run(
        self,
        load: LoadModel,
        num_requests: int,
        source,
    ) -> SimResults:
        """Simulate ``num_requests`` under ``load`` with draws from
        ``source`` (its index ``None``).

        Open loop: the queues see exactly ``load.qps``.  Closed loop:
        the rate the queues see is latency-dependent, solved by
        :meth:`solve_closed_rate` before the run; ``-qps max``
        (``qps=None``) issues without pacing at the closed network's
        throughput and samples the finite-population wait law.
        """
        self._check_lb_load(load)
        if load.kind == OPEN_LOOP:
            res, _, _ = self._simulate_core(
                num_requests, OPEN_LOOP, 0,
                self._draws(source, None, num_requests, OPEN_LOOP),
                self._scalar(load.qps), self._scalar(0.0),
                self._scalar(load.qps), self._scalar(0.0),
                torch.zeros(1, dtype=F32, device=self.device),
                visits_pc=self._vis_arg(load.qps),
                phase_windows=self._windows_arg(load.qps, False),
            )
            return res
        lam = self.solve_closed_rate(load, num_requests, source)
        c = load.connections
        sat = self._saturated(load)
        res, _, _ = self._simulate_core(
            num_requests, CLOSED_LOOP, c,
            self._draws(source, None, num_requests, CLOSED_LOOP, sat),
            self._scalar(lam),
            self._scalar(0.0 if load.qps is None else c / load.qps),
            self._scalar(lam), self._scalar(0.0),
            torch.zeros(c, dtype=F32, device=self.device),
            visits_pc=self._vis_arg(lam),
            sat_conns=c if sat else 0,
            # chaos-phase placement always reflects the real rate: with
            # qps=None the workers still issue at the solved throughput
            nominal_gap=self._scalar(c / lam),
            phase_windows=self._windows_arg(lam, sat),
        )
        return res

    def solve_closed_rate(
        self,
        load: LoadModel,
        num_requests: int,
        source,
    ) -> float:
        """Equilibrium offered rate of Fortio's closed loop.

        ``-qps max``: the closed network's throughput, which the
        finite-population tables compute (:meth:`_closed_tables`; their
        fork-join refinement draws its pilots from
        ``source.with_seed(SAT_PILOT_SEED)``).  Paced:
        ``g(lam) = min(qps, C / E[latency(lam)]) - lam`` is strictly
        decreasing with one root, found by bisection over short pilot
        runs (pilot ``i`` draws from index ``i`` of ``source``).  The
        rate is memoized per load shape.
        """
        self._check_lb_load(load)
        if self._saturated(load):
            # phased runs time-weight the per-row rates over the chaos
            # windows the run spans
            thr = self._closed_tables(load.connections, source)[0]
            return self._sat_phased_rate(thr, num_requests)
        cache_key = (load.qps, load.connections, min(num_requests, 2048))
        if cache_key in self._rate_cache:
            return self._rate_cache[cache_key]
        cap = 0.999 * self.capacity_qps()
        hi = min(load.qps, cap) if load.qps is not None else cap
        pilot_n = min(num_requests, 2048)
        c = load.connections
        gap = self._scalar(0.0 if load.qps is None else c / load.qps)

        def implied(lam: float, i: int) -> float:
            res, _, _ = self._simulate_core(
                pilot_n, CLOSED_LOOP, c,
                self._draws(source, i, pilot_n, CLOSED_LOOP),
                self._scalar(lam), gap, self._scalar(lam),
                self._scalar(0.0),
                torch.zeros(c, dtype=F32, device=self.device),
                visits_pc=self._vis_arg(lam),
                nominal_gap=self._scalar(c / lam),
                phase_windows=self._windows_arg(lam, False),
            )
            mean_lat = float(res.client_latency.mean())
            out = c / max(mean_lat, 1e-9)
            return min(out, load.qps) if load.qps is not None else out

        if implied(hi, 0) >= hi:
            # pacing (or capacity) binds before self-throttling
            self._rate_cache[cache_key] = hi
            return hi
        lo = 0.0
        for i in range(1, 12):  # the reference's 4 x 3 fixed-point iterations
            mid = 0.5 * (lo + hi)
            if implied(mid, i) >= mid:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-3 * hi:
                break
        lam = 0.5 * (lo + hi)
        self._rate_cache[cache_key] = lam
        return lam

    def _sat_phased_rate(self, thr: np.ndarray, num_requests: int) -> float:
        """Average ``-qps max`` throughput over the chaos phases a run of
        ``num_requests`` spans: walk the phases accumulating requests at
        each phase's rate until the count is reached (churn combos cycle
        uniformly, so they average arithmetically within a phase)."""
        P = len(self._phase_starts)
        Cc = self._num_combos
        if P * Cc == 1:
            return float(thr[0])
        lam_p = np.asarray(thr, np.float64).reshape(P, Cc).mean(1)
        cuts = self._phase_starts.astype(np.float64)
        acc = 0.0
        for p in range(P):
            start = cuts[p]
            end = cuts[p + 1] if p + 1 < P else np.inf
            rate = max(float(lam_p[p]), 1e-9)
            seg = (end - start) * rate
            if p + 1 >= P or acc + seg >= num_requests:
                t_end = start + (num_requests - acc) / rate
                return num_requests / max(t_end, 1e-9)
            acc += seg
        return float(lam_p[-1])  # pragma: no cover - loop always returns

    # -- saturated closed loop: finite-population tables --------------------

    def _closed_inputs(self):
        """Closed-network model inputs (host, float64): fork-join cycle
        factors per hop, the factor-weighted reach, and each hop's delay
        weight (wire round trip plus own sleeps).

        Each member of an m-wide concurrent group overlaps its siblings,
        contributing ~H_m/m of its response to the request's cycle (H_m
        the harmonic number); factors multiply down the unroll.
        """
        if self._closed_in is None:
            compiled = self.compiled
            net_out, net_back = hop_wire_times(compiled, self.params.network)
            fj = np.ones(compiled.num_hops)
            for lvl in compiled.levels:
                if not len(lvl.child_ids):
                    continue
                seg_calls: Dict[int, int] = {}
                for seg in lvl.call_seg:
                    seg_calls[int(seg)] = seg_calls.get(int(seg), 0) + 1
                factor = {
                    seg: sum(1.0 / i for i in range(1, m + 1)) / m
                    for seg, m in seg_calls.items()
                }
                parent_global = lvl.hop_ids[
                    lvl.child_seg // compiled.max_steps
                ]
                fj[lvl.child_ids] = fj[parent_global] * np.asarray(
                    [factor[int(s)] for s in lvl.child_seg]
                )
            hop_sleep = np.zeros(compiled.num_hops)
            for lvl in compiled.levels:
                hop_sleep[lvl.hop_ids] = (
                    lvl.step_base * lvl.step_is_real
                ).sum(1)
            self._closed_in = (
                fj, compiled.hop_reach * fj, net_out + net_back + hop_sleep
            )
        return self._closed_in

    def _closed_tables(self, connections: int, source=None):
        """Saturated-closed-loop sampling tables at ``connections``,
        stacked per (chaos x churn) phase row: (throughput (R,) f64,
        p_zero (R, H), coef (R, D+1, H), e (R, H), center_c (R,) f32
        numpy, var_scale (R, H)), the tensors on the run's device; built
        on first use (an unphased fork-join run's pilots draw from
        ``source``) and cached per C.  Unphased runs have R == 1.

        ``center_c``/``var_scale`` realize the population copula:
        z' = scale * (z - c * e * (e . z)) has exact unit marginals and
        pairwise correlation rho (sim/closed.py) among the active hops.
        """
        if connections not in self._closed_cache:
            if source is None:
                raise ValueError(
                    "the saturated closed-loop tables are built by "
                    "solve_closed_rate (they need a draw source)"
                )
            R = len(self._phase_starts) * self._num_combos
            rows = [
                self._closed_row(connections, r, R == 1, source)
                for r in range(R)
            ]

            def t(i):
                return _const(np.stack([r[i] for r in rows]), F32,
                              self.device)

            self._closed_cache[connections] = (
                np.asarray([r[0] for r in rows]), t(1), t(2), t(3),
                np.asarray([r[4] for r in rows], np.float32), t(5),
            )
        return self._closed_cache[connections]

    def _closed_row(self, connections: int, row: int, refine: bool,
                    source):
        """One phase row's closed-network tables (numpy)."""
        compiled = self.compiled
        hs = compiled.hop_service
        H = compiled.num_hops
        visits = self._visits_pc_np[row]
        reps = np.maximum(self._eff_pc_np[row].astype(np.float64), 1.0)
        fj, reach_fj, delay_w = self._closed_inputs()
        reach_r = reach_fj * self._mult_pc[row]
        delay_r = float((reach_r * delay_w).sum())
        cycle_visits_r = np.bincount(
            hs, weights=reach_r, minlength=compiled.num_services
        )
        if visits.max(initial=0.0) <= 1e-12:
            # down entry: every connection spins on refused connects
            lam = connections / max(2.0 * self._entry_one_way, 1e-9)
            deg = closed.DEFAULT_QUANTILE_DEGREE
            return (lam, np.ones(H), np.zeros((deg + 1, H)),
                    np.zeros(H), 0.0, np.ones(H))
        if bool((fj < 1.0).any()):
            # fork-join: finite-source decomposition.  For unphased runs
            # the cycle is refined through the ENGINE's own composition
            # (max over siblings, copula) so Little's law closes:
            # E[sampled latency] = C / lambda.  Sample E at a spread of
            # cycles around the decomposition estimate, fit the
            # locally-linear map E(c) ~ a + b c by least squares, and
            # solve c* = a / (1 - b) (the map's contraction factor is
            # ~0.9, so a plain iteration would amplify pilot noise ~10x).
            # Phase rows keep the decomposition (the pilot measures one
            # stationary phase, which phased runs do not have).
            lam, pi, cycle = closed.fork_join_decomposition(
                visits, cycle_visits_r, reps, self._mu,
                delay_r, connections,
            )
            if refine:
                cycle, pi = self._refine_cycle(
                    connections, source, visits, reps, pi, cycle
                )
            p0, coef, _ = closed.tables_from_pi(
                pi, reps, self._mu, scv=self._svc_scv
            )
            throughput = connections / cycle
            # partial population centering for fork-join: the empirical
            # target 0.25 * sum(sigma^2) (var_d=None), fit against the
            # reference's DES oracle on tree13/star9
            sigma = closed.census_sigma(pi)
            var_d = None
        else:
            tabs = closed.closed_network_tables(
                visits, cycle_visits_r, reps, self._mu,
                delay_r, connections, scv=self._svc_scv,
            )
            p0, coef = tabs.p_zero, tabs.coef
            throughput = tabs.throughput
            sigma, var_d = tabs.sigma, tabs.var_delay
        e_h, c_center, scale_h = self._center_terms(sigma, var_d, hs)
        return (throughput, p0[hs], coef[:, hs], e_h, c_center, scale_h)

    def _refine_cycle(self, connections, source, visits, reps, pi, cycle):
        """Little-law closure of an unphased fork-join row: find the
        cycle c* with E(c*) = c*, where E(c) is the engine's own
        composed mean latency under tables built at cycle c.  Returns
        ``(cycle, pi)`` at the solved cycle."""
        hs = self.compiled.hop_service
        pilot = self._sat_pilot(connections, source)

        def t(x):
            return _const(x, F32, self.device)

        def census_at(c):
            # the repairman sweep is itself a per-station fixed
            # point in w; iterate it to convergence at cycle c
            pi_c = pi
            w_c = np.full(len(visits), 1.0 / self._mu)
            for _ in range(4):
                pi_c, w_c = closed.repairman_marginals(
                    visits, reps, self._mu, c, w_c, connections
                )
            return pi_c

        c0 = cycle
        cs, es = [], []
        for it, f in enumerate((0.85, 0.925, 1.0, 1.075, 1.15)):
            c = c0 * f
            pi_c = census_at(c)
            p0, coef, _ = closed.tables_from_pi(
                pi_c, reps, self._mu, scv=self._svc_scv
            )
            e_c, cc, sc = self._center_terms(
                closed.census_sigma(pi_c), None, hs
            )
            es.append(float(pilot(
                it, c / connections, t(p0[hs]), t(coef[:, hs]), t(e_c),
                t(cc), t(sc),
            )))
            cs.append(c)
        b, a = np.polyfit(np.asarray(cs), np.asarray(es), 1)
        if b < 0.98:  # sane slope: solve the linear map
            # clamped to the sampled neighbourhood: the model is local
            cycle = float(np.clip(a / (1.0 - b), 0.7 * c0, 1.6 * c0))
        else:  # degenerate fit: keep the decomposition value
            cycle = c0
        return cycle, census_at(cycle)

    @staticmethod
    def _center_terms(sigma, var_d, hs):
        """Population-copula centering terms from census sigmas.

        Linearize j_s ~ mean + sigma_s * z_s; the census constraint
        sum_s j_s + j_d = C-1 means the sigma-weighted z-combination
        must carry Var(j_delay), not the independent sum Sigma sigma^2
        — shrink its projection: z' = (z - c * e * (e . z)) / norm,
        c = 1 - sqrt(Vd / Ss^2).  ``var_d=None`` selects the fork-join
        empirical target 0.25 * Ss^2.
        """
        c_center = 0.0
        e_h = np.zeros(len(hs))
        scale_h = np.ones(len(hs))
        if sigma is not None:
            # a station's weight spreads over its hops (independent
            # draws): sigma/m per hop keeps multi-visit stations from
            # dominating the projection
            n_hops_s = np.bincount(hs, minlength=len(sigma))
            sig_h = sigma[hs] / np.maximum(n_hops_s[hs], 1)
            ss = float((sig_h**2).sum())
            if var_d is None:
                var_d = 0.25 * ss
            if ss > 1e-18 and var_d < ss:
                c_center = 1.0 - float(np.sqrt(max(var_d, 0.0) / ss))
                e_h = sig_h / np.sqrt(ss)
                shrink = (2 * c_center - c_center**2) * e_h**2
                scale_h = 1.0 / np.sqrt(1.0 - shrink)
        return e_h, c_center, scale_h

    def _sat_pilot(self, connections: int, source, n: int = 32_768):
        """Mean-latency probe of the fork-join fixed point: iteration
        ``it`` averages two pilot runs of ``n`` requests under the given
        quantile tables, drawn from index ``(it, i)`` of
        ``source.with_seed(SAT_PILOT_SEED)`` — a fixed stream, so the
        converged cycle does not depend on the run's seed (the fixed
        point amplifies probe noise: a ~0.3% shift of the mean moved
        the throughput by 5% in the reference's measurements)."""
        pilots = source.with_seed(SAT_PILOT_SEED)
        c = max(connections, 1)
        one, zero = self._scalar(1.0), self._scalar(0.0)

        def probe(it, nominal_gap, p0_h, coef_h, e_h, c_ctr, scale_h):
            means = []
            for i in range(2):
                res, _, _ = self._simulate_core(
                    n, CLOSED_LOOP, connections,
                    self._draws(pilots, (it, i), n, CLOSED_LOOP, True),
                    one, zero, one, zero,
                    torch.zeros(c, dtype=F32, device=self.device),
                    sat_conns=connections,
                    sat_override=(p0_h, coef_h, e_h, c_ctr, scale_h),
                    nominal_gap=self._scalar(nominal_gap),
                )
                means.append(res.client_latency.mean())
            return (means[0] + means[1]) / 2.0

        return probe

    def _block_plan(self, load: LoadModel, num_requests: int, source,
                    block_size: int = 65_536) -> Tuple[float, int, int]:
        """``(offered rate, block, number of blocks)`` of a blocked run:
        the closed loop's rate is solved (and cached) first, and its
        block is a whole number of requests per connection (it grows to
        the connection count when that exceeds ``block_size``)."""
        if load.kind == OPEN_LOOP:
            offered = float(load.qps)
            block = max(1, min(block_size, num_requests))
        else:
            offered = self.solve_closed_rate(load, num_requests, source)
            conns = load.connections
            block = max(1, min(block_size, num_requests) // conns) * conns
        return offered, block, max(1, -(-num_requests // block))

    def run_blocks(self, load: LoadModel, num_requests: int, source, *,
                   block_size: int = 65_536) -> Iterator[SimResults]:
        """The :class:`SimResults` of each block of a run of >=
        ``num_requests`` (:meth:`_block_plan`).

        A Python loop over blocks carries the open-loop clock ``t0``, the
        per-connection clocks ``conn_t0`` and the closed loop's request
        offset (its nominal clock, which places requests into chaos,
        churn and mTLS phases) from one block to the next, so the blocks
        form one continuous timeline; block ``b`` draws from index
        ``1_000_000 + b`` of ``source``.
        """
        self._check_lb_load(load)
        offered, block, num_blocks = self._block_plan(
            load, num_requests, source, block_size
        )
        sat = self._saturated(load)
        conns = 0 if load.kind == OPEN_LOOP else load.connections
        # -qps max: no pacing, the workers issue back to back; the
        # nominal clock follows the solved rate
        pace = conns / load.qps if conns and load.qps is not None else 0.0
        nominal = conns / offered
        visits_pc = self._vis_arg(offered)
        windows = self._windows_arg(offered, sat)
        offered_t = self._scalar(offered)
        pace_t = self._scalar(pace)
        nominal_t = self._scalar(nominal)
        t0 = self._scalar(0.0)
        conn_t0 = torch.zeros(max(conns, 1), dtype=F32, device=self.device)
        per = block // max(conns, 1)
        for b in range(num_blocks):
            res, t0, conn_t0 = self._simulate_core(
                block, load.kind, conns,
                self._draws(source, BLOCK_INDEX_BASE + b, block, load.kind,
                            sat),
                offered_t, pace_t, offered_t, t0, conn_t0,
                visits_pc=visits_pc,
                sat_conns=conns if sat else 0,
                nominal_gap=nominal_t,
                req_offset=b * per,
                phase_windows=windows,
            )
            yield res

    def run_summary(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        collector=None,
        trim: bool = False,
    ):
        """Simulate >= ``num_requests`` in memory-bounded blocks
        (:meth:`run_blocks`) and reduce them to one
        :class:`~isotope_tpu_torch.sim.summary.RunSummary`.
        ``collector`` (a ``metrics.prometheus.MetricsCollector``) adds
        each block's per-service Prometheus series to
        ``RunSummary.metrics``.  ``trim=True`` also accumulates the
        collector's steady-state window (skip 62s, cap 180s) into the
        ``win_*`` fields, placed from the run's expected duration.
        """
        from isotope_tpu_torch.metrics.fortio import trim_window_bounds
        from isotope_tpu_torch.sim import summary as summary_mod

        self._check_lb_load(load)
        offered, block, num_blocks = self._block_plan(
            load, num_requests, source, block_size
        )
        win = None
        if trim:
            lo, hi = trim_window_bounds(num_blocks * block, offered)
            win = (self._scalar(lo), self._scalar(hi))
        parts = [
            summary_mod.summarize(res, collector, window=win)
            for res in self.run_blocks(load, num_requests, source,
                                       block_size=block_size)
        ]
        return summary_mod.reduce_stacked(summary_mod.stack(parts))

    def default_block_size(self, budget_elems: int = 33_554_432) -> int:
        """A block size keeping each (block, H) event tensor near
        ``budget_elems`` elements (~128 MiB at f32)."""
        h = max(self.compiled.num_hops, 1)
        return int(max(256, min(524_288, budget_elems // h)))

    def census_shapes(self, n: int) -> List[Tuple[int, int, int, bool, bool]]:
        """``(N, B, P, fail, err)`` of each census call one block of ``n``
        requests makes, in call order: one per dense level with children,
        with a fail step where a call has a finite timeout or under
        chaos (any callee may be down) and error coins where a hop has a
        nonzero error rate or panic routing can fast-fail it, and one per
        tile of a tiled level that holds calls, ``(N, T, W)``, with the
        level's fail step and no error coins."""
        err = self._need_err or self._lb_panic
        shapes = []
        for lvl in reversed(self._levels):
            if lvl.num_children == 0 or lvl.sparse is not None:
                continue
            fail = lvl.finite_timeout or self.has_chaos
            if lvl.tiled is None:
                shapes.append((n, lvl.size, lvl.pmax, fail, err))
                continue
            shapes += [
                (n, len(tile.hops), tile.width, fail, False)
                for tile in lvl.tiled.tiles
                if tile.num_calls
            ]
        return shapes

    def capacity_qps(self) -> float:
        """Saturation throughput: the bottleneck station's capacity."""
        t = self.compiled.services
        visits = self._visits.cpu().numpy()
        with np.errstate(divide="ignore"):
            per_svc = np.where(
                visits > 0,
                t.replicas * self._mu / np.maximum(visits, 1e-30),
                np.inf,
            )
        return float(per_svc.min())

    def _sample_service_time(self, draw: Optional[torch.Tensor], n: int):
        """Per-hop CPU time with mean ``cpu_time_s`` from the unit draws.

        Heavy-tail options (lognormal sigma, Pareto alpha) are scaled so
        the mean stays the configured CPU demand.
        """
        mean = self.params.cpu_time_s
        kind = self.params.service_time
        p = self.params.service_time_param
        if kind == SERVICE_TIME_DETERMINISTIC:
            return torch.full(
                (n, self.compiled.num_hops), mean, dtype=F32,
                device=self.device,
            )
        if kind == SERVICE_TIME_LOGNORMAL:
            return torch.exp(p * draw - 0.5 * p * p) * mean
        if kind == SERVICE_TIME_PARETO:
            return torch.exp(draw / p) * (mean * (p - 1.0) / p)
        return draw * mean

    def _tiled_sweep(self, lvl: _Level, n: int, dur_call, final_transport,
                     err_lvl):
        """Dense tiles + sparse residual of one tiled level.

        Every tile runs the dense census restricted to its rows (through
        the census kernel on the card, with a fail step and no error
        flags: the 500 mask is applied to busy by the caller and to the
        offsets here); the residual keeps the sparse call-slot sweep.
        Returns ``(busy, fail_step, off)`` in level order, as
        :func:`_sparse_level_sweep` does.
        """
        tl = lvl.tiled
        P = lvl.pmax
        dev = self.device
        transportable = final_transport is not None
        busy_parts: List[torch.Tensor] = []
        fail_parts: List[torch.Tensor] = []
        off_parts: List[torch.Tensor] = []
        for tile in tl.tiles:
            T, W = len(tile.hops), tile.width
            fail_t = None
            if transportable:
                fail_t = (
                    _fail_min(
                        final_transport[:, tile.call_sel], tile.call_step,
                        tile.call_pos, n, T, W, P, tile.uniform_calls,
                    )
                    if tile.num_calls
                    # call-free rows cannot transport-fail
                    else torch.full((n, T), P, dtype=torch.int32,
                                    device=dev)
                )
            if tile.num_calls:
                agg = _slot_max(
                    dur_call[:, tile.call_sel], n, T, W, tile.call_seg,
                    tile.uniform_calls,
                )
                busy_t, excl = census(
                    tile.step_base, tile.step_mask, agg.contiguous(),
                    fail_t, None,
                )
            else:
                # the dense grid's census of a call-free row
                busy_t = (
                    torch.maximum(tile.step_base, torch.zeros((), device=dev))
                    * tile.step_mask
                ).sum(-1).expand(n, T)
            busy_parts.append(busy_t)
            if transportable:
                fail_parts.append(fail_t)
            if tile.num_children:
                off_t = excl.reshape(n, -1)[:, tile.child_flat]
                if err_lvl is not None:
                    # dense zeroes the grid of a 500ing parent before
                    # the prefix
                    off_t = off_t * ~err_lvl[:, tile.child_hop]
                off_parts.append(off_t)
        if tl.residual is not None:
            busy_r, fail_r, off_r = _sparse_level_sweep(
                tl.residual, n, P, tl.res_size,
                dur_call[:, tl.res_call_sel],
                final_transport[:, tl.res_call_sel] if transportable
                else None,
                err_lvl[:, tl.res_hops] if err_lvl is not None else None,
                tl.res_child_pos, tl.res_child_step,
            )
            busy_parts.append(busy_r)
            if transportable:
                # a call-free residual cannot fail
                fail_parts.append(
                    fail_r if fail_r is not None
                    else torch.full((n, tl.res_size), P, dtype=torch.int32,
                                    device=dev)
                )
            if tl.res_num_children:
                off_parts.append(off_r)
        busy = torch.cat(busy_parts, 1)[:, tl.hop_inv]
        fail_step = (
            torch.cat(fail_parts, 1)[:, tl.hop_inv] if transportable
            else None
        )
        off = torch.cat(off_parts, 1)[:, tl.child_inv]
        return busy, fail_step, off

    # -- the tensor program ------------------------------------------------

    def _saturated_wait(self, z, sat_conns: int, sat_override, phase_idx):
        """(N, H) waits under the finite-population law: the population
        copula ``z' = scale * (z - c * e * (e . z))`` centres the normals
        across hops (the in-flight census is fixed at C), then a per-hop
        quantile polynomial in ``v = -log1p(-u')`` (Horner, coefficients
        broadcast over the request axis) of the conditional uniform
        ``u'`` above the zero-wait mass ``p0``.  ``phase_idx`` (N,)
        selects each request's (chaos x churn) row of phased tables
        (``None``: one row)."""
        if sat_override is not None:
            p0_h, coef_h, e_o, c_o, scale_o = sat_override
            zproj = (z * e_o).sum(-1, keepdim=True)
            z = (z - c_o * e_o * zproj) * scale_o
            deg = coef_h.shape[0]

            def coef(ci):
                return coef_h[ci]
        elif phase_idx is None:
            _, p0_r, coef_r, e_r, c_r, scale_r = self._closed_tables(
                sat_conns
            )
            p0_h = p0_r[0]
            c_center = float(c_r[0])
            if c_center > 0.0:
                zproj = (z * e_r[0]).sum(-1, keepdim=True)
                z = (z - c_center * e_r[0] * zproj) * scale_r[0]
            coef_0 = coef_r[0]
            deg = coef_0.shape[0]

            def coef(ci):
                return coef_0[ci]
        else:
            # per-phase rows gathered by each request's arrival phase
            _, p0_r, coef_r, e_r, c_r, scale_r = self._closed_tables(
                sat_conns
            )
            p0_h = p0_r[phase_idx]
            e_n = e_r[phase_idx]
            c_n = _const(c_r, F32, self.device)[:, None][phase_idx]
            scale_n = scale_r[phase_idx]
            zproj = (z * e_n).sum(-1, keepdim=True)
            z = (z - c_n * e_n * zproj) * scale_n
            deg = coef_r.shape[1]

            def coef(ci):
                return coef_r[:, ci, :][phase_idx]
        u_sat = ndtr(z)
        u_c = torch.clamp(
            (u_sat - p0_h) / torch.clamp(1.0 - p0_h, min=1e-9),
            0.0, 1.0 - 1e-7,
        )
        v = -torch.log1p(-u_c)
        w = coef(deg - 1)
        for ci in range(deg - 2, -1, -1):
            w = w * v + coef(ci)
        return torch.where(u_sat < p0_h, 0.0, torch.clamp(w, min=0.0))

    def _nominal_arrivals(self, n, connections, sat_conns, nominal_gap,
                          req_offset):
        """(n,) nominal closed-loop arrival times, used only to place
        requests into chaos, churn and mTLS phases: request ``k`` of each
        connection's stream at ``(req_offset + k) * nominal_gap``, the
        remainder requests one step later.  Phased ``-qps max`` warps
        nominal time piecewise from each phase's throughput instead: the
        q-th request (globally) fires at R^-1(q), R(t) the cumulative
        requests under the per-phase rates."""
        dev = self.device
        c = max(connections, 1)
        per = n // c
        idx = req_offset + torch.arange(per, dtype=F32, device=dev)
        rem_idx = torch.full((n - c * per,), float(req_offset + per),
                             dtype=F32, device=dev)
        P_n = len(self._phase_starts)
        if sat_conns and P_n * self._num_combos > 1:
            thr = self._closed_tables(sat_conns)[0]
            lam_p = np.maximum(
                thr.reshape(P_n, self._num_combos).mean(1), 1e-9
            )
            cuts_np = self._phase_starts.astype(np.float64)
            r_breaks = np.concatenate(
                [[0.0], np.cumsum(lam_p[:-1] * np.diff(cuts_np))]
            )
            cuts_f = _const(cuts_np, F32, dev)
            lam_f = _const(lam_p, F32, dev)
            breaks_f = _const(r_breaks, F32, dev)

            def warp(i):
                q = i * float(sat_conns)
                k_ph = torch.clamp(
                    torch.searchsorted(breaks_f, q, right=True) - 1,
                    0, P_n - 1,
                )
                return cuts_f[k_ph] + (q - breaks_f[k_ph]) / lam_f[k_ph]

            nominal, rem_nominal = warp(idx), warp(rem_idx)
        else:
            nominal = idx * nominal_gap
            rem_nominal = rem_idx * nominal_gap
        return torch.cat([nominal.expand(c, per).reshape(-1), rem_nominal])

    def _simulate_core(
        self,
        n: int,
        kind: str,
        connections: int,
        draws: Draws,
        offered_qps: torch.Tensor,
        pace_gap: torch.Tensor,
        arrival_qps: torch.Tensor,
        t0: torch.Tensor,
        conn_t0: torch.Tensor,
        visits_pc: Optional[torch.Tensor] = None,
        sat_conns: int = 0,
        sat_override: Optional[Tuple[torch.Tensor, ...]] = None,
        nominal_gap: Optional[torch.Tensor] = None,
        req_offset: int = 0,
        phase_windows: Optional[torch.Tensor] = None,
    ) -> Tuple[SimResults, torch.Tensor, torch.Tensor]:
        """One block of ``n`` requests; returns ``(results, t_end,
        conn_end)`` for the next block's clocks.

        ``offered_qps`` drives the queueing model, ``arrival_qps`` paces
        the open-loop arrival stream; ``t0`` / ``conn_t0`` are the
        block's starting clocks.  ``sat_conns > 0`` switches the wait
        law to the finite-population closed network of ``sim/closed.py``
        with that connection count (``-qps max``); ``sat_override`` =
        ``(p0, coef, e, c, scale)`` replaces its cached tables and
        centering (the fork-join fixed point's pilots).

        ``nominal_gap`` (default ``pace_gap``) and ``req_offset`` (the
        requests each connection issued in earlier blocks) are the
        closed loop's nominal clock, which places requests into phases;
        ``phase_windows`` is the (2, W) table of :meth:`_windows_arg`
        (default: the identity windows).
        """
        dev = self.device
        zero = torch.zeros((), dtype=F32, device=dev)
        u_send, u_err = draws.u_send, draws.u_err
        H = self.compiled.num_hops
        if nominal_gap is None:
            nominal_gap = pace_gap

        # ---- wait draws: copulas in normal space, then U(0,1) marginals
        # (the saturated law keeps the normals, and takes the flat
        # sibling copula: its composition was calibrated without the
        # hierarchical mix)
        z_wait = u_wait = None
        if self._copula_active or self._retry_active:
            z_wait = zero
            if self._copula_active:
                z_small = draws.z_small
                if self._copula_mix is not None and not sat_conns:
                    z_act = torch.matmul(z_small, self._copula_mix.T)
                    z_groups = z_small[:, : self._num_sib_groups].clone()
                    z_groups[:, self._copula_rows] = z_act
                else:
                    z_groups = z_small[:, : self._num_sib_groups]
                z_wait = z_wait + self._sib_w * z_groups[:, self._sib_group]
            if self._retry_active:
                z_wait = z_wait + (
                    self._retry_w * draws.z_call[:, self._retry_group]
                )
            z_wait = z_wait + self._own_w * draws.z_h
            if not sat_conns:
                u_wait = ndtr(z_wait)
        elif sat_conns:
            z_wait = draws.z_h
        else:
            u_wait = draws.u_wait

        # ---- arrival times (open loop exact; closed loop nominal, used
        # only to place requests into phases) -----------------------------
        P = len(self._phase_starts)
        Cc = self._num_combos
        num_phases = P * Cc
        phased_clock = num_phases > 1 or self._mtls is not None
        nominal_arrivals = None
        if kind == OPEN_LOOP:
            gaps = draws.arr / arrival_qps
            arrivals = t0 + _clock_cumsum(gaps, 0)
            nominal_arrivals = arrivals
        else:
            arrivals = None  # closed-loop arrivals derive from latencies
            if phased_clock:
                nominal_arrivals = self._nominal_arrivals(
                    n, connections, sat_conns, nominal_gap, req_offset
                )

        # ---- phased mTLS tax at each request's arrival time --------------
        # (n,) extra one-way latency added to every edge leg
        tax = None
        if self._mtls is not None:
            t_idx = torch.floor(
                nominal_arrivals / self._mtls.period_s
            ).to(torch.int64) % len(self._mtls.taxes_s)
            tax = self._mtls_taxes[t_idx]

        # ---- traffic-split weights at each request's arrival time --------
        # (N, E+1): one column per schedule and a sentinel 1.0 column for
        # unchurned calls; ``combo_idx`` linearizes the schedules' cycle
        # positions for the phase tables
        combo_idx = None
        churn_w = None
        if self._churn:
            cols = []
            combo_idx = torch.zeros(n, dtype=torch.int64, device=dev)
            for period, wts in zip(self._churn_periods, self._churn_weights):
                idx = torch.floor(nominal_arrivals / period).to(
                    torch.int64
                ) % len(wts)
                cols.append(wts[idx])
                combo_idx = combo_idx * len(wts) + idx
            churn_w = torch.stack(
                cols + [torch.ones_like(nominal_arrivals)], dim=1
            )

        # ---- queueing parameters, per (chaos x churn) phase -------------
        if visits_pc is None:
            visits_pc = self._visits_pc
        lam_pc = offered_qps * visits_pc
        hop_svc = self._hop_service
        # panic routing (sim/lb.py): below a pool's panic threshold the
        # dead-backend share fast-fails through the panic coin below and
        # the wait law's load scales by the healthy fraction
        panic_ph = None
        if self._lb_panic and not sat_conns:
            lam_pc, panic_pc = lb_mod.panic_split(
                self._lb_dev, lam_pc, self._lb_alive_pc, self._lb_total_row
            )
            panic_ph = panic_pc[:, hop_svc]
        # per-station wait law: the lb laws where declared (fifo rows
        # pass through mmk_params untouched); the saturated -qps max
        # law keeps its own tables (lb runs refuse it at the entries)
        if self._lb_dev is not None and not sat_conns:
            qp = lb_mod.wait_params(
                self._lb, self._lb_dev, lam_pc, self._mu,
                self._replicas_pc, self._k_max,
            )
        else:
            qp = queueing.mmk_params(
                lam_pc, self._mu, self._replicas_pc, self._k_max
            )
        down = None
        phase_idx = None
        if num_phases > 1:
            # each request's row, gathered (exact, where the JAX engine
            # expands the tables with a one-hot matmul)
            if P > 1:
                # phase WINDOWS, not raw cuts: drain windows keep an
                # overloaded row live past its cut (_windows_arg)
                if phase_windows is None:
                    phase_windows = self._ident_windows
                win_idx = torch.searchsorted(
                    phase_windows[0].contiguous(), nominal_arrivals,
                    right=True,
                ) - 1
                chaos_idx = phase_windows[1].to(torch.int64)[
                    torch.clamp(win_idx, 0, self._num_windows - 1)
                ]
            else:
                chaos_idx = torch.zeros(n, dtype=torch.int64, device=dev)
            phase_idx = (
                chaos_idx * Cc + combo_idx
                if combo_idx is not None
                else chaos_idx
            )
            if self.has_chaos:
                down = self._down_ph[phase_idx]
        elif self.has_chaos:
            down = self._down_ph[0].expand(n, H)
        if sat_conns:
            wait = self._saturated_wait(
                z_wait, sat_conns, sat_override,
                phase_idx if sat_override is None else None,
            )
        else:
            if phase_idx is None:
                p_wait_nh = qp.p_wait[0][hop_svc][None, :]
                wait_rate_nh = qp.wait_rate[0][hop_svc][None, :]
            else:
                p_wait_nh = qp.p_wait[:, hop_svc][phase_idx]
                wait_rate_nh = qp.wait_rate[:, hop_svc][phase_idx]
            wait = queueing.sample_wait_conditional(
                p_wait_nh, wait_rate_nh, u_wait
            )  # (N, H)
        panic = None
        if panic_ph is not None:
            # the dead-backend share fast-fails at admission: no queue
            panic = draws.u_panic < (
                panic_ph[0][None, :] if phase_idx is None
                else panic_ph[phase_idx]
            )
            wait = torch.where(panic, zero, wait)
        utilization, unstable = qp.utilization, qp.unstable
        if self.has_chaos:
            # a fully-down service does no work: zero utilization for
            # those phases instead of the clamped-to-1-replica saturation
            utilization = torch.where(self._svc_down_pc, 0.0, utilization)
            unstable = unstable & ~self._svc_down_pc
        svc_time = self._sample_service_time(draws.svc, n)
        err_coin = None if u_err is None else u_err < self._hop_err_rate
        if panic is not None:
            # a panicking hop rides the errorRate path exactly: fast 500,
            # script skipped, nothing sent downstream, and the caller
            # does not fail
            err_coin = panic if err_coin is None else err_coin | panic

        # ---- upward pass: outcomes + server-side durations ---------------
        # Deepest level first, so every call site sees its callees'
        # (hypothetical) latency and status.  ``None`` sentinels carry
        # static knowledge: err_lvls[d] is None when no hop can 500,
        # fail_lvls[d] when no call can transport-fail (no finite
        # timeout and no chaos), used_lvls[d] when every call is
        # deterministically sent.
        L = len(self._levels)
        lat_lvls: List[Optional[torch.Tensor]] = [None] * L
        err_lvls: List[Optional[torch.Tensor]] = [None] * L
        fail_lvls: List[Optional[torch.Tensor]] = [None] * L
        used_lvls: List[Optional[torch.Tensor]] = [None] * L
        off_lvls: List[Optional[torch.Tensor]] = [None] * L
        for d in reversed(range(L)):
            lvl = self._levels[d]
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            err_lvl = (
                err_coin[:, sl].contiguous() if err_coin is not None else None
            )
            P = lvl.pmax
            fail_step = None
            if lvl.num_children > 0:
                nxt = self._levels[d + 1]
                csl = slice(nxt.offset, nxt.offset + nxt.size)
                C = lvl.num_children
                timeout = lvl.call_timeout if lvl.finite_timeout else None
                down_child = down[:, csl] if down is not None else None
                att_off = None
                if lvl.ident_attempts:
                    # single attempt, call k <-> child k: elementwise
                    tt = lvl.child_rtt + lat_lvls[d + 1]  # (N, C)
                    if tax is not None:
                        tt = tt + 2.0 * tax[:, None]
                    transport_a, dur_a = _call_outcome(
                        tt, timeout, down_child
                    )
                    if self._need_send:
                        prob = lvl.child_send_prob
                        if churn_w is not None:
                            prob = prob * churn_w[:, lvl.child_churn_entry]
                        coin = u_send[:, csl] < prob
                        used_lvls[d] = coin
                        dur_call = torch.where(coin, dur_a, zero)
                        # an unsent call cannot fail anything
                        final_transport = (
                            coin & transport_a
                            if transport_a is not None
                            else None
                        )
                    else:
                        dur_call = dur_a
                        final_transport = transport_a
                else:
                    # general path: serial retry attempts; dummy column C
                    # absorbs invalid attempt slots (the only duplicate
                    # indices of the attempt scatters, sliced off below)
                    lat_child = F.pad(lat_lvls[d + 1], (0, 1))
                    child_err = err_lvls[d + 1]
                    err_child = (
                        F.pad(child_err, (0, 1))
                        if child_err is not None
                        else None
                    )
                    down_pad = (
                        F.pad(down_child, (0, 1))
                        if down_child is not None
                        else None
                    )
                    rtt_child = F.pad(lvl.child_rtt, (0, 1))
                    a0 = lvl.att_child[0]
                    if self._need_send:
                        prob = lvl.child_send_prob[a0]
                        if churn_w is not None:
                            # the current schedule weight scales the send
                            # probability
                            prob = prob * churn_w[
                                :, lvl.child_churn_entry[a0]
                            ]
                        coin = u_send[:, csl][:, a0] < prob
                    else:
                        coin = torch.ones(
                            (n, lvl.num_calls), dtype=torch.bool, device=dev
                        )
                    dur_call = torch.zeros((n, lvl.num_calls), dtype=F32,
                                           device=dev)
                    final_transport = (
                        torch.zeros((n, lvl.num_calls), dtype=torch.bool,
                                    device=dev)
                        if lvl.finite_timeout or down_pad is not None
                        else None
                    )
                    used = torch.zeros((n, C + 1), dtype=torch.bool,
                                       device=dev)
                    att_off = torch.zeros((n, C + 1), dtype=F32, device=dev)
                    used_a = coin
                    for idx, valid in zip(lvl.att_child, lvl.att_valid):
                        use = used_a & valid
                        t = rtt_child[idx] + lat_child[:, idx]
                        if tax is not None:
                            t = t + 2.0 * tax[:, None]
                        transport_a, dur_a = _call_outcome(
                            t, timeout,
                            down_pad[:, idx] if down_pad is not None
                            else None,
                        )
                        failed_a = transport_a
                        if err_child is not None:
                            ec = err_child[:, idx]
                            failed_a = (
                                ec if failed_a is None else failed_a | ec
                            )
                        att_off[:, idx] = torch.where(use, dur_call, zero)
                        used[:, idx] = use
                        dur_call = dur_call + torch.where(use, dur_a, zero)
                        if final_transport is not None:
                            final_transport = torch.where(
                                use, transport_a, final_transport
                            )
                        used_a = (
                            use & failed_a
                            if failed_a is not None
                            else torch.zeros_like(use)
                        )
                    used_lvls[d] = used[:, :C]

                # -- aggregate calls into (parent, step) slots -------------
                if lvl.sparse is not None or lvl.tiled is not None:
                    # skewed wide level: tiles + sparse residual, or the
                    # pure sparse call-slot sweep; the 500 mask applies
                    # to busy after the sweep
                    if lvl.tiled is not None:
                        busy, fail_step, off = self._tiled_sweep(
                            lvl, n, dur_call, final_transport, err_lvl
                        )
                    else:
                        busy, fail_step, off = _sparse_level_sweep(
                            lvl.sparse, n, P, lvl.size, dur_call,
                            final_transport, err_lvl,
                            lvl.child_parent_local, lvl.child_step,
                        )
                    if err_lvl is not None:
                        busy = busy * ~err_lvl
                    if att_off is not None:
                        off = off + used_lvls[d] * att_off[:, :C]
                    off_lvls[d] = off
                else:
                    agg = _slot_max(
                        dur_call, n, lvl.size, P, lvl.call_seg,
                        lvl.uniform_calls,
                    )
                    if final_transport is not None:
                        fail_step = _fail_min(
                            final_transport, lvl.call_step, lvl.call_hop,
                            n, lvl.size, P, P, lvl.uniform_calls,
                        )
                    # fused census join (native/census.py): max + mask +
                    # fail/err truncation + row sum + exclusive prefix
                    busy, excl = census(
                        lvl.step_base, lvl.step_mask, agg.contiguous(),
                        fail_step, err_lvl,
                    )
                    off = excl.reshape(n, -1)[:, lvl.child_seg]
                    if att_off is not None:
                        off = off + used_lvls[d] * att_off[:, :C]
                    off_lvls[d] = off
            else:
                # call-free level: busy time is fully static; an
                # errorRate 500 skips the whole script
                busy = lvl.leaf_busy.expand(n, lvl.size)
                if err_lvl is not None:
                    busy = busy * ~err_lvl
            fail_lvls[d] = fail_step
            lat_lvls[d] = wait[:, sl] + svc_time[:, sl] + busy
            # this hop's own response status: 500 iff errorRate coin or a
            # transport-failed step
            if err_lvl is not None and fail_step is not None:
                err_lvls[d] = err_lvl | (fail_step < P)
            elif err_lvl is not None:
                err_lvls[d] = err_lvl
            elif fail_step is not None:
                err_lvls[d] = fail_step < P

        # ---- downward pass: which hops actually execute ------------------
        # a down ENTRY service refuses the client's connection itself
        root_down = None
        if down is not None:
            root_down = down[:, 0]
            sent_cur = ~root_down[:, None]
        else:
            sent_cur = torch.ones((n, 1), dtype=torch.bool, device=dev)
        sent_chunks: List[torch.Tensor] = []
        for d, lvl in enumerate(self._levels):
            sent_chunks.append(sent_cur)
            if d == L - 1:
                break
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            sent = sent_cur[:, lvl.child_parent_local]
            if err_coin is not None:
                sent = sent & ~err_coin[:, sl][:, lvl.child_parent_local]
            if fail_lvls[d] is not None:
                sent = sent & (
                    lvl.child_step
                    <= fail_lvls[d][:, lvl.child_parent_local]
                )
            if used_lvls[d] is not None:
                sent = sent & used_lvls[d]
            if down is not None:
                nxt = self._levels[d + 1]
                sent = sent & ~down[:, nxt.offset:nxt.offset + nxt.size]
            sent_cur = sent

        # ---- closed-loop arrivals (need latencies) -----------------------
        root_wire = self._root_net
        if tax is not None:
            # the client -> entry edge pays the tax on both legs too
            root_wire = root_wire + 2.0 * tax
        root_lat = root_wire + lat_lvls[0][:, 0]
        if root_down is not None:
            # a refused connection to the entry costs one wire round trip
            root_lat = torch.where(
                root_down, 2 * self._entry_one_way, root_lat
            )
        if kind == CLOSED_LOOP:
            c = max(connections, 1)
            per = n // c
            rem = n - c * per
            lat_conn = root_lat[: c * per].reshape(c, per)
            spent = torch.maximum(lat_conn, pace_gap)
            starts = conn_t0[:, None] + _clock_cumsum(spent, -1) - spent
            conn_end = conn_t0 + spent.sum(-1)
            if rem:
                # remainder requests (n % c) continue on the first ``rem``
                # connections — each starts when its connection frees up
                arrivals = torch.cat([starts.reshape(-1), conn_end[:rem]])
                spent_rem = torch.maximum(root_lat[c * per:], pace_gap)
                conn_end = torch.cat(
                    [conn_end[:rem] + spent_rem, conn_end[rem:]]
                )
            else:
                arrivals = starts.reshape(-1)
        else:
            conn_end = conn_t0

        # ---- downward pass 2: absolute start times -----------------------
        entry_wire = self._entry_one_way
        if tax is not None:
            entry_wire = entry_wire + tax
        start_cur = (arrivals + entry_wire)[:, None]
        start_chunks: List[torch.Tensor] = []
        for d, lvl in enumerate(self._levels):
            start_chunks.append(start_cur)
            if d == L - 1:
                break
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            base = (start_cur + wait[:, sl])[:, lvl.child_parent_local]
            out_wire = lvl.child_net_out
            if tax is not None:
                out_wire = out_wire + tax[:, None]
            start_cur = base + off_lvls[d] + out_wire

        # ---- assembly into BFS hop order ---------------------------------
        hop_sent = torch.cat(sent_chunks, dim=1)
        hop_lat = torch.cat(lat_lvls, dim=1)
        hop_start = torch.cat(start_chunks, dim=1)
        err_hop = torch.cat(
            [
                e if e is not None
                else torch.zeros((n, lvl.size), dtype=torch.bool, device=dev)
                for e, lvl in zip(err_lvls, self._levels)
            ],
            dim=1,
        )
        client_error = err_hop[:, 0]
        if root_down is not None:
            client_error = client_error | root_down
        if self._num_kill_events:
            root_lat, client_error = self._kill_resets(
                draws.u_kill, hop_sent, hop_start, hop_lat, arrivals,
                root_lat, client_error,
            )
        res = SimResults(
            client_start=arrivals,
            client_latency=root_lat,
            client_error=client_error,
            hop_sent=hop_sent,
            hop_error=err_hop & hop_sent,
            hop_latency=hop_lat,
            hop_start=hop_start,
            utilization=utilization.amax(0),
            unstable=unstable.any(0),
            offered_qps=offered_qps,
        )
        t_end = conn_end.max() if kind == CLOSED_LOOP else arrivals[-1]
        return res, t_end, conn_end

    def _kill_resets(self, u_kill, hop_sent, hop_start, hop_lat, arrivals,
                     root_lat, client_error):
        """Ungraceful kills: a request whose hop on the killed service
        is in flight at the kill instant dies (transport) with the
        event's probability; the client sees the reset at about the
        kill time, after the shortest payload-free return path among
        its killed hops.  The earliest event wins."""
        died_any = torch.zeros_like(client_error)
        for i in range(self._num_kill_events):
            t_k = self._kill_t[i]
            strad = (
                hop_sent & (hop_start < t_k) & (hop_start + hop_lat > t_k)
            )
            died_h = strad & (u_kill[i] < self._kill_frac[i][None, :])
            died = died_h.any(1) & ~died_any
            ret = torch.where(
                died_h, self._back_cum[None, :], float("inf")
            ).amin(1)
            reset_lat = torch.clamp(t_k - arrivals, min=0.0) + torch.where(
                torch.isfinite(ret), ret, 0.0
            )
            root_lat = torch.where(died, reset_lat, root_lat)
            client_error = client_error | died
            died_any = died_any | died
        return root_lat, client_error
