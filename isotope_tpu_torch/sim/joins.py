"""The census join of a depth level: how its calls become its hops'
busy time, fail step and children's offsets.

A level holds one of five joins, chosen once by :func:`level_join`:
dense, ragged, tiled, sparse or leaf.  Each has ``sweep(n, dur_call,
final_transport, err_lvl) -> (busy, fail_step, off)``, which the upward
sweep (``Simulator._simulate_core``) calls: ``busy`` zero where
``err_lvl`` is set, ``fail_step`` the sentinel Pmax where no call
failed (``None`` where none can), ``off`` before any retry attempt's
offset (``None`` for a leaf); and ``census_calls(n, fail, err)``, the
``(N, B, P, fail, err)`` of each census launch its sweep makes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar, List, Optional, Tuple, Union

import numpy as np
import torch

from isotope_tpu_torch.compiler import buckets
from isotope_tpu_torch.native.census import (
    RaggedPlan,
    census,
    census_ragged,
    ragged_engages,
    ragged_plan,
)

F32 = torch.float32

#: ``(N, B, P, fail, err)`` of one census launch
CensusCall = Tuple[int, int, int, bool, bool]


def _table(x, dtype, device) -> torch.Tensor:
    """A host array copied into a constant tensor on ``device``."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


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


def _masked(busy, err_lvl):
    """A 500ing hop skips its whole script."""
    return busy if err_lvl is None else busy * ~err_lvl


# -- the dense grid -----------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DenseJoin:
    """The dense (L, Pmax) step grid: the per-step call census, the
    first failed step and the census kernel's join (max with the sleep
    floor, step mask, fail/err truncation, row sum, exclusive prefix).
    Its tables are :class:`RaggedPlan`'s first seven, in its order."""

    kind: ClassVar[str] = "dense"
    step_base: torch.Tensor      # (L, P) f32
    step_mask: torch.Tensor      # (L, P) f32 — 1 where a real step
    call_seg: torch.Tensor       # (K,) i64 — hop * P + step
    call_hop: torch.Tensor       # (K,) i64
    call_step: torch.Tensor      # (K,) i32
    child_seg: torch.Tensor      # (C,) i64 — hop * P + step
    # c when call_seg == repeat(arange(L * P), c): the per-step
    # aggregation is a reshape-reduce instead of a scatter
    uniform: Optional[int]

    @property
    def size(self) -> int:
        return self.step_base.shape[0]

    @property
    def pmax(self) -> int:
        return self.step_base.shape[1]

    @property
    def step_elems(self) -> int:
        return self.size * self.pmax

    def sweep(self, n, dur_call, final_transport, err_lvl):
        L, P = self.size, self.pmax
        agg = _slot_max(dur_call, n, L, P, self.call_seg, self.uniform)
        fail_step = None
        if final_transport is not None:
            fail_step = _fail_min(final_transport, self.call_step,
                                  self.call_hop, n, L, P, P, self.uniform)
        busy, excl = census(self.step_base, self.step_mask, agg.contiguous(),
                            fail_step, err_lvl)
        return busy, fail_step, excl.reshape(n, -1)[:, self.child_seg]

    def census_calls(self, n, fail, err) -> List[CensusCall]:
        return [(n, self.size, self.pmax, fail, err)]


@dataclasses.dataclass(frozen=True, eq=False)
class RaggedJoin(DenseJoin):
    """A dense level whose grid is mostly padding
    (``native/census.ragged_engages``): one kernel from the calls to the
    children's offsets, walking the real steps alone (``plan``, which
    holds the same dense tables).  Its launch keeps the dense call's
    shape and count in ``census_calls``, and its ``step_elems`` are the
    dense grid's."""

    kind: ClassVar[str] = "ragged"
    plan: RaggedPlan

    def sweep(self, n, dur_call, final_transport, err_lvl):
        return census_ragged(
            self.plan, dur_call.contiguous(),
            final_transport.contiguous()
            if final_transport is not None else None,
            err_lvl,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class LeafJoin:
    """A call-free level: its busy time is fully static."""

    kind: ClassVar[str] = "leaf"
    busy: torch.Tensor           # (L,) f32 seconds

    @property
    def step_elems(self) -> int:
        return self.busy.shape[0]

    def sweep(self, n, dur_call, final_transport, err_lvl):
        return _masked(self.busy.expand(n, self.busy.shape[0]),
                       err_lvl), None, None

    def census_calls(self, n, fail, err) -> List[CensusCall]:
        return []


# -- skewed wide levels -------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SparseJoin:
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
    prefix past the failure).  A tiled level's residual is one, over
    its residual hops.
    """

    kind: ClassVar[str] = "sparse"
    pmax: int                        # the level's fail-step sentinel
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
    child_hop: torch.Tensor          # (C,) i64 parent of each child
    child_step: torch.Tensor         # (C,) i32 step index within the parent
    slot_hop: torch.Tensor           # (S,) i64 local hop index of each slot
    slot_step: torch.Tensor          # (S,) i32 step index of each slot
    slot_sleep_prefix: torch.Tensor  # (S,) f32 static sleep before the slot

    @property
    def size(self) -> int:
        return self.has_slots.shape[0]

    @property
    def step_elems(self) -> int:
        return self.n_slots

    def sweep(self, n, dur_call, final_transport, err_lvl):
        busy, fail_step, off = self.slot_sweep(
            n, dur_call, final_transport, err_lvl
        )
        return _masked(busy, err_lvl), fail_step, off

    def census_calls(self, n, fail, err) -> List[CensusCall]:
        return []

    def slot_sweep(self, n, dur_call, final_transport, err_par):
        """:meth:`sweep` before the 500 mask on busy (a tiled level masks
        its whole busy once); ``err_par`` (n, L) still zeroes the
        offsets of a 500ing parent's children."""
        dev = dur_call.device
        S, P, size = self.n_slots, self.pmax, self.size
        child_hop, child_step = self.child_hop, self.child_step
        if S == 0:
            # call-free hop set (pure-sleep scripts wider than the tile
            # cap): busy is static, nothing can fail, no children
            busy = self.sleep_total.expand(n, size)
            off = torch.zeros((n, child_step.shape[0]), dtype=F32,
                              device=dev)
            return busy, None, off
        if self.call_slot is None:
            slot_agg = dur_call
            slot_fail = final_transport
        else:
            idx = self.call_slot.expand(n, -1)
            slot_agg = torch.zeros(
                (n, S), dtype=F32, device=dev
            ).scatter_reduce_(1, idx, dur_call, "amax", include_self=True)
            slot_fail = (
                torch.zeros((n, S), dtype=torch.int32, device=dev)
                .scatter_reduce_(
                    1, idx, final_transport.to(torch.int32), "amax",
                    include_self=True,
                ) > 0
                if final_transport is not None
                else None
            )
        dyn = torch.maximum(self.slot_base, slot_agg)
        fail_step = None
        if slot_fail is not None:
            slots = torch.arange(S, dtype=torch.int32, device=dev)
            fail_slot = torch.full(
                (n, size), S, dtype=torch.int32, device=dev
            ).scatter_reduce_(
                1, self.slot_hop.expand(n, -1),
                torch.where(slot_fail, slots, S), "amin", include_self=True,
            )
            failed = fail_slot < S
            safe = torch.clamp(fail_slot, max=S - 1).to(torch.int64)
            fail_step = torch.where(failed, self.slot_step[safe], P)
            # slots past the hop's fail step do not execute
            dyn = torch.where(
                self.slot_step[None, :] <= fail_step[:, self.slot_hop],
                dyn, 0.0,
            )
            sleep_exec = torch.where(
                failed, self.slot_sleep_prefix[safe], self.sleep_total
            )
        else:
            sleep_exec = self.sleep_total
        # packed segment sums: one cumsum over every slot of every hop
        pcs = torch.cumsum(dyn, 1)
        excl = pcs - dyn
        seg_sum = torch.where(
            self.has_slots, pcs[:, self.seg_last] - excl[:, self.seg_first],
            0.0,
        )
        busy = sleep_exec + seg_sum
        off = (
            self.child_sleep_prefix
            + excl[:, self.child_slot]
            - excl[:, self.child_seg_first]
        )
        if fail_step is not None:
            # children past the fail step are not sent; the dense grid's
            # prefix is flat there (== the truncated busy time)
            off = torch.where(
                child_step <= fail_step[:, child_hop], off,
                busy[:, child_hop],
            )
        if err_par is not None:
            # a 500ing parent runs no steps (dense zeroes the grid before
            # the prefix)
            off = off * ~err_par[:, child_hop]
        return busy, fail_step, off


@dataclasses.dataclass(frozen=True)
class _Tile:
    """One dense sub-grid of a tiled level (see :class:`TiledJoin`):
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


@dataclasses.dataclass(frozen=True, eq=False)
class TiledJoin:
    """Dense-blocked encoding of a skewed wide level.

    Hops are binned by script-width class into fixed-width tiles
    (``compiler/buckets.plan_tiles``) and each tile runs the dense census
    restricted to its rows; only scripts wider than the tile cap keep
    the sparse call-slot encoding as a ``residual``.  Per-part busy,
    fail and offset columns are put back into level order by the static
    ``hop_inv`` / ``child_inv`` gathers.
    """

    kind: ClassVar[str] = "tiled"
    pmax: int                              # the level's fail-step sentinel
    tiles: Tuple[_Tile, ...]
    residual: Optional[SparseJoin]         # over the residual hops only
    res_hops: Optional[torch.Tensor]       # (R,) i64 level-local indices
    res_call_sel: Optional[torch.Tensor]   # (Kr,) i64 level call indices
    hop_inv: torch.Tensor                  # (L,) i64 concat -> level order
    child_inv: torch.Tensor                # (C,) i64 concat -> level order

    @property
    def res_size(self) -> int:
        return 0 if self.residual is None else self.residual.size

    @property
    def step_elems(self) -> int:
        return sum(len(t.hops) * t.width for t in self.tiles) + (
            self.residual.n_slots if self.residual is not None else 0
        )

    def census_calls(self, n, fail, err) -> List[CensusCall]:
        # the tiles take the level's fail step and no error flags
        return [(n, len(t.hops), t.width, fail, False) for t in self.tiles
                if t.num_calls]

    def sweep(self, n, dur_call, final_transport, err_lvl):
        """Every tile runs the dense census restricted to its rows
        (through the census kernel on the card, with a fail step and no
        error flags: the 500 mask is applied to busy at the end and to
        the offsets here); the residual keeps the call-slot sweep."""
        P = self.pmax
        dev = dur_call.device
        transportable = final_transport is not None
        busy_parts: List[torch.Tensor] = []
        fail_parts: List[torch.Tensor] = []
        off_parts: List[torch.Tensor] = []
        for tile in self.tiles:
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
                fail_parts.append(fail_t)
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
            if tile.num_children:
                off_t = excl.reshape(n, -1)[:, tile.child_flat]
                if err_lvl is not None:
                    # dense zeroes the grid of a 500ing parent before
                    # the prefix
                    off_t = off_t * ~err_lvl[:, tile.child_hop]
                off_parts.append(off_t)
        res = self.residual
        if res is not None:
            busy_r, fail_r, off_r = res.slot_sweep(
                n, dur_call[:, self.res_call_sel],
                final_transport[:, self.res_call_sel] if transportable
                else None,
                err_lvl[:, self.res_hops] if err_lvl is not None else None,
            )
            busy_parts.append(busy_r)
            if transportable:
                # a call-free residual cannot fail
                fail_parts.append(
                    fail_r if fail_r is not None
                    else torch.full((n, res.size), P, dtype=torch.int32,
                                    device=dev)
                )
            if res.child_step.shape[0]:
                off_parts.append(off_r)
        busy = torch.cat(busy_parts, 1)[:, self.hop_inv]
        fail_step = (
            torch.cat(fail_parts, 1)[:, self.hop_inv] if transportable
            else None
        )
        off = torch.cat(off_parts, 1)[:, self.child_inv]
        return _masked(busy, err_lvl), fail_step, off


Join = Union[DenseJoin, RaggedJoin, TiledJoin, SparseJoin, LeafJoin]


# -- building a level's join --------------------------------------------------


def _sparse_join(num_hops, pmax, sleep_real, step_base, call_seg_p,
                 parent_local, child_step, device) -> SparseJoin:
    """The sparse call-slot tables of one (possibly restricted) hop set:
    the pure sparse encoding's, or a tiled level's residual part (inputs
    already renumbered to the restricted order; the arguments as
    :func:`level_join`'s, ``sleep_real`` the (L, >=pmax) f64 sleep of
    the real steps)."""
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
    t = functools.partial(_table, device=device)
    return SparseJoin(
        pmax=pmax,
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
        child_hop=t(parent_local, torch.int64),
        child_step=t(child_step, torch.int32),
        slot_hop=t(slot_hop, torch.int64),
        slot_step=t(slot_step, torch.int32),
        slot_sleep_prefix=t(sleep_prefix[slot_hop, slot_step], F32),
    )


def _tiled_join(plan, pmax, step_is_real, step_base, sleep_real,
                call_seg_p, parent_local, child_step, device) -> TiledJoin:
    """Lower one level's tile plan (``buckets.TilePlan``) into device
    constants."""
    t = functools.partial(_table, device=device)
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
    residual = res_hops = res_call_sel = None
    if len(plan.residual):
        res = plan.residual
        res_part = len(plan.tiles)
        call_sel_r = np.nonzero(part_of_call == res_part)[0]
        call_pos_r = np.searchsorted(res, call_parent[call_sel_r])
        call_seg_r = call_pos_r * pmax + call_step_all[call_sel_r]
        child_sel_r = np.nonzero(part_of_child == res_part)[0]
        residual = _sparse_join(
            len(res), pmax, sleep_real[res], step_base[res], call_seg_r,
            np.searchsorted(res, parent_local[child_sel_r]),
            child_step[child_sel_r], device,
        )
        res_hops = t(res, torch.int64)
        res_call_sel = t(call_sel_r, torch.int64)
        hop_parts.append(res)
        child_parts.append(child_sel_r)
    return TiledJoin(
        pmax=pmax,
        tiles=tuple(tiles),
        residual=residual,
        res_hops=res_hops,
        res_call_sel=res_call_sel,
        hop_inv=t(np.argsort(np.concatenate(hop_parts)), torch.int64),
        child_inv=t(np.argsort(np.concatenate(child_parts)), torch.int64),
    )


def level_join(step_is_real, step_base, pmax, call_seg, parent_local,
               child_step, params, device) -> Join:
    """The one decision of a level's join, and its device constants.

    ``step_is_real`` and ``step_base`` are the compiled level's (L,
    >=pmax) step grid, ``pmax`` its widest script, ``call_seg`` (K,)
    each call's ``parent * pmax + step``, ``parent_local`` and
    ``child_step`` (C,) each child's parent and step, ``params`` the
    SimParams (the sparse and tile settings).  A call-free level is a
    leaf.  Otherwise ``compiler/buckets.level_encoding`` (shared with
    the vet linter) decides dense, tiled or sparse; a dense grid then
    takes the ragged census where ``native/census.ragged_engages``
    holds (a grid mostly padding, every padded floor finite)."""
    size = len(step_is_real)
    sleep_real = step_is_real.astype(np.float64) * step_base
    if not len(call_seg):
        return LeafJoin(_table(sleep_real.sum(1), F32, device))
    kind, tile_plan = buckets.level_encoding(
        size, pmax, len(np.unique(call_seg)),
        step_is_real[:, :pmax].sum(1),
        sparse_level_elems=params.sparse_level_elems,
        tiling=params.sparse_tiling,
        tile_pmax=params.sparse_tile_pmax,
    )
    if kind == "tiled":
        return _tiled_join(tile_plan, pmax, step_is_real, step_base,
                           sleep_real, call_seg, parent_local, child_step,
                           device)
    if kind == "sparse":
        return _sparse_join(size, pmax, sleep_real, step_base, call_seg,
                            parent_local, child_step, device)
    mask, base = step_is_real[:, :pmax], step_base[:, :pmax]
    tables = (
        _table(base, F32, device),
        _table(mask, F32, device),
        _table(call_seg, torch.int64, device),
        _table(call_seg // pmax, torch.int64, device),
        _table(call_seg % pmax, torch.int32, device),
        _table(parent_local * pmax + child_step, torch.int64, device),
        _uniform_calls(call_seg, size * pmax),
    )
    if ragged_engages(base, mask):
        return RaggedJoin(*tables, plan=ragged_plan(*tables))
    return DenseJoin(*tables)
