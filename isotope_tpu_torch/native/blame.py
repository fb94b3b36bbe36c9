"""The blame sweep of attributed runs: a CUDA kernel and its plain twin.

``metrics/attribution.py`` ``attribute_block`` reduces a block's
``(N, H)`` hop tensors to each hop's critical-path blame (crit counts,
wait / self / net / timeout seconds, their tail-weighted twins, error
counts), each request's residual, and the per-service blame histograms.

- On a CUDA tensor :func:`blame_sweep` launches the hand-written kernel
  of ``csrc/blame.cu``, built with ``nvcc`` for ``sm_90a`` into
  ``_build/`` at first use and loaded with ctypes (``native/nvcc.py``).
  It reads the block's hop tensors once and adds its sums in place into
  the run's accumulator: the two flat buffers (float32, int64) whose
  views are an ``AttributionSummary`` (``attribution.accumulator``,
  which also holds their layout).
- On the CPU ``attribute_block`` runs the op chain
  (``attribution._sweep``) and ``accumulate``.
- ``attribution.blame_sweep_sequential`` is the chain with the kernel's
  order of summation (:func:`kernel_sums`), in plain torch; the kernel
  equals it bit for bit.
- :func:`launch_plan` chooses the kernel's geometry from the shapes and
  tables alone, in plain Python, so that the CPU tests can check it.

The kernel's order: a warp takes a tile of ``TILE`` rows, a lane a row.
Each request's charges are summed level by level (each level's children
in the tables' order, then their timeouts, then the level's hops) as the
chain does a level at a time.  A tile's column sums are a pairwise tree
over its rows; the tiles of a group of ``FOLD_GROUP`` are summed in
order, then the groups in order, and the total is added to the
accumulator once.

There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``blame_sweep.launches`` counts the sweeps (one a
block: the sweep kernel and its reduction pass).
"""
from __future__ import annotations

import ctypes
import pathlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from isotope_tpu_torch.native.nvcc import NvccLibrary

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "blame.cu"

#: rows a tile: a warp's, a lane a row
TILE = 32
#: tiles the reduction pass sums into a group, and the columns a block
#: of it takes (``kRedCols``)
FOLD_GROUP = 64
REDUCE_COLUMNS = 4
#: the most warps a block
MAX_WARPS = 8
#: shared memory a block may use, and an SM has (H100: 227 / 228 KB)
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
#: the most device memory the crit bits may take where a level is too
#: wide for shared memory
BITS_DEVICE_MAX = 1 << 27
#: the H100's SMs, for plans made without a card
H100_SMS = 132
#: blame buckets a service (``attribution.NUM_BLAME_BUCKETS``)
BUCKETS = 64
#: hops a window holds of the tile's rows; the bytes of a warp's six
#: windows and of its two column streams' buffers (``kWin``,
#: ``kWindowBytes``, ``kColBytes`` in ``csrc/blame.cu``)
WINDOW = 8
WINDOW_BYTES = (3 * WINDOW * (TILE + 1) * 4
                + -(-3 * WINDOW * (TILE + 1) // 4) * 4)
COLUMN_BYTES = 2 * 32 * 33 * 4

#: the fields of the kernel's columns, in ``csrc/blame.cu``'s order
#: (``enum Field``): float32 sums first, then counts
FIELDS = (
    "wait_blame", "self_blame", "net_blame", "timeout_blame",
    "tail_wait_blame", "tail_self_blame", "tail_net_blame",
    "tail_timeout_blame", "residual", "residual_abs",
    "crit_count", "tail_crit_count", "error_count", "tail_count",
)
(F_WAIT, F_SELF, F_NET, F_TIMEOUT, F_TWAIT, F_TSELF, F_TNET, F_TTIMEOUT,
 F_RESIDUAL, F_RESIDUAL_ABS, F_CRIT, F_TCRIT, F_ERROR,
 F_TAIL_COUNT) = range(len(FIELDS))
#: a column's code is ``field << FIELD_SHIFT | hop``
FIELD_SHIFT = 27


#: an attempt record's flags: the first and the last attempt of its call
FIRST_ATTEMPT, LAST_ATTEMPT = 1, 2


@dataclass(frozen=True)
class SweepTables:
    """The call structure packed for the kernel, built once per
    Simulator by ``attribution.build_tables``: each hop's call-bearing
    steps (slots) as CSR over global hop ids, and one record a slot and
    one an attempt, in the order the kernel walks them (a hop's slots,
    a slot's calls in call order, a call's attempts in attempt order,
    masked attempts left out); int32 on the tables' device, a float32
    field as its bits."""

    level_offset: torch.Tensor   # (L + 1,) first hop of each level
    level_timeout: torch.Tensor  # (L,) 1 where a call of the level has a timeout
    slot_ptr: torch.Tensor       # (H + 1,) slots of each hop
    slots: torch.Tensor          # (NS, 4) first attempt, end, sleep floor, 0
    attempts: torch.Tensor       # (NA, 4) hop, wire round trip, timeout, flags
    hop_bin: torch.Tensor        # (H,) its service's first blame bin
    col_map: torch.Tensor        # (cols,) the kernel's columns, in its order
    main_cols: int               # the first of them, which every tile writes
    widest: int                  # hops of the widest level
    # the blame buckets' map, bucket = floor((log v - log_lo) * inv_log_r)
    # + 1 (``attribution.blame_bucket_index``)
    log_lo: float
    inv_log_r: float

    @property
    def num_levels(self) -> int:
        return self.level_offset.numel() - 1

    @property
    def num_cols(self) -> int:
        return self.col_map.numel()


def _f32_bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _stream(first, att_hop, timed, head, child, child_timed, own, foot):
    """One column stream in the kernel's order: ``head``; for each hop
    in order, each of its attempts' ``child`` fields (and
    ``child_timed`` where the attempt's level has a timeout), then its
    ``own`` fields; ``foot``.  Fields are codes before the hop is or-ed
    in."""
    num_hops = len(first) - 1
    n_att = np.diff(first)
    width = len(child) + len(child_timed) * timed
    # each attempt's offset within its hop's run, each hop's run's start
    owner = np.repeat(np.arange(num_hops), n_att)
    ends = np.cumsum(width)
    before = ends - width
    hop_start = np.concatenate([[0], np.cumsum(
        np.bincount(owner, weights=width, minlength=num_hops)
        .astype(np.int64) + len(own))])
    at = len(head) + hop_start[owner] + before - before[first[owner]] \
        if len(att_hop) else np.zeros(0, np.int64)
    cols = np.empty(len(head) + int(hop_start[-1]) + len(foot), np.int64)
    cols[:len(head)] = head
    child_hop = np.asarray(att_hop, np.int64)
    for i, f in enumerate(child):
        cols[at + i] = f | child_hop
    for i, f in enumerate(child_timed):
        cols[(at + len(child) + i)[timed]] = f | child_hop[timed]
    own_at = len(head) + hop_start[1:] - len(own)
    for i, f in enumerate(own):
        cols[own_at + i] = f | np.arange(num_hops)
    cols[len(cols) - len(foot):] = foot
    return cols


def column_map(first_attempt, att_hop, timed, num_hops):
    """The codes of the columns a tile writes, in the kernel's order, and
    how many of them every tile writes.  The main stream: the root
    edge's net; for each hop in order, each of its attempts' net (and
    timeout, where the attempt's level has one), then its own wait,
    self, crit and error counts; last the residual, its absolute value
    and the tail count.  The tail stream, written only by a tile with a
    row past the tail cut: the same tail-weighted (net, timeout; wait,
    self, crit).  ``first_attempt`` (H + 1,): each hop's first attempt
    (its attempts are one run of ``att_hop``); ``timed``: each
    attempt's level has a timeout."""
    if num_hops >= 1 << FIELD_SHIFT:
        raise ValueError(f"blame: {num_hops} hops do not fit a column code")
    first = np.asarray(first_attempt, np.int64)
    timed = np.asarray(timed, bool)

    def c(*fields):
        return [f << FIELD_SHIFT for f in fields]

    main = _stream(first, att_hop, timed, c(F_NET), c(F_NET), c(F_TIMEOUT),
                   c(F_WAIT, F_SELF, F_CRIT, F_ERROR),
                   c(F_RESIDUAL, F_RESIDUAL_ABS, F_TAIL_COUNT))
    tail = _stream(first, att_hop, timed, c(F_TNET), c(F_TNET),
                   c(F_TTIMEOUT), c(F_TWAIT, F_TSELF, F_TCRIT), [])
    return np.concatenate([main, tail]), len(main)


def pack_tables(*, level_offset, level_timeout, slot_ptr, slot_base,
                call_ptr, att_ptr, att_hop, hop_rtt, hop_timeout, hop_bin,
                log_lo, inv_log_r, device="cpu") -> SweepTables:
    """:class:`SweepTables` from the CSR arrays (numpy or sequences):
    ``slot_ptr`` over hops, ``call_ptr`` over slots, ``att_ptr`` over
    calls, ``att_hop`` each attempt's hop; ``hop_rtt`` and
    ``hop_timeout`` by hop, of the edge into it and of its call;
    ``log_lo`` and ``inv_log_r`` the blame buckets' map."""
    level_offset = np.asarray(level_offset, np.int64)
    if level_offset[1] != 1:
        raise ValueError("blame: the first level must hold the entry hop "
                         "alone")
    slot_ptr = np.asarray(slot_ptr, np.int64)
    call_ptr = np.asarray(call_ptr, np.int64)
    att_ptr = np.asarray(att_ptr, np.int64)
    att_hop = np.asarray(att_hop, np.int64)
    num_hops = len(hop_rtt)
    slot_att = att_ptr[call_ptr]
    slots = np.zeros((len(slot_att) - 1, 4), np.int32)
    slots[:, 0], slots[:, 1] = slot_att[:-1], slot_att[1:]
    slots[:, 2] = _f32_bits(slot_base)
    flags = np.zeros(len(att_hop), np.int64)
    calls = np.diff(att_ptr) > 0
    flags[att_ptr[:-1][calls]] |= FIRST_ATTEMPT
    flags[att_ptr[1:][calls] - 1] |= LAST_ATTEMPT
    attempts = np.stack([
        att_hop, _f32_bits(np.asarray(hop_rtt)[att_hop]).astype(np.int64),
        _f32_bits(np.asarray(hop_timeout)[att_hop]).astype(np.int64), flags,
    ], 1) if len(att_hop) else np.zeros((0, 4), np.int64)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(device)

    first = slot_att[slot_ptr]
    # an attempt's level is its parent's: the hop whose run holds it
    parent = np.repeat(np.arange(num_hops), np.diff(first))
    level = np.searchsorted(level_offset, parent, side="right") - 1
    timed = np.asarray(level_timeout, bool)[level]
    col_map, main_cols = column_map(first, att_hop, timed, num_hops)
    return SweepTables(
        level_offset=t(level_offset),
        level_timeout=t(np.asarray(level_timeout, np.int64)),
        slot_ptr=t(slot_ptr), slots=t(slots), attempts=t(attempts),
        hop_bin=t(np.asarray(hop_bin, np.int64)), col_map=t(col_map),
        main_cols=main_cols, widest=int(np.diff(level_offset).max()),
        log_lo=float(log_lo), inv_log_r=float(inv_log_r),
    )


@dataclass(frozen=True)
class LaunchPlan:
    """The geometry of one sweep (layout: ``Plan`` in
    ``csrc/blame.cu``)."""
    warps: int        # warps a block, each a tile of TILE rows at a time
    ctas: int         # blocks
    tiles: int        # tiles a member
    fold_group: int   # tiles a group of the first reduction pass
    groups: int       # groups a member
    smem_bytes: int   # dynamic shared memory a block
    words: int        # 32-bit words of a lane's crit bits a level
    global_bits: bool  # the crit bits in device memory, a region a warp

    def as_ints(self):
        return (self.warps, self.ctas, self.tiles, self.fold_group,
                self.groups, self.smem_bytes, self.words,
                int(self.global_bits))

    @property
    def bits_bytes(self) -> int:
        """Bytes of the device memory the crit bits take (0 in shared
        memory)."""
        if not self.global_bits:
            return 0
        return self.ctas * self.warps * 2 * self.words * TILE * 4


@lru_cache(maxsize=1024)
def launch_plan(rows: int, members: int, num_hops: int, widest: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's geometry for ``members`` (0: a solo block) of
    ``rows`` rows each over ``num_hops`` hops whose widest level holds
    ``widest`` hops.

    A lane keeps two levels' crit bits (the current level's, the next
    one's), ``words`` 32-bit words each, beside its warp's windows of the
    tile's rows and its column buffer: in shared memory, so the widest
    level sets how many warps a block holds; where not even one warp's
    fit, in a region of device memory a warp, as many warps in all as
    ``BITS_DEVICE_MAX`` bytes hold.  ``sms`` sets only how many blocks
    run: the sums do not depend on it.
    """
    if rows < 0 or members < 0 or num_hops < 1 or widest < 1:
        raise ValueError(
            f"blame: no plan for rows={rows}, members={members}, "
            f"hops={num_hops}, widest={widest}")
    mp = max(members, 1)
    words = -(-widest // 32)
    bits = 2 * words * TILE * 4
    global_bits = bits + WINDOW_BYTES + COLUMN_BYTES > SMEM_BLOCK
    if global_bits and bits > BITS_DEVICE_MAX:
        raise ValueError(
            f"blame: a level of {widest} hops does not fit ({bits} bytes "
            "of crit bits a warp)")
    per_warp = WINDOW_BYTES + COLUMN_BYTES + (0 if global_bits else bits)
    warps = min(MAX_WARPS, SMEM_BLOCK // per_warp)
    smem = warps * per_warp
    tiles = -(-rows // TILE)
    groups = -(-tiles // FOLD_GROUP)
    if groups * REDUCE_COLUMNS * 4 > SMEM_BLOCK:
        raise ValueError(f"blame: {rows} rows a member are too many")
    # 1 KB of each block's shared memory is the system's
    per_sm = max(1, min(SMEM_SM // (smem + 1024), 2048 // (TILE * warps)))
    ctas = max(1, min(-(-(mp * tiles) // warps), sms * per_sm))
    if global_bits:
        ctas = max(1, min(ctas, BITS_DEVICE_MAX // (warps * bits)))
    return LaunchPlan(
        warps=warps, ctas=ctas, tiles=tiles, fold_group=FOLD_GROUP,
        groups=groups, smem_bytes=smem, words=words,
        global_bits=global_bits,
    )


def _bind(lib: ctypes.CDLL) -> None:
    lib.blame_launch.argtypes = [ctypes.c_void_p] * 5
    lib.blame_launch.restype = ctypes.c_int
    lib.blame_error_string.argtypes = [ctypes.c_int]
    lib.blame_error_string.restype = ctypes.c_char_p


#: the compiled kernel library, built and loaded on first use
LIBRARY = NvccLibrary(_SOURCE, _bind)


# -- the kernel --------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"blame: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"blame: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"blame: {name} has shape {tuple(t.shape)}, expected "
            f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"blame: {name} must be contiguous")


def _rows(n: int, members: int) -> int:
    mp = max(members, 1)
    if n % mp:
        raise ValueError(f"blame: {n} rows are not {mp} members' blocks")
    return n // mp


def blame_sweep(res, tables, accf: torch.Tensor, acci: torch.Tensor, *,
                tail_cut: Optional[float] = None, members: int = 0) -> None:
    """The block's blame added in place, on the card, into a run's
    accumulator: ``accf`` and ``acci``, its float32 and int64 buffers
    (``attribution.accumulator``'s, whose views and sizes
    ``attribution`` checks before it calls here).

    ``res`` is a block's ``SimResults`` on a CUDA device (``members = M``:
    M members' blocks, member-major) and ``tables`` the Simulator's
    ``AttrTables`` on the same device.  ``tail_cut`` arms the
    tail-weighted sums (requests whose latency is at least the cut,
    rounded to float32 as the chain compares it).
    """
    lat = res.hop_latency
    dev = lat.device
    if dev.type != "cuda":
        raise ValueError(f"blame: the kernel takes CUDA tensors, not {dev}")
    sw = tables.sweep
    n, h = lat.shape
    rows = _rows(n, members)
    mp = max(members, 1)
    _check("hop_latency", lat, torch.float32, (n, h), dev)
    _check("hop_wait", res.hop_wait, torch.float32, (n, h), dev)
    _check("hop_sent", res.hop_sent, torch.bool, (n, h), dev)
    _check("hop_error", res.hop_error, torch.bool, (n, h), dev)
    _check("client_latency", res.client_latency, torch.float32, (n,), dev)
    if h != tables.num_hops:
        raise ValueError(f"blame: {h} hops, the tables have "
                         f"{tables.num_hops}")
    for name in ("level_offset", "level_timeout", "slot_ptr", "slots",
                 "attempts", "hop_bin", "col_map"):
        t = getattr(sw, name)
        _check(name, t, torch.int32, t.shape, dev)
    _check("accf", accf, torch.float32, (accf.numel(),), dev)
    _check("acci", acci, torch.int64, (acci.numel(),), dev)
    plan = launch_plan(rows, members, h, sw.widest, _sm_count(dev.index))
    cols = sw.num_cols
    part = torch.empty(mp * plan.tiles * cols, dtype=torch.int32,
                       device=dev)
    bits = torch.empty(max(plan.bits_bytes // 4, 1), dtype=torch.int32,
                       device=dev)
    tail_tile = torch.empty(mp * plan.tiles, dtype=torch.int32, device=dev)
    ptrs = (
        lat, res.hop_wait, res.hop_sent, res.hop_error, res.client_latency,
        sw.level_offset, sw.level_timeout, sw.slot_ptr, sw.slots,
        sw.attempts, sw.hop_bin, sw.col_map, part, tail_tile, bits, accf,
        acci,
    )
    ptr_arr = (ctypes.c_int64 * 17)(*(t.data_ptr() for t in ptrs))
    dims = (ctypes.c_int64 * 8)(rows, mp, h, tables.num_services,
                                sw.num_levels, cols, sw.main_cols,
                                int(tail_cut is not None))
    consts = (ctypes.c_double * 5)(
        float(np.float32(tail_cut)) if tail_cut is not None else 0.0,
        float(np.float32(tables.root_net)),
        float(np.float32(tables.refused_net)),
        sw.log_lo, sw.inv_log_r,
    )
    plan_arr = (ctypes.c_int32 * 8)(*plan.as_ints())
    lib = LIBRARY.get()
    code = lib.blame_launch(ptr_arr, dims, consts, plan_arr,
                            torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(
            "blame_sweep kernel launch failed: "
            + lib.blame_error_string(code).decode())
    blame_sweep.launches += 1


blame_sweep.launches = 0


@lru_cache(maxsize=16)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count


# -- the kernel's order in plain torch ---------------------------------------


def _child_orders(sw: SweepTables) -> List[np.ndarray]:
    """Each level's children (local indices) in the order the kernel
    adds their charges to a request's sum: the tables' attempt order."""
    lo = sw.level_offset.tolist()
    att_hop = sw.attempts[:, 0].cpu().numpy()
    # each hop's attempts are one run of the records, the hops' in order
    starts = np.append(sw.slots[:, 0].cpu().numpy(), len(att_hop))
    first = starts[sw.slot_ptr.cpu().numpy()]
    return [att_hop[first[lo[d]]:first[lo[d + 1]]] - lo[d + 1]
            for d in range(len(lo) - 1)]


def _sequential_sum(cols: Sequence[torch.Tensor], like: torch.Tensor):
    """``((0 + c0) + c1) + ...`` in float32, as a lane adds them."""
    acc = torch.zeros_like(like)
    for c in cols:
        acc = acc + c
    return acc


def _tile_sums(x: torch.Tensor, fold_group: int) -> torch.Tensor:
    """``(mp, C)`` column sums of ``x`` ``(mp, rows, C)`` in the
    kernel's order: each tile's pairwise tree over its rows (``((r0 + r1)
    + (r2 + r3)) + ...``), the tiles of each group in order, the groups
    in order."""
    mp, rows, c = x.shape
    tiles = -(-rows // TILE)
    groups = -(-tiles // fold_group)
    pad = x.new_zeros((mp, groups * fold_group * TILE, c))
    pad[:, :rows] = x
    t = pad.view(mp, groups * fold_group, TILE, c)
    while t.shape[2] > 1:
        t = t[:, :, 0::2] + t[:, :, 1::2]
    t = t[:, :, 0].view(mp, groups, fold_group, c)
    g = _sequential_sum([t[:, :, i] for i in range(fold_group)], t[:, :, 0])
    return _sequential_sum([g[:, k] for k in range(groups)], g[:, 0])


def kernel_sums(sw: SweepTables, members: int, n: int) -> Tuple[
        Callable[[torch.Tensor], torch.Tensor],
        Callable[[torch.Tensor, Optional[int]], torch.Tensor]]:
    """The kernel's order of summation as ``attribution._sweep``'s
    ``(rsum, colsum)`` for a block of ``n`` rows: each request's charges
    in float64, level by level in the tables' order (its residual then
    rounded to float32); the column sums by tile, group and total."""
    rows = _rows(n, members)
    mp = max(members, 1)
    lead = (members,) if members else ()
    orders = _child_orders(sw)

    def rsum(x):
        # the residuals come from the float64 sums below: the kernel
        # rounds each to float32 before the column sums
        v = x.float().reshape(mp, rows, -1) if x.is_floating_point() \
            else x.reshape(mp, rows, -1)
        s = _tile_sums(v, FOLD_GROUP) if x.is_floating_point() else v.sum(1)
        return s.reshape(lead + tuple(x.shape[1:]))

    def colsum(x, d):
        order = range(x.shape[1]) if d is None else orders[d].tolist()
        return _sequential_sum([x[:, c].double() for c in order],
                               x[:, 0].double())

    return rsum, colsum
