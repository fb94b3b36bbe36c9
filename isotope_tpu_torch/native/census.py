"""The census join of the upward level sweep: CUDA kernels and plain twins.

For every (request, hop) row of a dense level with children it takes
each step's ``max(sleep floor, concurrent-call census)``, masks unused
step lanes, zeroes the steps after a transport failure and the whole
row of a hop that returned a 500, and produces the hop's busy time and
the exclusive per-step prefix that places its children in time.

- On a CUDA tensor :func:`census` launches the hand-written kernel of
  ``csrc/census.cu`` (the port of the Pallas TPU kernel
  ``isotope_tpu/native/census_pallas.py``), built with ``nvcc`` for
  ``sm_90a`` into ``_build/`` at first use and loaded with ctypes.
- On a CPU tensor it computes :func:`census_reference`, the plain torch
  op chain the kernel is held to.
- :func:`launch_plan` chooses the kernel's geometry (which of its two
  kernels, tile rows, shared-memory pitch and size, grid) from the
  shapes alone, in plain Python, so that the CPU tests can check it.
- :func:`census_ragged` is the whole dense join of a level whose
  (hops x Pmax) step grid is mostly padding (:func:`ragged_engages`,
  which ``sim/joins.level_join`` asks after the dense choice): the
  per-step call census, the first failed step, the join and the
  children's offsets (``sim/joins.DenseJoin.sweep``), in one kernel
  that walks each hop's real steps (:class:`RaggedPlan`) and never
  allocates the grid.  Its plain version is that composition.

There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``census.launches`` counts kernel launches, both
kernels' (``census_ragged.launches`` the ragged kernel's alone).
"""
from __future__ import annotations

import ctypes
import pathlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from isotope_tpu_torch.compiler.buckets import PADDED_GRID
from isotope_tpu_torch.native.nvcc import NVCC_FLAGS, NvccLibrary  # noqa: F401

_DIR = pathlib.Path(__file__).parent
_SOURCE = _DIR / "csrc" / "census.cu"


# -- launch geometry (csrc/census.cu takes it as given) --------------------

# sm_90: shared memory one block may opt in to, what one SM has, what the
# runtime keeps per resident block, and the size above which a kernel
# must opt in with cudaFuncSetAttribute
SMEM_BLOCK_MAX = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1_024
SMEM_DEFAULT = 49_152
MAX_THREADS_SM = 2_048
REGS_SM = 65_536
REGS_THREAD = 64        # both kernels' __launch_bounds__(256, 4)

STAGES = 3              # the tile kernel's cp.async ring (kStages)
MIN_TILE_ROWS = 128     # rows of a tile at the widest steps
WIDE_CHUNK = 128        # steps staged at once when a row does not fit
TILE_TARGET_BYTES = 24_576   # agg bytes a tile aims at for short rows
MAX_ROWS_PER_THREAD = 8
TABLE_MAX_BYTES = 49_152     # tile kernel: tables staged up to this size
STREAM_THREADS = 256
STREAM_MAX_P = 4        # rows this short take the stream kernel
TILES_PER_BLOCK = 2     # tiles shrink until each resident block has this


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _stage_bytes(rows: int, pitch: int) -> int:
    """One ring stage: agg at ``pitch`` floats per row, then the fail
    steps (int32) and error flags (bytes) of the tile's rows."""
    return rows * pitch * 4 + rows * 4 + _round16(rows)


def _pitch(chunk: int, vec: int) -> int:
    """Floats per staged row: ``chunk`` rounded up to ``vec``, plus
    ``vec`` if that leaves an even number of ``vec``-wide words, so that
    the threads of one shared-memory wavefront hit distinct banks."""
    pitch = -(-chunk // vec) * vec
    return pitch + vec if (pitch // vec) % 2 == 0 else pitch


@dataclass(frozen=True)
class LaunchPlan:
    """The geometry of one census launch (layout: ``Plan`` in
    ``csrc/census.cu``)."""
    path: str            # "stream" (P <= 4), "tile" or "wide"
    threads: int
    blocks: int
    smem_bytes: int      # dynamic shared memory per block
    tile_rows: int = 0
    chunk: int = 0       # steps staged per row at once
    pitch: int = 0       # shared-memory floats per staged row
    vec: int = 1         # tile kernel: steps per shared-memory read
    tables_in_smem: bool = False
    aligned: bool = True
    table_bytes: int = 0
    stage_bytes: int = 0

    @property
    def opt_in(self) -> bool:
        """Above 48 KB a kernel must first raise its limit with
        ``cudaFuncSetAttribute``."""
        return self.smem_bytes > SMEM_DEFAULT

    def as_ints(self) -> Tuple[int, ...]:
        return (
            0 if self.path == "stream" else 1, self.threads, self.blocks,
            self.smem_bytes, int(self.opt_in), self.tile_rows, self.chunk,
            self.pitch, self.vec, int(self.tables_in_smem),
            int(self.aligned), self.table_bytes, self.stage_bytes,
        )


def _vec(p: int) -> int:
    return 4 if p % 4 == 0 else 2 if p % 2 == 0 else 1


def _resident(threads: int, smem: int) -> int:
    """Blocks one SM holds at once, by shared memory, threads and
    registers."""
    return min(SMEM_SM // (smem + SMEM_RESERVED), MAX_THREADS_SM // threads,
               REGS_SM // (threads * REGS_THREAD))


@lru_cache(maxsize=1024)
def launch_plan(n: int, b: int, p: int, aligned: bool = True,
                sms: int = 132) -> LaunchPlan:
    """The kernel and geometry for ``agg`` of shape ``(n, b, p)``.

    ``aligned``: every pointer lies on a 16-byte boundary (else the
    kernels copy 4 bytes at a time); ``sms``: the card's SM count.
    """
    rows = n * b
    if p <= STREAM_MAX_P:
        # four rows per thread, or one where pointers are unaligned
        need = -(-rows // ((4 if aligned else 1) * STREAM_THREADS))
        return LaunchPlan(
            path="stream", threads=STREAM_THREADS,
            blocks=max(1, min(need, sms * _resident(STREAM_THREADS, 0))),
            smem_bytes=0, chunk=p, pitch=p, aligned=aligned,
        )
    vec = _vec(p)
    # "wide": a tile of MIN_TILE_ROWS whole rows does not fit the ring,
    # so the tile kernel stages rows in chunks of WIDE_CHUNK steps
    wide = STAGES * _stage_bytes(MIN_TILE_ROWS, _pitch(p, vec)) > (
        SMEM_BLOCK_MAX
    )
    chunk = WIDE_CHUNK if wide else p
    pitch = _pitch(chunk, vec)
    threads = 256 if pitch <= 32 else 128
    per_thread = 1 if wide else max(1, min(
        MAX_ROWS_PER_THREAD, TILE_TARGET_BYTES // (threads * pitch * 4)
    ))
    table_bytes = _round16(2 * b * pitch * 4)
    while True:
        # the largest tile (up to the byte target) that still gives each
        # resident block TILES_PER_BLOCK tiles, so small calls spread
        # over every SM
        tile_rows = threads * per_thread
        stage = _stage_bytes(tile_rows, pitch)
        ring = STAGES * stage
        tables = (not wide and table_bytes <= TABLE_MAX_BYTES
                  and ring + table_bytes <= SMEM_BLOCK_MAX)
        smem = ring + (table_bytes if tables else 0)
        per_sm = _resident(threads, smem)
        tiles = -(-rows // tile_rows)
        if per_thread == 1 or tiles >= TILES_PER_BLOCK * sms * per_sm:
            break
        per_thread //= 2
    return LaunchPlan(
        path="wide" if wide else "tile", threads=threads,
        blocks=max(1, min(tiles, sms * per_sm)), smem_bytes=smem,
        tile_rows=tile_rows, chunk=chunk, pitch=pitch, vec=vec,
        tables_in_smem=tables, aligned=aligned,
        table_bytes=table_bytes if tables else 0, stage_bytes=stage,
    )


@lru_cache(maxsize=1024)
def _plan_array(n: int, b: int, p: int, aligned: bool, sms: int):
    """``launch_plan`` as the int32 array ``census_launch`` takes."""
    ints = launch_plan(n, b, p, aligned, sms).as_ints()
    return (ctypes.c_int32 * len(ints))(*ints)


def _bind(lib: ctypes.CDLL) -> None:
    lib.census_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.census_launch.restype = ctypes.c_int
    lib.census_ragged_launch.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int64]
        + [ctypes.c_int32] * 10 + [ctypes.c_void_p]
    )
    lib.census_ragged_launch.restype = ctypes.c_int
    lib.census_error_string.argtypes = [ctypes.c_int]
    lib.census_error_string.restype = ctypes.c_char_p


#: the compiled kernel library, built and loaded on first use
LIBRARY = NvccLibrary(_SOURCE, _bind)

#: the recording op log's census hook (``analysis/oplog.py``), or None;
#: called as ``AUDIT(fn, *args)`` for ``fn``, :func:`census` or
#: :func:`census_ragged`, and returns what ``fn(*args)`` returns
AUDIT = None


def census_reference(
    step_base: torch.Tensor,
    step_mask: torch.Tensor,
    agg: torch.Tensor,
    fail_step: Optional[torch.Tensor] = None,
    err: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch op chain: ``(busy, exclusive step prefix)``.

    The same ops as the XLA reference chain of the JAX package
    (``tests/test_census_pallas.py::_reference``).
    """
    p = agg.shape[-1]
    dur = torch.maximum(step_base[None], agg) * step_mask.to(
        torch.float32
    )[None]
    if fail_step is not None:
        steps = torch.arange(p, dtype=torch.int32, device=agg.device)
        dur = dur * (steps <= fail_step[:, :, None])
    if err is not None:
        dur = dur * ~err[:, :, None]
    return dur.sum(-1), torch.cumsum(dur, -1) - dur


@lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def census_sequential(
    step_base: torch.Tensor,
    step_mask: torch.Tensor,
    agg: torch.Tensor,
    fail_step: Optional[torch.Tensor] = None,
    err: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's own order of operations in plain torch: one step at a
    time, each product and sum its own rounded op, the running sum left
    to right.  The kernel equals it bit for bit; :func:`census_reference`
    (a ``cumsum``) may associate the prefix sum otherwise."""
    n, b, p = agg.shape
    run = torch.zeros((n, b), dtype=torch.float32, device=agg.device)
    excl = torch.empty_like(agg)
    for q in range(p):
        d = torch.maximum(step_base[:, q], agg[:, :, q]) * step_mask[:, q]
        if fail_step is not None:
            d = d * (q <= fail_step)
        if err is not None:
            d = d * ~err
        run = run + d
        excl[:, :, q] = run - d
    return run, excl


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"census: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"census: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"census: {name} has shape {tuple(t.shape)}, expected "
            f"{tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"census: {name} must be contiguous")


def census(
    step_base: torch.Tensor,                # (B, P) f32
    step_mask: torch.Tensor,                # (B, P) f32, exact 0/1
    agg: torch.Tensor,                      # (N, B, P) f32
    fail_step: Optional[torch.Tensor] = None,  # (N, B) i32, sentinel P
    err: Optional[torch.Tensor] = None,        # (N, B) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused census join: ``(busy (N, B), excl (N, B, P))``.

    CPU tensors go through :func:`census_reference`; CUDA tensors
    through the kernel, which raises on what it does not take.  While an
    op log records (``analysis/oplog.py``), the call is its ``AUDIT``
    hook's, which logs it as one entry.
    """
    if AUDIT is not None:
        return AUDIT(census, step_base, step_mask, agg, fail_step, err)
    if agg.device.type == "cpu":
        return census_reference(step_base, step_mask, agg, fail_step, err)
    if agg.device.type != "cuda":
        raise ValueError(f"census: unsupported device {agg.device}")
    dev = agg.device
    if agg.dim() != 3:
        raise ValueError(f"census: agg must be (N, B, P), got {agg.shape}")
    n, b, p = agg.shape
    _check("agg", agg, torch.float32, (n, b, p), dev)
    _check("step_base", step_base, torch.float32, (b, p), dev)
    _check("step_mask", step_mask, torch.float32, (b, p), dev)
    if fail_step is not None:
        _check("fail_step", fail_step, torch.int32, (n, b), dev)
    if err is not None:
        _check("err", err, torch.bool, (n, b), dev)
    busy = torch.empty((n, b), dtype=torch.float32, device=dev)
    excl = torch.empty((n, b, p), dtype=torch.float32, device=dev)
    if n * b == 0 or p == 0:
        if p == 0:
            busy.zero_()
        return busy, excl
    lib = LIBRARY.get()
    ptrs = (
        step_base.data_ptr(), step_mask.data_ptr(), agg.data_ptr(),
        fail_step.data_ptr() if fail_step is not None else None,
        err.data_ptr() if err is not None else None,
        busy.data_ptr(), excl.data_ptr(),
    )
    aligned = all(x % 16 == 0 for x in ptrs[2:] if x is not None)
    code = lib.census_launch(
        *ptrs, n, b, p, _plan_array(n, b, p, aligned, _sm_count(dev)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            "census kernel launch failed: "
            + lib.census_error_string(code).decode()
        )
    census.launches += 1
    return busy, excl


census.launches = 0


# -- the ragged census: a mostly padded dense level ---------------------------


def ragged_engages(step_base: np.ndarray, step_mask: np.ndarray) -> bool:
    """Whether a dense level with calls takes :func:`census_ragged`: its
    ``(L, P)`` grid is more than ``PADDED_GRID`` times its real steps
    (the ratio at which ``compiler/buckets.level_encoding`` calls a grid
    wasteful), and every padded step's sleep floor is finite, so that a
    padded step adds exactly +0.0 (``max(base, 0) * 0``) to the running
    sum and skipping it leaves every bit as it is."""
    real = step_mask != 0
    return (
        step_mask.size > PADDED_GRID * int(real.sum())
        and bool(np.isfinite(step_base.astype(np.float32)[~real]).all())
    )


def _ptr(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


@dataclass(frozen=True, eq=False)
class RaggedPlan:
    """One dense level's tables for :func:`census_ragged`.

    The dense site's own tables, for the plain version, and the compact
    step list the kernel walks: hop ``h``'s real steps are ``hop_ptr[h]
    .. hop_ptr[h + 1]`` (in step order), real step ``s`` has the step
    index ``step_q[s]``, the sleep floor ``step_floor[s]``, the calls
    ``call_col[call_ptr[s] .. call_ptr[s + 1]]`` (columns of
    ``dur_call``, in level call order) and the children
    ``child_col[child_ptr[s] .. child_ptr[s + 1]]``; ``walk_hops`` lists
    the hops with at least one real step."""

    step_base: torch.Tensor       # (L, P) f32
    step_mask: torch.Tensor       # (L, P) f32, exact 0/1
    call_seg: torch.Tensor        # (K,) i64: hop * P + step
    call_hop: torch.Tensor        # (K,) i64
    call_step: torch.Tensor       # (K,) i32
    child_seg: torch.Tensor       # (C,) i64: hop * P + step
    uniform: Optional[int]        # c: every slot holds c calls in order
    hop_ptr: torch.Tensor         # (L + 1,) i32
    walk_hops: torch.Tensor       # (W,) i32
    step_q: torch.Tensor          # (S,) i32
    step_floor: torch.Tensor      # (S,) f32
    call_ptr: torch.Tensor        # (S + 1,) i32
    call_col: torch.Tensor        # (K,) i32
    child_ptr: torch.Tensor       # (S + 1,) i32
    child_col: torch.Tensor       # (C,) i32

    @property
    def size(self) -> int:
        return self.step_base.shape[0]

    @property
    def pmax(self) -> int:
        return self.step_base.shape[1]

    @property
    def num_calls(self) -> int:
        return len(self.call_col)

    @property
    def num_children(self) -> int:
        return len(self.child_col)

    @property
    def num_steps(self) -> int:
        return len(self.step_q)


def ragged_plan(step_base, step_mask, call_seg, call_hop, call_step,
                child_seg, uniform=None) -> RaggedPlan:
    """The compact step list of a dense level, from the tables its dense
    site holds (tensors on the level's device).  Every call and child
    hangs on a real step."""
    dev = step_base.device
    mask = step_mask.cpu().numpy() != 0
    base = step_base.cpu().numpy()
    size, pmax = mask.shape
    hops, qs = np.nonzero(mask)           # row-major: by hop, then step
    slot = np.full(mask.shape, -1, np.int64)
    slot[hops, qs] = np.arange(len(qs))
    flat = slot.reshape(-1)
    call_slot = flat[call_seg.cpu().numpy()]
    child_slot = flat[child_seg.cpu().numpy()]
    if (call_slot < 0).any() or (child_slot < 0).any():
        raise ValueError("ragged_plan: a call or child on a padded step")

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    steps = len(qs)
    return RaggedPlan(
        step_base=step_base, step_mask=step_mask, call_seg=call_seg,
        call_hop=call_hop, call_step=call_step, child_seg=child_seg,
        uniform=uniform,
        hop_ptr=t(_ptr(mask.sum(1)), torch.int32),
        walk_hops=t(np.flatnonzero(mask.any(1)), torch.int32),
        step_q=t(qs, torch.int32),
        step_floor=t(base[hops, qs], torch.float32),
        call_ptr=t(_ptr(np.bincount(call_slot, minlength=steps)),
                   torch.int32),
        call_col=t(np.argsort(call_slot, kind="stable"), torch.int32),
        child_ptr=t(_ptr(np.bincount(child_slot, minlength=steps)),
                    torch.int32),
        child_col=t(np.argsort(child_slot, kind="stable"), torch.int32),
    )


def census_ragged_reference(plan: RaggedPlan, dur_call, final_transport=None,
                            err=None, join=census_reference):
    """The dense site's composition, its own ops (``sim/joins.py``):
    ``_slot_max`` into the padded grid, ``_fail_min``, ``join``
    (:func:`census_reference`, or :func:`census_sequential` or
    :func:`census` on the card) and the children's gather.  Returns
    ``(busy, fail_step, off)``."""
    from isotope_tpu_torch.sim.joins import _fail_min, _slot_max

    n = dur_call.shape[0]
    size, p = plan.size, plan.pmax
    agg = _slot_max(dur_call, n, size, p, plan.call_seg, plan.uniform)
    fail_step = None
    if final_transport is not None:
        fail_step = _fail_min(final_transport, plan.call_step,
                              plan.call_hop, n, size, p, p, plan.uniform)
    busy, excl = join(plan.step_base, plan.step_mask, agg.contiguous(),
                      fail_step, err)
    return busy, fail_step, excl.reshape(n, -1)[:, plan.child_seg]


def census_ragged_sequential(plan: RaggedPlan, dur_call, final_transport=None,
                             err=None, keep_nan=True):
    """The ragged kernel's own order of operations in plain torch: hop
    by hop, each real step's call census, fail step, product and running
    sum its own rounded op, padded steps skipped.  The kernel equals it
    bit for bit (``keep_nan``: the card's scatter carries a NaN), and it
    equals :func:`census_ragged_reference` with ``join=census_sequential``
    wherever the level's padded floors are finite."""
    n, dev = dur_call.shape[0], dur_call.device
    hop_ptr, step_q, floor, call_ptr, call_col, child_ptr, child_col = (
        t.tolist() for t in (plan.hop_ptr, plan.step_q, plan.step_floor,
                             plan.call_ptr, plan.call_col, plan.child_ptr,
                             plan.child_col))
    p = plan.pmax
    busy = torch.zeros((n, plan.size), dtype=torch.float32, device=dev)
    fail_out = torch.full((n, plan.size), p, dtype=torch.int32, device=dev)
    off = torch.empty((n, plan.num_children), dtype=torch.float32,
                      device=dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    keep_row = None if err is None else (~err).to(torch.float32)
    for h in range(plan.size):
        if hop_ptr[h] == hop_ptr[h + 1]:
            continue      # busy +0.0, fail step P
        run = zero
        fail = fail_out[:, h]
        for s in range(hop_ptr[h], hop_ptr[h + 1]):
            q = step_q[s]
            cols = call_col[call_ptr[s]:call_ptr[s + 1]]
            agg = zero
            if cols and plan.uniform is not None:
                agg = dur_call[:, cols[0]]
            for j, col in enumerate(cols):
                if plan.uniform is not None and j == 0:
                    continue
                x = dur_call[:, col]
                agg = (torch.maximum(x, agg) if keep_nan
                       or plan.uniform is not None else torch.fmax(x, agg))
            if final_transport is not None and cols:
                hit = final_transport[:, cols].any(1)
                fail = torch.where(hit, torch.clamp(fail, max=q), fail)
            d = torch.maximum(torch.full_like(agg, floor[s]), agg) * one
            if final_transport is not None:
                d = d * (q <= fail)
            if keep_row is not None:
                d = d * keep_row[:, h]
            run = run + d
            kids = child_col[child_ptr[s]:child_ptr[s + 1]]
            if kids:
                off[:, kids] = (run - d)[:, None]
        busy[:, h] = run
        fail_out[:, h] = fail
    return busy, fail_out if final_transport is not None else None, off


@lru_cache(maxsize=None)
def _scatter_keeps_nan(dev: torch.device) -> bool:
    """Whether this device's ``scatter_reduce_(..., "amax")`` carries a
    NaN into its slot (the CPU's does; a card's atomic max may drop it),
    so that the kernel's census of a step matches ``_slot_max``'s."""
    out = torch.zeros(1, dtype=torch.float32, device=dev).scatter_reduce_(
        0, torch.zeros(2, dtype=torch.int64, device=dev),
        torch.tensor([float("nan"), 1.0], device=dev), "amax",
        include_self=True,
    )
    return bool(torch.isnan(out).item())


RAGGED_THREADS = 256
RAGGED_BLOCKS_SM = 8      # 2,048 resident threads an SM
#: the kernel walks the hops with steps apart, rows fastest, where at most
#: one hop in this many has a step (csrc/census.cu); measured on the card
#: it gains at 1 in 68 to 1 in 46 hops and loses at 1 in 4 and 1 in 1.2
RAGGED_SPLIT = 16


def ragged_blocks(n: int, size: int, walk: int, sms: int = 132
                  ) -> Tuple[int, int]:
    """The ragged kernel's grid: blocks walking the ``walk`` hops with
    steps apart (one thread per row and such hop; none unless at most
    one hop in ``RAGGED_SPLIT`` has a step), then blocks over every (row,
    hop), which write the hops without a step and walk the others when
    no block does; each part at most a full card of resident blocks, on
    a grid-stride loop."""
    cap = RAGGED_BLOCKS_SM * sms

    def need(items):
        return min(-(-items // RAGGED_THREADS), cap)

    split = walk * RAGGED_SPLIT <= size
    return need(n * walk) if split else 0, max(1, need(n * size))


def census_ragged(
    plan: RaggedPlan,
    dur_call: torch.Tensor,                         # (N, K) f32
    final_transport: Optional[torch.Tensor] = None,  # (N, K) bool
    err: Optional[torch.Tensor] = None,             # (N, L) bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The dense call site of a padded level: ``(busy (N, L), fail_step
    (N, L) i32 or None, off (N, C))``, with ``fail_step`` where
    ``final_transport`` is given.

    CPU tensors go through :func:`census_ragged_reference`; CUDA tensors
    through the ragged kernel, which raises on what it does not take,
    and counts in ``census.launches`` and ``census_ragged.launches``.
    While an op log records, the call is its ``AUDIT`` hook's."""
    if AUDIT is not None:
        return AUDIT(census_ragged, plan, dur_call, final_transport, err)
    if dur_call.device.type == "cpu":
        return census_ragged_reference(plan, dur_call, final_transport, err)
    if dur_call.device.type != "cuda":
        raise ValueError(f"census: unsupported device {dur_call.device}")
    dev = dur_call.device
    if dur_call.dim() != 2:
        raise ValueError(f"census: dur_call must be (N, K), got "
                         f"{tuple(dur_call.shape)}")
    n = dur_call.shape[0]
    size, k, c = plan.size, plan.num_calls, plan.num_children
    _check("dur_call", dur_call, torch.float32, (n, k), dev)
    _check("step_floor", plan.step_floor, torch.float32,
           (plan.num_steps,), dev)
    if final_transport is not None:
        _check("final_transport", final_transport, torch.bool, (n, k), dev)
    if err is not None:
        _check("err", err, torch.bool, (n, size), dev)
    busy = torch.empty((n, size), dtype=torch.float32, device=dev)
    fail_step = (
        torch.empty((n, size), dtype=torch.int32, device=dev)
        if final_transport is not None else None
    )
    off = torch.empty((n, c), dtype=torch.float32, device=dev)
    rows = n * size
    if rows == 0:
        return busy, fail_step, off
    lib = LIBRARY.get()
    walk = len(plan.walk_hops)
    code = lib.census_ragged_launch(
        plan.hop_ptr.data_ptr(), plan.walk_hops.data_ptr(),
        plan.step_q.data_ptr(), plan.step_floor.data_ptr(),
        plan.call_ptr.data_ptr(), plan.call_col.data_ptr(),
        plan.child_ptr.data_ptr(), plan.child_col.data_ptr(),
        dur_call.data_ptr(),
        final_transport.data_ptr() if final_transport is not None else None,
        err.data_ptr() if err is not None else None,
        busy.data_ptr(),
        fail_step.data_ptr() if fail_step is not None else None,
        off.data_ptr(), n, size, walk, k, c, plan.pmax,
        plan.uniform is not None, _scatter_keeps_nan(dev),
        *ragged_blocks(n, size, walk, _sm_count(dev)), RAGGED_THREADS,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            "census ragged kernel launch failed: "
            + lib.census_error_string(code).decode()
        )
    census.launches += 1
    census_ragged.launches += 1
    return busy, fail_step, off


census_ragged.launches = 0
