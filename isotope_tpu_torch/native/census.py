"""The census join of the upward level sweep: CUDA kernel and plain twin.

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

There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``census.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

_DIR = pathlib.Path(__file__).parent
_SOURCE = _DIR / "csrc" / "census.cu"
_BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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


class _Library:
    """The compiled kernel library, built and loaded on first use."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        # what ptxas said of each kernel (registers, shared memory,
        # spills) in this process's build; empty if the library existed
        self.build_log = ""

    @staticmethod
    def nvcc() -> str:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
        if home:
            return str(pathlib.Path(home) / "bin" / "nvcc")
        return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"

    def path(self) -> pathlib.Path:
        digest = hashlib.sha256(
            _SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return _BUILD_DIR / f"libcensus-{digest}.so"

    def build(self) -> pathlib.Path:
        """Compile the kernel unless this source's library exists."""
        out = self.path()
        if out.exists():
            return out
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [self.nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {_SOURCE.name}:\n{proc.stderr}"
                )
            self.build_log = proc.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.census_launch.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.census_launch.restype = ctypes.c_int
            lib.census_error_string.argtypes = [ctypes.c_int]
            lib.census_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


LIBRARY = _Library()


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
    through the kernel, which raises on what it does not take.
    """
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
