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
from typing import Optional, Tuple

import torch

_DIR = pathlib.Path(__file__).parent
_SOURCE = _DIR / "csrc" / "census.cu"
_BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


class _Library:
    """The compiled kernel library, built and loaded on first use."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None

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
                ctypes.c_void_p,
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.census_launch(
        step_base.data_ptr(), step_mask.data_ptr(), agg.data_ptr(),
        fail_step.data_ptr() if fail_step is not None else None,
        err.data_ptr() if err is not None else None,
        busy.data_ptr(), excl.data_ptr(), n, b, p, stream,
    )
    if code != 0:
        raise RuntimeError(
            "census kernel launch failed: "
            + lib.census_error_string(code).decode()
        )
    census.launches += 1
    return busy, excl


census.launches = 0
