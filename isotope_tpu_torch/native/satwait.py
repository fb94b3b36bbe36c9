"""The finite-population waits of ``-qps max``: a CUDA kernel and plain twins.

Under the saturated closed loop every hop's wait is drawn from the
finite-population law (``sim/engine.py`` ``Simulator._saturated_wait``):
the population copula ``z' = scale * (z - c * e * (e . z))`` centres a
request's normals across its hops, then each hop's quantile polynomial
in ``v = -log1p(-u')`` (Horner) is taken at the conditional uniform
``u'`` above the hop's zero-wait mass ``p0``.  The tables come in rows
(a run's (chaos x churn) phases, a chaos fleet's members' phases, or
one row); ``rows`` gives each request's row, ``None`` row 0.

- On a CUDA tensor :func:`saturated_wait` launches the hand-written
  kernel of ``csrc/satwait.cu``, built with ``nvcc`` for ``sm_90a`` into
  ``_build/`` at first use and loaded with ctypes (``native/nvcc.py``).
  It reads ``z`` once and writes the wait once.
- On a CPU tensor it computes :func:`saturated_wait_reference`, the
  eager op chain the engine ran inline before the kernel.
- :func:`saturated_wait_sequential` is the kernel's own order of
  operations in plain torch (the chain with the row sum taken in the
  kernel's order); the kernel equals it bit for bit.
- :func:`launch_plan` chooses the kernel's geometry from the shapes
  alone, in plain Python, so that the CPU tests can check it.

There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``saturated_wait.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import pathlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Optional, Tuple

import torch

from isotope_tpu_torch.native.nvcc import NvccLibrary

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "satwait.cu"

#: elements a thread takes of a row at a time (the kernel's 16-byte loads)
CHUNK = 4
#: the most threads a row (one warp)
GROUP_MAX = 32
#: threads a block, 128 / group rows
THREADS = 128
#: coefficients a hop of the tables' own quantile polynomial has
#: (``sim/closed.py`` ``DEFAULT_QUANTILE_DEGREE`` + 1), the degree the
#: kernel's Horner pass is unrolled at (``kDegree``)
UNROLLED_DEGREE = 11


@dataclass(frozen=True)
class LaunchPlan:
    """The geometry of one launch (layout: ``Plan`` in
    ``csrc/satwait.cu``)."""
    group: int           # threads a row, a power of two
    threads: int         # threads a block
    rows_per_block: int
    blocks: int
    aligned: bool        # 16-byte loads and stores
    unrolled: bool       # D == UNROLLED_DEGREE: the unrolled Horner pass

    def as_ints(self) -> Tuple[int, ...]:
        return (self.group, self.threads, self.rows_per_block, self.blocks,
                int(self.aligned), int(self.unrolled))


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


@lru_cache(maxsize=1024)
def launch_plan(n: int, h: int, d: int, aligned: bool = True
                ) -> LaunchPlan:
    """The kernel's geometry for ``z`` of shape ``(n, h)`` and ``d``
    coefficients a hop.

    A row takes the fewest lanes of a warp (a power of two, at most
    ``GROUP_MAX``) that give each at most one chunk of ``CHUNK``
    elements; wider rows give each lane several chunks.  A block of
    ``THREADS`` holds several rows.  ``aligned``: every pointer
    lies on a 16-byte boundary; the loads are 16 bytes wide only where
    that holds and ``h`` is a multiple of ``CHUNK``, so that every row
    and table row starts on one.
    """
    if n < 0 or h < 1 or d < 1:
        raise ValueError(f"satwait: no plan for n={n}, h={h}, d={d}")
    group = min(GROUP_MAX, _pow2_at_least(-(-h // CHUNK)))
    rows_per_block = THREADS // group
    return LaunchPlan(
        group=group, threads=THREADS, rows_per_block=rows_per_block,
        blocks=max(1, -(-n // rows_per_block)),
        aligned=aligned and h % CHUNK == 0,
        unrolled=d == UNROLLED_DEGREE,
    )


@lru_cache(maxsize=1024)
def _plan_array(n: int, h: int, d: int, aligned: bool):
    """``launch_plan`` as the int32 array ``satwait_launch`` takes."""
    ints = launch_plan(n, h, d, aligned).as_ints()
    return (ctypes.c_int32 * len(ints))(*ints)


def _bind(lib: ctypes.CDLL) -> None:
    lib.satwait_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.satwait_launch.restype = ctypes.c_int
    lib.satwait_error_string.argtypes = [ctypes.c_int]
    lib.satwait_error_string.restype = ctypes.c_char_p


#: the compiled kernel library, built and loaded on first use
LIBRARY = NvccLibrary(_SOURCE, _bind)


def _chain(z, rows, p0, coef, e, c, scale, copula: bool,
           row_sum: Callable[[torch.Tensor], torch.Tensor]):
    """The wait chain, with the copula's row sum taken by ``row_sum``."""
    from isotope_tpu_torch.sim.engine import ndtr

    if rows is None:
        p0_h, e_h, c_h, scale_h = p0[0], e[0], c[0], scale[0]

        def coef_at(ci):
            return coef[0, ci]
    else:
        # each request's row, gathered
        p0_h, e_h = p0[rows], e[rows]
        c_h, scale_h = c[:, None][rows], scale[rows]

        def coef_at(ci):
            return coef[:, ci, :][rows]
    if copula:
        zproj = row_sum(z * e_h)
        z = (z - c_h * e_h * zproj) * scale_h
    u_sat = ndtr(z)
    u_c = torch.clamp(
        (u_sat - p0_h) / torch.clamp(1.0 - p0_h, min=1e-9),
        0.0, 1.0 - 1e-7,
    )
    v = -torch.log1p(-u_c)
    deg = coef.shape[1]
    w = coef_at(deg - 1)
    for ci in range(deg - 2, -1, -1):
        w = w * v + coef_at(ci)
    return torch.where(u_sat < p0_h, 0.0, torch.clamp(w, min=0.0))


def saturated_wait_reference(
    z: torch.Tensor,
    rows: Optional[torch.Tensor],
    p0: torch.Tensor,
    coef: torch.Tensor,
    e: torch.Tensor,
    c: torch.Tensor,
    scale: torch.Tensor,
    copula: bool = True,
) -> torch.Tensor:
    """The plain torch op chain: ``(N, H)`` waits.

    The copula's projection ``e . z`` is a ``sum`` over the hop axis;
    the same ops as the JAX package's saturated branch.
    """
    return _chain(z, rows, p0, coef, e, c, scale, copula,
                  lambda prod: prod.sum(-1, keepdim=True))


def _group_sum(prod: torch.Tensor, group: int) -> torch.Tensor:
    """``(N, 1)`` row sums of ``prod`` in the kernel's order: lane ``t``
    of a row's ``group`` adds its elements (``j // CHUNK % group == t``)
    left to right, then a butterfly sums the group's lanes."""
    n, h = prod.shape
    width = CHUNK * group
    padded = torch.zeros((n, -(-h // width) * width), dtype=prod.dtype,
                         device=prod.device)
    padded[:, :h] = prod
    parts = padded.view(n, -1, group, CHUNK)
    # a padded element adds +0.0, which leaves a sum that starts at +0.0
    # as it is
    acc = torch.zeros((n, group), dtype=prod.dtype, device=prod.device)
    for k in range(parts.shape[1]):
        for i in range(CHUNK):
            acc = acc + parts[:, k, :, i]
    lane = torch.arange(group, device=prod.device)
    off = group // 2
    while off:
        acc = acc + acc[:, lane ^ off]
        off //= 2
    return acc[:, :1]


def saturated_wait_sequential(
    z: torch.Tensor,
    rows: Optional[torch.Tensor],
    p0: torch.Tensor,
    coef: torch.Tensor,
    e: torch.Tensor,
    c: torch.Tensor,
    scale: torch.Tensor,
    copula: bool = True,
) -> torch.Tensor:
    """The kernel's own order of operations in plain torch: the chain of
    :func:`saturated_wait_reference` with the projection summed in the
    kernel's order (``launch_plan``'s group).  The kernel equals it bit
    for bit."""
    group = launch_plan(z.shape[0], z.shape[1], coef.shape[1]).group
    return _chain(z, rows, p0, coef, e, c, scale, copula,
                  lambda prod: _group_sum(prod, group))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"satwait: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"satwait: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"satwait: {name} has shape {tuple(t.shape)}, expected "
            f"{tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"satwait: {name} must be contiguous")


def saturated_wait(
    z: torch.Tensor,                     # (N, H) f32
    rows: Optional[torch.Tensor],        # (N,) i64 in [0, R), or None
    p0: torch.Tensor,                    # (R, H) f32
    coef: torch.Tensor,                  # (R, D, H) f32
    e: torch.Tensor,                     # (R, H) f32
    c: torch.Tensor,                     # (R,) f32
    scale: torch.Tensor,                 # (R, H) f32
    copula: bool = True,
) -> torch.Tensor:
    """Fused finite-population waits: ``(N, H)``.

    CPU tensors go through :func:`saturated_wait_reference`; CUDA
    tensors through the kernel, which raises on what it does not take.
    ``copula=False`` leaves ``z`` uncentred (``e``, ``c`` and ``scale``
    are then not read).
    """
    if z.device.type == "cpu":
        return saturated_wait_reference(z, rows, p0, coef, e, c, scale,
                                        copula)
    if z.device.type != "cuda":
        raise ValueError(f"satwait: unsupported device {z.device}")
    dev = z.device
    if z.dim() != 2 or coef.dim() != 3:
        raise ValueError(
            f"satwait: z must be (N, H) and coef (R, D, H), got "
            f"{tuple(z.shape)} and {tuple(coef.shape)}"
        )
    n, h = z.shape
    r, d = coef.shape[0], coef.shape[1]
    _check("z", z, torch.float32, (n, h), dev)
    if rows is not None:
        _check("rows", rows, torch.int64, (n,), dev)
    _check("p0", p0, torch.float32, (r, h), dev)
    _check("coef", coef, torch.float32, (r, d, h), dev)
    _check("e", e, torch.float32, (r, h), dev)
    _check("c", c, torch.float32, (r,), dev)
    _check("scale", scale, torch.float32, (r, h), dev)
    out = torch.empty((n, h), dtype=torch.float32, device=dev)
    if n == 0 or h == 0:
        return out
    if r == 0 or d == 0:
        raise ValueError(f"satwait: empty tables, coef {tuple(coef.shape)}")
    lib = LIBRARY.get()
    ptrs = (
        z.data_ptr(), rows.data_ptr() if rows is not None else None,
        p0.data_ptr(), coef.data_ptr(), e.data_ptr(), c.data_ptr(),
        scale.data_ptr(), out.data_ptr(),
    )
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (z, p0, coef, e, scale, out))
    code = lib.satwait_launch(
        *ptrs, n, h, d, int(copula), _plan_array(n, h, d, aligned),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            "satwait kernel launch failed: "
            + lib.satwait_error_string(code).decode()
        )
    saturated_wait.launches += 1
    return out


saturated_wait.launches = 0
