"""The level step-encoding decision (dense, tiled or sparse).

A copy of ``level_encoding`` and the tile planner it consults from
``isotope_tpu.compiler.buckets``.  The port runs dense levels only: the
engine asks this function which encoding a call-bearing level would
use and refuses the tiled and sparse ones (ROADMAP queue 1).  The
scan-bucket planner of the same module is not copied: the port sweeps
every level one by one, which gives the same results.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: padded-elements / real-elements budget for one tile bin
DEFAULT_WASTE = 1.6

#: default bound on a dense tile's step width (plan_tiles): hops whose
#: script is wider stay on the residual sparse encoding
DEFAULT_TILE_PMAX = 64


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Dense-blocked partition of one skewed level's hops.

    ``tiles`` holds (width, hop-index-array) bins — each becomes a
    dense (size x width) sub-grid padded to the bin's widest script —
    and ``residual`` the hop indices that stay on the true sparse
    call-slot encoding (scripts wider than the tile cap).
    """

    tiles: Tuple[Tuple[int, np.ndarray], ...]
    residual: np.ndarray

    @property
    def tiled_elems(self) -> int:
        return int(sum(w * len(idx) for w, idx in self.tiles))


def plan_tiles(
    widths: np.ndarray,
    cap: int = DEFAULT_TILE_PMAX,
    waste: float = DEFAULT_WASTE,
) -> TilePlan:
    """Bin one level's hops into fixed-width dense tiles.

    ``widths`` is the per-hop real script width (number of occupied
    step columns).  Hops wider than ``cap`` go to the residual sparse
    encoding.  The rest are sorted by width and greedily grouped into
    tiles: a bin grows while padding every member to the running widest
    script stays within ``waste`` x the real element count — the same
    budget discipline the level-bucket planner applies on the depth
    axis, here applied within one level's fan-out classes.
    """
    widths = np.asarray(widths, np.int64)
    idx = np.arange(len(widths))
    residual = idx[widths > cap]
    tileable = idx[widths <= cap]
    order = tileable[np.argsort(widths[tileable], kind="stable")]
    tiles: list = []
    start = 0
    while start < len(order):
        end = start + 1
        real = max(int(widths[order[start]]), 1)
        wmax = max(int(widths[order[start]]), 1)
        while end < len(order):
            w = max(int(widths[order[end]]), 1)
            cand_w = max(wmax, w)
            cand_real = real + w
            if cand_w * (end - start + 1) > waste * cand_real:
                break
            wmax, real = cand_w, cand_real
            end += 1
        tiles.append((wmax, np.sort(order[start:end])))
        start = end
    return TilePlan(tiles=tuple(tiles), residual=np.sort(residual))


def level_encoding(
    size: int,
    pmax: int,
    n_slots: int,
    widths: np.ndarray,
    *,
    sparse_level_elems: int,
    tiling: bool = True,
    tile_pmax: int = DEFAULT_TILE_PMAX,
    waste: float = DEFAULT_WASTE,
) -> Tuple[str, Optional[TilePlan]]:
    """Decide one call-bearing level's step encoding.

    Returns ``("dense" | "tiled" | "sparse", tile_plan)`` — the single
    decision point shared by the engine's lowering and the vet linter,
    so the static analysis always reports the executor's real choice.
    A level leaves the dense grid when the grid is > 4x its real call
    slots (or past ``sparse_level_elems``); it then tiles when the
    dense-blocked plan halves the grid, else keeps the true sparse
    encoding (tiny fully-skewed levels, e.g. one hub hop).
    """
    dense_elems = size * pmax
    if dense_elems <= max(4 * n_slots, sparse_level_elems):
        return "dense", None
    if not tiling:
        return "sparse", None
    plan = plan_tiles(widths, cap=tile_pmax, waste=waste)
    # residual hops keep one slot per call-bearing step; approximate
    # with their width sum for the decision (exact slots need call
    # tables the caller may not have at hand)
    res_elems = int(np.asarray(widths)[plan.residual].sum())
    if plan.tiled_elems + res_elems <= dense_elems // 2 and plan.tiles:
        return "tiled", plan
    return "sparse", None
