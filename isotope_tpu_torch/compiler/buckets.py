"""Level planning: the step encoding of a level, and the reference's
scan-bucket plan.

The port of ``isotope_tpu.compiler.buckets``.  Two decisions live here:

- :func:`level_encoding` (with :func:`plan_tiles`) decides each
  call-bearing level's step encoding: dense, tiled or sparse.  The
  engine executes all three (``sim/engine.py``: the dense census,
  ``_tiled_sweep``, ``_sparse_level_sweep``), and the linter reports the
  same choice (``analysis/topo_lint.lint_compiled``, VET-C006).
- :func:`plan_segments` packs consecutive depth levels whose shapes are
  close into scan buckets, each padded to its bounds, within ``waste``
  times the real element count (a critical-path DP over each run of
  eligible levels, or the greedy extension).  This is the JAX engine's
  ``lax.scan`` plan, which bounds its trace size; it describes the
  reference's executor, not work the port executes: the port sweeps
  every level one by one, which computes the same values.  Its only
  consumer is the linter's VET-T008 (:func:`plan_stats`), so that the
  rule reports the padding the reference reports.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


#: padded-elements / real-elements budget for one bucket (see plan_segments)
DEFAULT_WASTE = 1.6

#: a bucket shorter than this runs unrolled (no padding, no scan overhead)
MIN_SCAN_LEVELS = 2

#: per-segment dispatch/trace overhead in element units for the
#: critical-path schedule (see plan_segments).  The executor's segments
#: run strictly sequentially (level d+1 feeds level d), so the schedule's
#: critical path is the SUM over segments of (dispatch overhead +
#: element work); the overhead constant is set high enough that merging
#: consecutive levels is preferred whenever the waste budget allows it —
#: the cost model's "one dispatch saved beats moderate padding" regime.
SEGMENT_OVERHEAD_ELEMS = 1 << 24

#: default bound on a dense tile's step width (plan_tiles): hops whose
#: script is wider stay on the residual sparse encoding.
DEFAULT_TILE_PMAX = 64

#: critical-path DP lookback cap: buckets longer than this are not
#: considered (keeps planning O(levels * cap); a >64-level scan body
#: already amortizes its dispatch overhead to nothing)
MAX_BUCKET_LEVELS = 64


@dataclasses.dataclass(frozen=True)
class LevelShape:
    """Shape metadata of one depth level (host-side planning input)."""

    size: int       # hops at this level
    pmax: int       # widest script among the level's services
    children: int   # hops at the next level spawned here
    calls: int      # call sites (retry fans share one site)
    attempts: int   # max retry attempts of any call
    sparse: bool    # the engine would use a non-dense (sparse/tiled)
    offset: int     # start of the level's slice in BFS hop order
    # dense-blocked tiling of a sparse level: ((size, width), ...) per
    # tile plus the residual sparse slot count — reporting/cost only
    # (tiled levels execute as one unrolled segment)
    tiles: Optional[Tuple[Tuple[int, int], ...]] = None
    residual_slots: int = 0

    @property
    def leaf(self) -> bool:
        return self.calls == 0 or self.children == 0


@dataclasses.dataclass(frozen=True)
class ScanBucketPlan:
    """One scan segment: levels ``d0..d1`` padded to common bounds.

    ``bound_hops`` covers every level size in ``d0..d1`` AND the size of
    level ``d1+1`` — the scan carry holds the *child* level's outputs,
    so the deepest child must fit the carry width too.
    """

    d0: int
    d1: int
    bound_hops: int      # B — hop/children axis bound
    bound_steps: int     # P — step axis bound
    bound_calls: int     # K
    bound_attempts: int  # A

    @property
    def num_levels(self) -> int:
        return self.d1 - self.d0 + 1

    def signature(self) -> tuple:
        return ("scan", self.d0, self.d1, self.bound_hops,
                self.bound_steps, self.bound_calls, self.bound_attempts)


@dataclasses.dataclass(frozen=True)
class UnrolledLevelPlan:
    """One unrolled segment: a single level traced with static shapes."""

    d: int

    def signature(self) -> tuple:
        return ("unrolled", self.d)


Segment = Union[ScanBucketPlan, UnrolledLevelPlan]


def _bucket_cost(shapes: Sequence[LevelShape], bounds: Tuple[int, int, int,
                                                             int]) -> int:
    b, p, k, a = bounds
    return len(shapes) * (b * p + 3 * b + 2 * k * a)


def _real_cost(shapes: Sequence[LevelShape]) -> int:
    return sum(
        s.size * s.pmax + 3 * s.children + 2 * s.calls * s.attempts
        for s in shapes
    )


def _bounds(levels: Sequence[LevelShape], child_size: int
            ) -> Tuple[int, int, int, int]:
    return (
        max([child_size] + [s.size for s in levels]),
        max(s.pmax for s in levels),
        max(s.calls for s in levels),
        max(s.attempts for s in levels),
    )


def segment_cp_cost(shapes: Sequence[LevelShape], seg: Segment) -> int:
    """Critical-path cost (element units) of one schedule segment.

    Segments execute strictly sequentially — level d+1's outputs feed
    level d's sweep — so the schedule's critical path is the SUM of
    per-segment costs: a fixed dispatch/trace overhead plus the padded
    element work the segment touches.  This is the cost function BOTH
    the planner's critical-path schedule (plan_segments) and the vet
    cost model's schedule report (analysis/costmodel.py) use.
    """
    if isinstance(seg, ScanBucketPlan):
        members = shapes[seg.d0:seg.d1 + 1]
        bounds = (seg.bound_hops, seg.bound_steps, seg.bound_calls,
                  seg.bound_attempts)
        return SEGMENT_OVERHEAD_ELEMS + _bucket_cost(members, bounds)
    s = shapes[seg.d]
    if s.tiles is not None:
        elems = sum(t_size * t_w for t_size, t_w in s.tiles)
        elems += s.residual_slots + 3 * s.children + 2 * s.calls * s.attempts
        return SEGMENT_OVERHEAD_ELEMS + elems
    return SEGMENT_OVERHEAD_ELEMS + _real_cost([s])


def plan_cp_cost(shapes: Sequence[LevelShape],
                 segs: Sequence[Segment]) -> int:
    """Total critical-path cost of one plan (element units)."""
    return sum(segment_cp_cost(shapes, s) for s in segs)


def _partition_run(
    shapes: Sequence[LevelShape],
    i: int,
    j: int,
    waste: float,
    schedule: str,
) -> List[Segment]:
    """Partition one maximal scan-eligible run ``[i..j]`` into segments.

    ``critical-path`` solves the optimal partition by DP over the run,
    minimizing the summed per-segment critical-path cost
    (:func:`segment_cp_cost`); the waste budget stays a HARD constraint
    on every bucket, so the knob keeps its meaning.  ``greedy`` is the
    historical left-to-right maximal extension (kept for comparison /
    fallback).
    """
    n = len(shapes)

    def bucket_of(a: int, b: int) -> Optional[ScanBucketPlan]:
        run = shapes[a:b + 1]
        child_size = shapes[b + 1].size if b + 1 < n else 0
        bounds = _bounds(run, child_size)
        if _bucket_cost(run, bounds) > waste * _real_cost(run):
            return None
        bb, p, k, a_ = bounds
        return ScanBucketPlan(a, b, bb, p, k, a_)

    if schedule == "greedy":
        segs: List[Segment] = []
        a = i
        while a <= j:
            b = a
            while b + 1 <= j and bucket_of(a, b + 1) is not None:
                b += 1
            if b - a + 1 >= MIN_SCAN_LEVELS:
                segs.append(bucket_of(a, b))
                a = b + 1
            else:
                segs.append(UnrolledLevelPlan(a))
                a += 1
        return segs

    # critical-path DP: best[e] = (cost, segments) covering run[i..e].
    # Bucket bounds are maintained INCREMENTALLY while the candidate
    # start walks left (they are running maxima), so each (a, e) pair
    # costs O(1); the lookback is capped at MAX_BUCKET_LEVELS.
    INF = float("inf")
    best_cost = [INF] * (j - i + 2)
    best_prev: List[Optional[Tuple[int, Segment]]] = [None] * (j - i + 2)
    best_cost[0] = 0.0
    for e in range(i, j + 1):
        idx = e - i + 1
        # unrolled single level
        seg: Segment = UnrolledLevelPlan(e)
        c = best_cost[idx - 1] + segment_cp_cost(shapes, seg)
        if c < best_cost[idx]:
            best_cost[idx] = c
            best_prev[idx] = (idx - 1, seg)
        # buckets ending at e (length >= MIN_SCAN_LEVELS)
        child_size = shapes[e + 1].size if e + 1 < n else 0
        bb, bp, bk, ba = child_size, 1, 0, 1
        real = 0
        for a in range(e, max(i, e - MAX_BUCKET_LEVELS + 1) - 1, -1):
            s = shapes[a]
            bb = max(bb, s.size)
            bp = max(bp, s.pmax)
            bk = max(bk, s.calls)
            ba = max(ba, s.attempts)
            real += (
                s.size * s.pmax + 3 * s.children
                + 2 * s.calls * s.attempts
            )
            length = e - a + 1
            if length < MIN_SCAN_LEVELS:
                continue
            padded = length * (bb * bp + 3 * bb + 2 * bk * ba)
            if padded > waste * real:
                # infeasible at THIS span; wider spans can re-enter
                # feasibility (bounds are maxima), so keep walking
                continue
            c = best_cost[a - i] + SEGMENT_OVERHEAD_ELEMS + padded
            if c < best_cost[idx]:
                best_cost[idx] = c
                best_prev[idx] = (
                    a - i, ScanBucketPlan(a, e, bb, bp, bk, ba)
                )
    # walk back
    out: List[Segment] = []
    idx = j - i + 1
    while idx > 0:
        prev, seg = best_prev[idx]
        out.append(seg)
        idx = prev
    out.reverse()
    return out


def plan_segments(
    shapes: Sequence[LevelShape],
    waste: float = DEFAULT_WASTE,
    enabled: bool = True,
    schedule: str = "critical-path",
) -> List[Segment]:
    """Partition the depth levels into scan buckets and unrolled islands.

    Levels are first split at the ineligible islands (leaves, sparse /
    tiled levels); each maximal eligible run is then partitioned by the
    selected ``schedule``:

    - ``"critical-path"`` (default): optimal DP over the run minimizing
      the summed per-segment critical-path cost
      (:func:`segment_cp_cost` — dispatch overhead + padded elements),
      the ordering/merging discipline of the static-schedule literature
      applied to the depth axis.  The ``waste`` budget stays a hard
      per-bucket constraint.
    - ``"greedy"``: the historical left-to-right maximal extension.

    Runs shorter than ``MIN_SCAN_LEVELS`` fall back to unrolled
    segments either way, and results are bit-identical across plans
    (the executor contract — only wall-clock changes).

    ``enabled`` carries only ``SimParams.bucketed_scan``: protected
    (policies/rollouts) Simulators plan buckets like any other since
    the retry-budget gate reached the scan body
    (sim/levelscan.SweepCtx.retry_coin) — the old
    ``and policies is None`` restriction is gone.
    """
    segs: List[Segment] = []
    n = len(shapes)
    i = 0
    while i < n:
        s = shapes[i]
        eligible = enabled and not s.leaf and not s.sparse
        if not eligible:
            segs.append(UnrolledLevelPlan(i))
            i += 1
            continue
        j = i
        while j + 1 < n and not (shapes[j + 1].leaf or shapes[j + 1].sparse):
            j += 1
        segs.extend(_partition_run(shapes, i, j, waste, schedule))
        i = j + 1
    return segs


def plan_signature(segs: Sequence[Segment]) -> tuple:
    """Hashable shape signature of a plan — part of the AOT cache key."""
    return tuple(s.signature() for s in segs)


def schedule_table(shapes: Sequence[LevelShape],
                   segs: Sequence[Segment]) -> List[dict]:
    """The chosen schedule as cost-ranked rows (vet ``--json`` surface).

    One row per executor segment with its critical-path cost
    (:func:`segment_cp_cost`) and share of the plan's total; rows are
    ordered by DESCENDING cost — the segments that own the critical
    path come first — while ``position`` records the execution order.
    """
    total = max(plan_cp_cost(shapes, segs), 1)
    rows = []
    for pos, seg in enumerate(segs):
        if isinstance(seg, ScanBucketPlan):
            kind = "scan"
            d0, d1 = seg.d0, seg.d1
        else:
            s = shapes[seg.d]
            if s.tiles is not None:
                kind = "tiled"
            elif s.sparse:
                kind = "sparse"
            elif s.leaf:
                kind = "leaf"
            else:
                kind = "unrolled"
            d0 = d1 = seg.d
        cost = segment_cp_cost(shapes, seg)
        rows.append({
            "position": pos,
            "kind": kind,
            "d0": d0,
            "d1": d1,
            "cp_cost_elems": int(cost),
            "cp_share": cost / total,
        })
    rows.sort(key=lambda r: (-r["cp_cost_elems"], r["position"]))
    return rows


# ---------------------------------------------------------------------------
# dense-blocked tiling of sparse levels


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

    def shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((len(idx), w) for w, idx in self.tiles)


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
    tiles: List[Tuple[int, np.ndarray]] = []
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


def plan_stats(shapes: Sequence[LevelShape],
               segs: Sequence[Segment]) -> dict:
    """Padding/coverage accounting of one plan (VET-T008 + tests).

    ``padded_elems`` / ``real_elems`` count only the SCAN buckets —
    unrolled islands pay no padding — so ``padding_waste_fraction`` is
    the fraction of bucket element-slots that are pure padding.
    """
    buckets_list = [s for s in segs if isinstance(s, ScanBucketPlan)]
    padded = real = 0
    per_bucket = []
    for b in buckets_list:
        members = shapes[b.d0:b.d1 + 1]
        bounds = (b.bound_hops, b.bound_steps, b.bound_calls,
                  b.bound_attempts)
        p = _bucket_cost(members, bounds)
        r = _real_cost(members)
        padded += p
        real += r
        per_bucket.append(
            {"d0": b.d0, "d1": b.d1, "levels": b.num_levels,
             "padded_elems": p, "real_elems": r,
             "padded_rows": b.num_levels * b.bound_hops
             - sum(s.size for s in members)}
        )
    return {
        "num_segments": len(segs),
        "num_buckets": len(buckets_list),
        "levels_bucketed": sum(b.num_levels for b in buckets_list),
        "levels_unrolled": len(segs) - len(buckets_list),
        "padded_elems": padded,
        "real_elems": real,
        "padding_waste_fraction": (
            (padded - real) / padded if padded else 0.0
        ),
        "buckets": per_bucket,
    }
