"""Pre-flight cost model: flops, peak bytes, critical path.

The port of ``isotope_tpu.analysis.costmodel``.  Two estimators compose:

- **Op-log walker** (:func:`oplog_cost`): op-level flop counts by the
  reference's rules, the live bytes' high-water the pilot block's
  dispatch mode measured (``analysis/oplog.py``), and the longest
  op-dependency chain.  Runs on the pilot the op auditor already
  recorded.
- **Plan table** (:func:`segment_table`): one row per level the port
  sweeps (``tiled``, ``sparse``, ``leaf`` or ``unrolled``: the port has
  no scan buckets), its element counts scaled by the request block.

The headline product is the **memory verdict**: the estimated peak
device bytes of a run at its block size against the device's capacity
selects the ladder rung the run starts on (``runner/run.py``).  The
port's ladder has two rungs, ``scan`` and ``half-block``, both on the
Simulator's device (no ``cpu-eager``): when even half a block does not
fit, VET-M001 blocks.

The pilot's high-water splits in two: the storages it read but did not
allocate (the Simulator's tables, ``external_bytes``) are counted once,
and the ones it allocated scale with the block (``block / n``), where
the reference scales its whole trace.

A fleet sizes its member chunk from :func:`fleet_member_bytes`: two
pilot blocks of ONE member of the fleet's own folded program (its chaos
rows, control laws, recorder and blame reductions), extrapolated point
by point to the block as the run's estimate is.  The plan-only peak
(:func:`peak_bytes_at_block`) is the reference's law, kept where no
pilot can be recorded (no load given); a chunk never changes a
result.

The collective cost rows (:func:`comm_table`) price a mesh layout's
summary merge for ``--mesh auto``'s layout search
(``parallel/layout.py``) with the port's own link constants: the
reference's rows, keys and link names, priced for NVLink inside a host
and a NIC between hosts.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

from isotope_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    Finding,
)

#: env override of the per-device memory (bytes), as in the reference
ENV_DEVICE_BYTES = "ISOTOPE_VET_DEVICE_BYTES"

#: share of device capacity the timeline recorder's O(S x W) carries
#: may take before VET-M003 reports them (informational: the window
#: planner clamps instead of running out of memory)
ENV_TIMELINE_SHARE = "ISOTOPE_VET_TIMELINE_SHARE"
DEFAULT_TIMELINE_SHARE = 0.10

#: share of the device's memory an estimate may fill: the caching
#: allocator never packs perfectly
CAPACITY_FILL = 0.85

#: the port's ladder (``resilience/supervisor.rung_blocks``)
RUNG_NAMES = ("scan", "half-block")

# -- collective cost constants (parallel/layout.py feeds on these) -------
#
# Per-link bandwidth and latency that :func:`comm_table` prices the
# summary-merge collectives with: inside a host, NVLink 4 between NVIDIA
# H100 80GB HBM3 (SXM, 700 W) cards (450 GB/s a direction); between
# hosts, a 400 Gb/s NIC.  Unmeasured assumptions, not measurements:
# calibrating them needs a machine with several cards.  Only their
# ordering steers the layout search (the link between hosts is ~10x
# slower and has ~5x the latency), and that ordering is robust.
IN_HOST_BANDWIDTH_BYTES_S = 4.5e11
CROSS_HOST_BANDWIDTH_BYTES_S = 5.0e10
IN_HOST_LATENCY_S = 2e-6
CROSS_HOST_LATENCY_S = 1e-5

#: ops costed at zero flops: data movement, not arithmetic
_FREE_OPS = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.squeeze",
    "aten.unsqueeze", "aten.permute", "aten.t", "aten.transpose",
    "aten.expand", "aten.slice", "aten.select", "aten.as_strided",
    "aten.alias", "aten.detach", "aten.clone", "aten.copy_",
    "aten._to_copy", "aten.cat", "aten.stack", "aten.index",
    "aten.index_select", "aten.gather", "aten.take",
    "aten.constant_pad_nd", "aten.zeros", "aten.ones", "aten.empty",
    "aten.full", "aten.arange", "aten.fill_", "aten.zero_",
    "aten.lift_fresh", "aten.zeros_like", "aten.ones_like",
    "aten.empty_like", "aten.full_like", "aten.new_zeros",
    "aten.new_ones", "aten.new_empty", "aten.new_full",
    "aten.empty_strided", "aten.repeat", "aten.repeat_interleave",
    "aten.flip", "aten.roll", "aten.split", "aten.split_with_sizes",
    "aten.unbind", "aten.diagonal", "aten._reshape_alias",
})

#: reductions, scatters, scans and sorts: input plus output elements
_REDUCE_PREFIXES = (
    "aten.scatter", "aten.index_add", "aten.index_put", "aten.sum",
    "aten.amax", "aten.amin", "aten.max", "aten.min", "aten.mean",
    "aten.prod", "aten.cum", "aten.sort", "aten.argsort", "aten.topk",
    "aten.any", "aten.all", "aten.logsumexp", "aten.bincount",
    "aten.argmax", "aten.argmin", "aten._index_put_impl_", "census",
)

#: matrix products: 2 * output elements * the contracted extent
_DOT_OPS = frozenset({"aten.mm", "aten.bmm", "aten.matmul",
                      "aten.addmm", "aten.baddbmm"})


def device_capacity_bytes(override: Optional[float] = None,
                          device=None) -> Optional[float]:
    """Per-device memory in bytes, or None when unknown: the explicit
    override (``--device-bytes``), then ``ISOTOPE_VET_DEVICE_BYTES``,
    then the CUDA device's total memory.  The CPU reports nothing (host
    RAM is the allocator's problem, not the gate's), so a fleet on the
    CPU runs as one chunk and the memory verdict stays silent, as in
    the reference."""
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
    """The plan-only peak of :func:`estimate_run`: the live working set
    is a few event tensors wide (ten float32 (block, H) tensors), plus
    the recorder's carries."""
    h = max(sim.compiled.num_hops, 1)
    return 10.0 * 4.0 * block_requests * h + timeline_bytes(sim)


@dataclasses.dataclass(frozen=True)
class OpLogCost:
    """Static costs of one recorded pilot block."""

    flops: float
    peak_bytes: float          # high-water of the storages it allocated
    external_bytes: float      # storages it read but did not allocate
    critical_path: int         # longest op-dependency chain

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _numel(shape) -> float:
    n = 1
    for d in shape:
        n *= int(d)
    return float(n)


def _op_flops(op) -> float:
    out = sum(_numel(s) for s in op.out_shapes)
    name = op.packet
    if name in _DOT_OPS:
        contract = op.in_shapes[0][-1] if op.in_shapes and \
            op.in_shapes[0] else 1
        return 2.0 * out * float(contract)
    if name in _FREE_OPS:
        return 0.0
    if name.startswith(_REDUCE_PREFIXES):
        return out + sum(_numel(s) for s in op.in_shapes)
    return out


def oplog_cost(log) -> OpLogCost:
    """Static cost of one op log (``analysis/oplog.py``): flops by the
    reference's rules (``jaxpr_cost``), the measured high-water, and
    the longest chain of ops each reading a value the previous wrote
    (an ``alias`` join adds no step)."""
    from isotope_tpu_torch.analysis.oplog import ALIAS

    flops = 0.0
    depth_of = {}
    max_depth = 0
    for op in log.ops:
        d_in = max((depth_of.get(v, 0) for v in op.ins), default=0)
        if op.name == ALIAS:
            d_out = d_in
        else:
            flops += _op_flops(op)
            d_out = d_in + 1
        for v in op.outs:
            depth_of[v] = d_out
        max_depth = max(max_depth, d_out)
    return OpLogCost(
        flops=flops,
        peak_bytes=float(log.peak_bytes),
        external_bytes=float(log.external_bytes),
        critical_path=int(max_depth),
    )


def segment_table(sim, block_requests: int) -> List[dict]:
    """Per-level static costs at ``block_requests`` requests: one row
    per level the port sweeps (it has no scan buckets), with the step
    footprint of the level's join (``sim/joins.py``: the tiles' grids
    plus residual slots, the sparse slots, the leaf busy vector, or the
    dense grid, which a ragged level still reports as ``"unrolled"``)
    plus three per-hop columns and two per call attempt, multiplied by
    the request axis."""
    rows: List[dict] = []
    n = int(block_requests)
    for i, lvl in enumerate(sim._levels):
        kind = lvl.join.kind
        elems = n * (
            lvl.join.step_elems + 3 * lvl.size
            + 2 * lvl.num_calls * len(lvl.att_child)
        )
        rows.append({
            "segment": i,
            "kind": "unrolled" if kind in ("dense", "ragged") else kind,
            "levels": 1,
            "elems": elems,
            "bytes_f32": 4.0 * elems,
        })
    return rows


def schedule_rows(sim) -> List[dict]:
    """The ``bucket_schedule`` block of ``vet --json``: the REFERENCE
    executor's scan-bucket schedule, ranked by each segment's
    critical-path cost (``compiler/buckets.schedule_table`` over
    ``topo_lint.reference_plan``).  The port does not execute it: it
    sweeps every level one by one (``topo_lint.T008_NOTE``)."""
    from isotope_tpu_torch.analysis.topo_lint import reference_plan
    from isotope_tpu_torch.compiler import buckets

    shapes, plan = reference_plan(sim.compiled, sim.params)
    return buckets.schedule_table(shapes, plan)


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


def summary_bytes(num_services: int,
                  num_edges: Optional[int] = None) -> dict:
    """Byte sizes of one RunSummary's collective-merged leaf groups,
    split by how the sharded merge moves them (``parallel/sharded.py``):

    - ``replicated``: the scalars, the two fine latency histograms and
      the per-service series that are not svc-sharded, summed over
      every axis (every shard ends with a full copy);
    - ``scattered``: the per-service duration / response-size
      histograms, summed over the request axes and reduce-scattered
      over ``svc`` (each shard keeps a 1/svc tile).

    The shapes are ``metrics/prometheus.py``'s (duration histogram (S,
    2, len(DURATION_BUCKETS) + 1), size histograms (., len(SIZE_BUCKETS)
    + 1)) and ``metrics/histogram.py``'s ``NUM_BUCKETS``; ``num_edges``
    defaults to ``num_services`` (a tree has ~1 inbound edge a
    service)."""
    from isotope_tpu_torch.metrics.histogram import NUM_BUCKETS
    from isotope_tpu_torch.metrics.prometheus import (
        DURATION_BUCKETS,
        SIZE_BUCKETS,
    )

    s = max(int(num_services), 1)
    e = int(num_edges) if num_edges else s
    nsb = len(SIZE_BUCKETS) + 1
    nb = len(DURATION_BUCKETS) + 1
    replicated = 4.0 * (
        14                      # RunSummary scalars
        + 2 * NUM_BUCKETS       # latency_hist + win_latency_hist
        + s                     # incoming_total
        + e * (2 + nsb)         # outgoing_total / size_sum / size_hist
        + s * 2 * 2             # duration_sum + response_size_sum
        + 2 * s                 # utilization + unstable
    )
    scattered = 4.0 * (s * 2 * nb + s * 2 * nsb)
    return {"replicated": replicated, "scattered": scattered}


def _collective_s(bytes_: float, participants: int, link: str,
                  scatter: bool = False) -> float:
    """A ring collective's time: the link's latency a step plus the
    wire bytes (an all-reduce moves ``2 (p - 1) / p`` of the payload
    over each link, a reduce-scatter half that); one participant is
    free.  ``link`` is ``"ici"`` (inside a host) or ``"dcn"`` (between
    hosts)."""
    p = max(int(participants), 1)
    if p == 1:
        return 0.0
    lat, bw = (
        (CROSS_HOST_LATENCY_S, CROSS_HOST_BANDWIDTH_BYTES_S)
        if link == "dcn"
        else (IN_HOST_LATENCY_S, IN_HOST_BANDWIDTH_BYTES_S)
    )
    factor = (p - 1) / p if scatter else 2.0 * (p - 1) / p
    return lat * (p - 1) + factor * bytes_ / bw


def comm_table(
    num_services: int,
    data: int,
    svc: int,
    slices: int = 1,
    num_edges: Optional[int] = None,
    num_merges: int = 1,
) -> List[dict]:
    """Cost rows of one mesh layout's summary merge, the reference's:
    the replicated sum over the in-host axes (``psum_replicated``), the
    per-service sum over ``data`` feeding the reduce-scatter over
    ``svc`` (``psum_scatter_svc``), and on a layout with a slice axis
    the sum between hosts of the replicated group and the 1/svc tile
    (``psum_dcn``, issued last, so the link between hosts carries 1/svc
    of the per-service state).  ``link`` keeps the reference's names:
    ``"ici"`` means inside a host (NVLink) here, ``"dcn"`` between
    hosts.  ``num_merges`` scales every row (1: the merge after the
    loop; the overlap merges once a block).

    ``bytes`` is a shard's payload, ``time_s`` the row priced with the
    link constants above.  The port's merge issues collectives these
    rows do not price (ROADMAP queue 3): the extremes' MAX buffer and
    the Welford term's sum."""
    sizes = summary_bytes(num_services, num_edges)
    s = max(int(num_services), 1)
    s_pad = -(-s // max(svc, 1)) * max(svc, 1)
    scat = sizes["scattered"] * (s_pad / s)     # the svc padding rides too
    tile = scat / max(svc, 1)
    rows = [
        {
            "collective": "psum_replicated",
            "link": "ici",
            "participants": data * svc,
            "bytes": sizes["replicated"],
            "time_s": _collective_s(
                sizes["replicated"], data * svc, "ici"
            ),
        },
        {
            "collective": "psum_scatter_svc",
            "link": "ici",
            "participants": svc,
            "bytes": scat,
            "time_s": (
                _collective_s(scat, svc, "ici", scatter=True)
                # the request axis's sum feeding the scatter
                + _collective_s(scat, data, "ici")
            ),
        },
    ]
    if slices > 1:
        cross = sizes["replicated"] + tile
        rows.append({
            "collective": "psum_dcn",
            "link": "dcn",
            "participants": slices,
            "bytes": cross,
            "time_s": _collective_s(cross, slices, "dcn"),
        })
    for r in rows:
        r["time_s"] *= max(int(num_merges), 1)
    return rows


def ensemble_chunk(
    members: int,
    peak_bytes_per_member: float,
    capacity_bytes: Optional[float],
    fill: float = CAPACITY_FILL,
    carry_bytes_per_member: float = 0.0,
    fixed_bytes: float = 0.0,
) -> int:
    """Members per chunk of a fleet: ``fixed_bytes + members *
    peak_bytes`` must fit the capacity budget (``fixed_bytes``: what a
    chunk reads once, :func:`fleet_member_bytes`).  Balanced split: the
    chunk count is minimized first and members spread evenly across
    chunks (33 members over a 16-member budget run 11 + 11 + 11).
    Unknown capacity runs the whole fleet as one chunk."""
    members = max(int(members), 1)
    if (
        capacity_bytes is None
        or capacity_bytes <= 0
        or peak_bytes_per_member <= 0
    ):
        return members
    budget = fill * float(capacity_bytes) - max(float(fixed_bytes), 0.0)
    per_member = float(peak_bytes_per_member) + max(
        float(carry_bytes_per_member), 0.0
    )
    per_dispatch = int(budget // per_member)
    if per_dispatch >= members:
        return members
    per_dispatch = max(per_dispatch, 1)
    num_chunks = -(-members // per_dispatch)
    return -(-members // num_chunks)


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """The pre-flight verdict for one planned run."""

    block_requests: int
    trace_requests: int
    oplog: Optional[OpLogCost]      # costs of the pilot (small-n) block
    peak_bytes_at_block: float      # extrapolated to the real block
    flops_at_block: float
    critical_path: int
    segments: List[dict]
    capacity_bytes: Optional[float]
    # flight-recorder carry bytes (0 when SimParams.timeline is off);
    # already included in peak_bytes_at_block
    timeline_bytes: float = 0.0
    # the second pilot's request count (0: one pilot)
    slope_requests: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.oplog is not None:
            d["oplog"] = self.oplog.to_dict()
        return d


def pilot_live_bytes(log1, n1: int, log2, n2: int,
                     block_requests: int) -> float:
    """:func:`pilot_bytes` without the tables the pilots read: the
    high-water of what a block of ``block_requests`` allocates."""
    import numpy as np

    t = (float(block_requests) - n1) / max(n2 - n1, 1)
    h1 = np.asarray(log1.highs, np.float64)
    h2 = np.asarray(log2.highs, np.float64)
    if len(h1) and h1.shape == h2.shape:
        peak = float((h1 + (h2 - h1) * t).max())
    else:
        p1, p2 = float(log1.peak_bytes), float(log2.peak_bytes)
        peak = p1 + max(p2 - p1, 0.0) * t
    return max(peak, 0.0)


def pilot_bytes(log1, n1: int, log2, n2: int,
                block_requests: int) -> float:
    """The peak bytes of a block of ``block_requests`` from two pilots'
    op logs (``analysis/oplog.OpLog``) of ``n1`` < ``n2`` requests.

    Each pilot's live bytes after each allocation (``highs``) is a line
    in the request count, point by point, when the two pilots ran the
    same program: each point's slope (per request) scales with the
    block and its intercept (fixed temporaries, such as the wait law's
    (S x k_max) rows) counts once; the estimate is the extrapolated
    curve's maximum, so a high-water that moves from a fixed temporary
    at the pilots' sizes to the per-request tensors at the block is
    found.  Pilots whose allocations differ in number take the same
    law on their high-waters.  The tables the pilots read count once."""
    return (max(float(log1.external_bytes), float(log2.external_bytes))
            + pilot_live_bytes(log1, n1, log2, n2, block_requests))


class PilotCurve(NamedTuple):
    """What :func:`pilot_live_bytes` reads of a recorded op log."""

    highs: tuple
    peak_bytes: int
    external_bytes: int

    @classmethod
    def of(cls, log) -> "PilotCurve":
        return cls(tuple(log.highs), log.peak_bytes, log.external_bytes)


class FleetBytes(NamedTuple):
    """What a folded fleet's chunk law reads (:func:`fleet_member_bytes`):
    a chunk of M members of a fleet of N needs ``fixed + N * retained +
    M * per_member`` bytes (:func:`fleet_chunk`)."""

    fixed: float        # the tables the chunk reads, once
    per_member: float   # the high-water of one member's block loop
    retained: float     # what a member's finished chunk keeps live


def fleet_member_bytes(sim, load, block_requests: int, *, control=None,
                       blame=False, chaos_fx=None,
                       jittered: bool = False) -> FleetBytes:
    """The :class:`FleetBytes` of a folded fleet whose block is
    ``block_requests`` rows a member.

    Two pilots of ONE member of the fleet's folded chunk
    (``oplog.run_fleet_pilot``: ``Simulator._fleet_chunks`` at one
    member for two blocks, at the pilot sizes of the run's estimate)
    are extrapolated point by point (:func:`pilot_live_bytes`): what the
    member's block loop allocates, its control carries (``control`` =
    ``(tl_plan, policies, rollouts)``, the chunk's folded
    ``_BlockControl``: a protected fleet's laws or an observed fleet's
    recorder), its blame reduction (``blame``: False, None for mean
    blame, or the tail cut) and its physics scales (``jittered``), with
    the previous block's results live beside the next block.  The
    tables the pilots read (the Simulator's, and ``chaos_fx``, the
    fleet's member-stacked chaos rows, whose first row the pilot reads)
    are the fixed part; what the larger pilot's chunk returns is what a
    member keeps live while the other chunks run.  A fixed temporary of
    the block counts once a member, an overestimate.  The pilots are
    recorded once per Simulator and fleet kind (cached on ``sim``) and
    launch the census as the fleet's blocks do."""
    from isotope_tpu_torch.analysis import oplog
    from isotope_tpu_torch.sim.config import CLOSED_LOOP

    closed = load.kind == CLOSED_LOOP
    fx_key = None if chaos_fx is None else tuple(
        None if x is None else (tuple(x.shape[1:]), x.dtype)
        for x in chaos_fx
    )
    blame_key = blame if blame is False or blame is None else "tail"
    key = (load.kind, int(load.connections) if closed else 0,
           None if control is None else (tuple(control[0]),
                                         bool(control[1]),
                                         bool(control[2])),
           blame_key, fx_key, bool(jittered))
    cache = sim._fleet_pilots
    if key not in cache:
        n1 = oplog.pilot_size(load)
        kw = dict(control=control, blame=blame, chaos_fx=chaos_fx,
                  jittered=jittered)
        # a first, unrecorded run builds what the Simulator caches, so
        # both recorded pilots allocate the same sequence
        oplog.run_fleet_pilot(sim, load, n1, record=False, **kw)
        pilots = []
        for n in (n1, 2 * n1):
            log, retained = oplog.run_fleet_pilot(sim, load, n, **kw)
            pilots.append((PilotCurve.of(log), n, retained))
        cache[key] = tuple(pilots)
    (c1, n1, _), (c2, n2, retained) = cache[key]
    return FleetBytes(
        float(max(c1.external_bytes, c2.external_bytes)),
        pilot_live_bytes(c1, n1, c2, n2, block_requests),
        float(retained),
    )


def fleet_chunk(members: int, sizes: FleetBytes,
                capacity_bytes: Optional[float],
                carry_bytes_per_member: float = 0.0) -> int:
    """Members per chunk of a fleet of ``members`` from its
    :class:`FleetBytes` (:func:`ensemble_chunk`: the tables and every
    member's returned rows are fixed, each chunk member takes its
    block loop's high-water and ``carry_bytes_per_member``)."""
    return ensemble_chunk(
        members, sizes.per_member, capacity_bytes,
        carry_bytes_per_member=carry_bytes_per_member,
        fixed_bytes=sizes.fixed + max(int(members), 1) * sizes.retained,
    )


def estimate_run(
    sim,
    block_requests: int,
    log=None,
    trace_requests: int = 8,
    capacity_override: Optional[float] = None,
    slope_log=None,
    slope_requests: Optional[int] = None,
) -> CostEstimate:
    """Estimate one run's per-block cost at ``block_requests``.

    When the op auditor recorded a pilot, its ``log`` (at
    ``trace_requests`` requests) seeds the estimate: its flops scale by
    ``block / trace_requests``.  Its bytes: with a second pilot
    (``slope_log`` at ``slope_requests`` requests) the two-point law of
    :func:`pilot_bytes`; with one, the storages the pilot allocated
    scale by ``block / trace_requests`` and the tables it read count
    once.  Without a pilot the plan table alone gives the (coarser)
    estimate of the reference, to the byte."""
    segments = segment_table(sim, block_requests)
    plan_bytes = sum(r["bytes_f32"] for r in segments)
    oc = None
    if log is not None:
        oc = oplog_cost(log)
        scale = block_requests / max(trace_requests, 1)
        if slope_log is not None:
            peak = pilot_bytes(log, trace_requests, slope_log,
                               int(slope_requests), block_requests)
        else:
            peak = oc.external_bytes + oc.peak_bytes * scale
        flops = oc.flops * scale
        depth = oc.critical_path
    else:
        # plan-only fallback: the live working set is a few event
        # tensors wide, not the sum over all levels
        h = max(sim.compiled.num_hops, 1)
        peak = 10.0 * 4.0 * block_requests * h
        flops = plan_bytes / 4.0  # ~1 flop per touched element
        depth = len(segments)
    # the flight recorder's O(S x W) carries ride next to the event
    # tensors (the plain pilot does not hold them)
    tl_bytes = timeline_bytes(sim)
    return CostEstimate(
        block_requests=int(block_requests),
        trace_requests=int(trace_requests),
        oplog=oc,
        peak_bytes_at_block=float(peak) + tl_bytes,
        flops_at_block=float(flops),
        critical_path=int(depth),
        segments=segments,
        capacity_bytes=device_capacity_bytes(
            capacity_override, device=sim.device
        ),
        timeline_bytes=tl_bytes,
        slope_requests=int(slope_requests or 0) if slope_log is not None
        else 0,
    )


def timeline_findings(estimate: CostEstimate) -> List[Finding]:
    """The VET-M003 info verdict: the recorder's windowed carries take
    more than the configured share of device capacity.  Informational:
    the window planner clamps the window count (widening windows)
    instead of running out of memory."""
    tl = estimate.timeline_bytes
    cap = estimate.capacity_bytes
    if tl <= 0 or cap is None or cap <= 0:
        return []
    share_env = os.environ.get(ENV_TIMELINE_SHARE, "").strip()
    share = float(share_env) if share_env else DEFAULT_TIMELINE_SHARE
    if tl <= share * cap:
        return []
    return [Finding(
        "VET-M003", SEV_INFO,
        f"timeline recorder carries {tl:.3g} B exceed "
        f"{share:.0%} of the {cap:.3g} B device capacity; the window "
        "planner will clamp the window count (widening windows) — "
        "lower SimParams.timeline_max_windows or widen "
        "timeline_window_s to silence",
    )]


def fleet_need(estimate: CostEstimate, members: int, carry: float,
                member_bytes) -> Tuple[float, int]:
    """``(bytes, auto chunk)`` of a fleet of ``members``: the reference's
    ``members x (peak + carry)`` on the estimate, or with
    ``member_bytes`` (:func:`fleet_member_bytes`, whose per-member part
    holds the control and observability carries) ``fixed + members x
    (per member + carry)``, the engine's own chunk law."""
    cap = estimate.capacity_bytes
    if member_bytes is None:
        peak = estimate.peak_bytes_at_block
        return members * (peak + carry), ensemble_chunk(
            members, peak, cap, carry_bytes_per_member=carry)
    return (member_bytes.fixed
            + members * (member_bytes.per_member + carry)), fleet_chunk(
        members, member_bytes, cap, carry_bytes_per_member=carry)


def ensemble_findings(
    estimate: CostEstimate,
    members: int,
    member_bytes: Optional[FleetBytes] = None,
) -> List[Finding]:
    """The VET-M004 verdict: a fleet whose ``members x peak-bytes``
    exceeds the device budget — WARN, never blocking: the engine splits
    the fleet into member chunks instead of running out of memory.
    ``member_bytes``: the folded pilot's sizes (:func:`fleet_need`)."""
    cap = estimate.capacity_bytes
    members = int(members)
    if members <= 1 or cap is None or cap <= 0:
        return []
    budget = CAPACITY_FILL * cap
    need, chunk = fleet_need(estimate, members, 0.0, member_bytes)
    if need <= budget:
        return []
    return [Finding(
        "VET-M004", SEV_WARN,
        f"ensemble of {members} members needs {need:.3g} B "
        f"(> the {budget:.3g} B budget, {CAPACITY_FILL:.0%} of "
        f"{cap:.3g} B capacity); the fleet will run in member chunks "
        f"of {chunk} — shrink the block or the fleet to run it in "
        "one dispatch",
    )]


def protected_ensemble_findings(
    estimate: CostEstimate,
    members: int,
    carry_bytes: float,
    member_bytes: Optional[FleetBytes] = None,
) -> List[Finding]:
    """The VET-T025 verdict: a protected fleet whose members' event
    tensors plus control carries (:func:`protected_carry_bytes`) exceed
    the device budget.  WARN, never blocking.  ``member_bytes``: the
    protected folded pilot's sizes, which hold the carries."""
    cap = estimate.capacity_bytes
    members = int(members)
    if members <= 1 or cap is None or cap <= 0:
        return []
    budget = CAPACITY_FILL * cap
    need, chunk = fleet_need(
        estimate, members,
        max(carry_bytes, 0.0) if member_bytes is None else 0.0,
        member_bytes,
    )
    if need <= budget:
        return []
    return [Finding(
        "VET-T025", SEV_WARN,
        f"protected fleet of {members} members needs {need:.3g} B "
        f"including {carry_bytes:.3g} B/member of stacked control "
        f"carry (> the {budget:.3g} B budget); the fleet will run in "
        f"member chunks of {chunk} — shrink the block, the window "
        "count, or the fleet to run it in one dispatch",
    )]


def observed_ensemble_findings(
    estimate: CostEstimate,
    members: int,
    obs_carry_bytes: float,
    base_carry_bytes: float = 0.0,
    member_bytes: Optional[FleetBytes] = None,
) -> List[Finding]:
    """The VET-M006 verdict: an observed fleet (attribution and/or
    timeline per member) whose members' event tensors plus
    observability carries (:func:`observability_carry_bytes`) exceed
    the device budget.  WARN, never blocking.  ``member_bytes``: the
    observed folded pilot's sizes, which hold the carries."""
    cap = estimate.capacity_bytes
    members = int(members)
    obs = max(float(obs_carry_bytes), 0.0)
    if members <= 1 or cap is None or cap <= 0 or obs <= 0:
        return []
    carry = obs + max(float(base_carry_bytes), 0.0)
    budget = CAPACITY_FILL * cap
    need, chunk = fleet_need(
        estimate, members, carry if member_bytes is None else 0.0,
        member_bytes,
    )
    if need <= budget:
        return []
    return [Finding(
        "VET-M006", SEV_WARN,
        f"observed fleet of {members} members needs {need:.3g} B "
        f"including {obs:.3g} B/member of stacked blame/timeline "
        f"carry (> the {budget:.3g} B budget); the fleet will run in "
        f"member chunks of {chunk} — shrink the block, the window "
        "count, or the fleet, or drop attribution/timeline, to run "
        "it in one dispatch",
    )]


def search_findings(
    estimate: CostEstimate,
    widest_members: int,
    connections: int = 0,
    member_bytes: Optional[FleetBytes] = None,
) -> List[Finding]:
    """The VET-M005 verdict: a search bracket whose widest rung's
    ``members x (peak + carry)-bytes`` exceeds the device budget.  WARN,
    never blocking: narrower rungs inherit smaller footprints.
    ``member_bytes``: the folded pilot's sizes (:func:`fleet_need`)."""
    cap = estimate.capacity_bytes
    members = int(widest_members)
    if members <= 1 or cap is None or cap <= 0:
        return []
    budget = CAPACITY_FILL * cap
    need, chunk = fleet_need(estimate, members,
                              search_carry_bytes(connections), member_bytes)
    if need <= budget:
        return []
    return [Finding(
        "VET-M005", SEV_WARN,
        f"search bracket's widest rung of {members} candidates needs "
        f"{need:.3g} B (> the {budget:.3g} B budget, "
        f"{CAPACITY_FILL:.0%} of {cap:.3g} B capacity); the rung will "
        f"run in member chunks of {chunk} — shrink the block or the "
        "population to run each rung in one dispatch",
    )]


def memory_findings(
    estimate: CostEstimate,
    rung_names: Sequence[str] = RUNG_NAMES,
) -> Tuple[List[Finding], int]:
    """The VET-M verdict: findings plus the recommended start rung.

    The half-block rung halves the live event-tensor footprint.  Every
    rung of the port's ladder runs on the Simulator's device, so when
    even half a block does not fit no rung can serve the case: VET-M001
    (an error the gate blocks on, ladder or not) with the start rung
    ``len(rung_names)``, past the ladder.  Unknown capacity (the CPU,
    no override) recommends rung 0 and reports nothing."""
    cap = estimate.capacity_bytes
    if cap is None or cap <= 0:
        return [], 0
    budget = CAPACITY_FILL * cap
    peak = estimate.peak_bytes_at_block
    if peak <= budget:
        return [], 0
    half = peak / 2.0
    last = len(rung_names) - 1
    if half <= budget and last >= 1:
        return [Finding(
            "VET-M002", SEV_WARN,
            f"estimated peak {peak:.3g} B exceeds the "
            f"{budget:.3g} B budget ({CAPACITY_FILL:.0%} of "
            f"{cap:.3g} B capacity); start the ladder at "
            f"{rung_names[1]!r}",
        )], 1
    rungs = ", ".join(repr(r) for r in rung_names)
    return [Finding(
        "VET-M001", SEV_ERROR,
        f"estimated peak {peak:.3g} B exceeds the {budget:.3g} B "
        f"budget even at half-block ({half:.3g} B): no rung of the "
        f"ladder ({rungs}) fits on the device — shard over a mesh or "
        "shrink the block",
    )], len(rung_names)
