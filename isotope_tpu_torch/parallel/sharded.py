"""Sharded simulation over a device mesh, with collective-merged metrics.

The port of ``isotope_tpu.parallel.sharded`` but ``--mesh auto``: the
plain run (with the collective/compute overlap), the attributed, the
recorded and the protected runs, the fleets, the search brackets, and
the emulated twin of each.  One process per device (a
``torch.distributed`` rank); global rank ``r`` is shard ``r``
(``parallel/mesh.py``).  Every shard simulates a disjoint slice of the
request stream in memory-bounded blocks — the Simulator's own block loop
(``Simulator.run_blocks(shards=)``), whose arrivals are paced at
``offered / n_shards`` — under the draws of ``RootedSource(source,
500_000 + shard)``, then the block summaries merge with collectives:

- scalar counters and the fine latency histogram: summed over the
  in-host axes (``data``, then ``svc``), then over ``slice``;
- the extremes: MAX over the same axes (a minimum rides as a negated
  maximum: negation is exact);
- per-service duration / response-size histograms: summed over
  ``data``, padded to ``s_pad`` rows, reduce-scattered over ``svc``,
  then summed over ``slice`` on the 1/svc tiles (the cross-host axis
  carries 1/svc of the per-service payload); the tiles are gathered at
  the entry point's boundary, so every rank returns the same global
  ``(s_pad, ...)`` arrays;
- the Chan/Welford second moment: each shard's centered term against
  the merged mean, summed, in the reference's float32 steps.

There is no cross-device traffic during the event sweeps: the hop
program is replicated and requests are independent given the analytic
queue model, so the only communication is the metric reduction.

``SimParams.overlap=True`` pipelines the merge one block behind the
compute: block *k*'s merge is issued at the top of step *k+1* (on the
card, on a side stream, as ``async_op=True`` collectives waited there)
and waited before the cheap ``summary_accumulate`` fold, so it hides
behind the next block's sweep; the last merge comes after the loop.

The ranks agree on failure: after the local scan (in the overlap loop,
through a status slot of each block's MAX reduction) and again after the
``sharded.gather`` fault site, every rank all-reduces (MAX) a status
code, and when any rank failed every rank raises an error of the same
recovery class (its own, or :class:`MeshFault`), so each rank's
``run_ladder`` takes the same next rung.  A protected run's per-block
merges carry the status too: a rank whose block fails joins the next
merge with zero observations and its code, and every rank raises there.

Fleets (plain, jittered, chaos, closed, observed and protected) and
the search brackets' rungs spread the MEMBER axis instead: members are
whole runs, ``per_shard = ceil(M / n_shards)`` of them a rank in
balanced rounds of the chunk law's width (chunk ``c = r * n_shards + s``
of round r is shard s's), each rank folds its chunks through the
Simulator's own fleet, and the member stacks are all-gathered into
member order — no sum, so every rank and the twin hold the same bits.

A protected run (``run_policies`` / ``run_rollouts``, ``svc = 1``)
shards the request stream like the plain run, under SHARED control
state: each block's observations (the recorder's block, the retry and
rollout observation channels) are all-gathered and summed in the
twin's shard order before the laws advance (:meth:`ShardedSimulator.
merge_observations`, through ``_BlockControl``'s merge hook), and
``t_done`` is the mesh's minimum, so every rank actuates the same
breakers, autoscaler and canary; its twin steps every shard's loop in
lockstep, block by block.

An :class:`~isotope_tpu_torch.parallel.mesh.EmulatedMesh` (and the
ladder's ``single-device`` rung on a real mesh) replays every shard
serially on the Simulator's own device and merges on the host in shard
order, slice by slice (``_merge_shard_summaries``): peak memory is one
shard's.  Gloo's and NCCL's sums do not keep that order, so between the
device path and the twin the integer-valued fields and the extremes are
exact and the float sums agree within ``n_shards`` float32 spacings.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.compiler.program import CompiledGraph
from isotope_tpu_torch.metrics.prometheus import (
    MetricsCollector,
    ServiceMetrics,
)
from isotope_tpu_torch.parallel.mesh import (
    SLICE_AXIS,
    SVC_AXIS,
    EmulatedMesh,
    mesh_axes,
)
from isotope_tpu_torch.resilience import faults
from isotope_tpu_torch.resilience.taxonomy import (
    DETERMINISTIC,
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    classify,
)
from isotope_tpu_torch.sim.config import OPEN_LOOP, LoadModel, SimParams
from isotope_tpu_torch.sim.draws import SHARD_INDEX_BASE, RootedSource
from isotope_tpu_torch.sim.engine import Simulator, _BlockControl, drain
from isotope_tpu_torch.sim.summary import (
    RunSummary,
    summarize,
    summary_accumulate,
    zeros_summary,
)

F32 = torch.float32

# the sharded path returns the same summary type the solo path produces
ShardedSummary = RunSummary

#: status codes of the ranks' failure agreement, by recovery class: the
#: MAX over the ranks picks the most severe
_CODES = {TRANSIENT: 1, RESOURCE_EXHAUSTED: 2, DETERMINISTIC: 3}
_CLASSES = {v: k for k, v in _CODES.items()}


class MeshFault(RuntimeError):
    """Another rank of the mesh failed: raised on the ranks that did not,
    with the failing rank's recovery class, so every rank's supervisor
    takes the same next step."""

    def __init__(self, message: str, fault_class: str):
        super().__init__(message)
        self.fault_class = fault_class


class _RunPlan(NamedTuple):
    """Everything a run's physical execution shape depends on — shared
    between the collective path and the emulated twin, so the
    degradation ladder reproduces the exact same request streams (the
    shard's block loop derives its pacing and connections from the
    load, ``Simulator.run_blocks(shards=)``)."""

    offered: float
    block: int
    num_blocks: int
    window: Tuple[float, float]
    saturated: bool
    trim: bool


def _dist():
    import torch.distributed as dist

    return dist


def _quiet(fn, *args, **kwargs):
    """A collective whose name newer torch releases deprecate in favour
    of one older releases lack (``reduce_scatter_tensor``,
    ``all_gather_into_tensor``): called without the warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _leaves(tree):
    """The tensors of a (nested) NamedTuple of tensors / None."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


def _on_device(tree, device):
    """A NamedTuple of numpy arrays (the host merges) as tensors."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_on_device(x, device) for x in tree))
    return torch.as_tensor(np.asarray(tree)).to(device)


class ShardedSimulator:
    """Runs a compiled graph data-parallel over a mesh."""

    def __init__(
        self,
        compiled: CompiledGraph,
        mesh,  # DeviceMesh | EmulatedMesh
        params: SimParams = SimParams(),
        chaos=(),
        churn=(),
        mtls=None,
        policies=None,  # Optional[sim.policies.PolicyTables]
        rollouts=None,  # Optional[sim.rollout.RolloutTables]
        lb=None,  # Optional[sim.lb.LbTables]
        *,
        sim: Optional[Simulator] = None,
        device=None,
    ):
        """``sim`` reuses an existing Simulator of ``compiled`` (the
        runner's); ``device`` places an :class:`EmulatedMesh`'s twin
        (the card by default); a ``DeviceMesh`` runs on its rank's
        device."""
        self.compiled = compiled
        self.mesh = mesh
        # an EmulatedMesh carries a mesh SHAPE with no ranks: every
        # *_emulated twin replays it shard by shard on one device; the
        # collective entry points raise instead
        self.emulated = isinstance(mesh, EmulatedMesh)
        names, shape = mesh_axes(mesh)
        if SVC_AXIS not in names:
            raise ValueError(
                f"mesh must carry a {SVC_AXIS!r} axis; got {names}"
            )
        if not self.emulated:
            device = (
                torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else torch.device("cpu")
            )
        # lb laws ride _simulate_core's per-station wait selection, so
        # the collective path and the twin stay equal with no extra
        # collectives
        self.sim = sim if sim is not None else Simulator(
            compiled, params, chaos, churn, mtls=mtls, policies=policies,
            rollouts=rollouts, lb=lb, device=device,
        )
        self.device = self.sim.device
        self.collector = MetricsCollector(compiled)
        self.axis_names = names
        self.shape = shape
        # every non-svc axis shards the request stream: (data,) on one
        # slice, (slice, data) across slices — only the O(buckets)
        # summary reduction ever crosses the slice axis
        self.request_axes = tuple(a for a in names if a != SVC_AXIS)
        # merge order: the in-host axes first, the slice axis last —
        # and on the per-service state only AFTER the svc
        # reduce-scatter
        self.dcn_axes = tuple(a for a in names if a == SLICE_AXIS)
        self.ici_axes = tuple(a for a in names if a != SLICE_AXIS)
        self.ici_request_axes = tuple(
            a for a in self.request_axes if a != SLICE_AXIS
        )
        self.n_svc = shape[SVC_AXIS]
        self.n_shards = int(np.prod([shape[a] for a in names]))
        # services padded so the reduce-scatter tiles the svc axis
        s = compiled.num_services
        self.s_pad = -(-s // self.n_svc) * self.n_svc
        self.shard = 0
        self._groups = {}
        if not self.emulated:
            # global rank = row-major shard index over the axis names
            coord = mesh.get_coordinate()
            for a, c in zip(names, coord):
                self.shard = self.shard * shape[a] + int(c)
            self._groups = {
                a: mesh.get_group(a) for a in names if shape[a] > 1
            }

    # -- entry points ---------------------------------------------------

    def run(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        offered_qps=None,
        block_size: int = 65_536,
        trim: bool = False,
    ) -> RunSummary:
        """Simulate >= ``num_requests`` (rounded up to fill all shards),
        in blocks of at most ``block_size`` requests per shard, with
        draws from ``source`` (shard ``r`` under ``RootedSource(source,
        500_000 + r)``); every rank returns the same global summary.

        For closed-loop load the offered rate is latency-dependent; pass
        ``offered_qps`` (e.g. from a prior solo run of the same load) to
        skip the pilot fixed point.  ``trim=True`` accumulates the
        collector's steady-state window into the summary's ``win_*``
        fields (see Simulator.run_summary).
        """
        overlap = self.sim.params.overlap
        return self._collective_run(
            "run", load, num_requests, source, offered_qps, block_size,
            trim,
            scan=None if overlap else (
                lambda plan: self._local_scan(load, plan, self.shard,
                                              source)
            ),
            merge=lambda local: self._gather_svc(
                self._merge_summary_collective(local)[0]
            ),
            overlap=overlap,
        )

    def run_emulated(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        offered_qps=None,
        block_size: int = 65_536,
        trim: bool = False,
    ) -> RunSummary:
        """The sharded program replayed shard by shard on one device.

        Two jobs share this path:

        - the degradation ladder's ``single-device`` rung: each shard's
          block loop — the same draws and blocking as the collective
          path — runs serially on the rank's own device, and the
          collectives are replayed on the host.  Peak live memory is
          one shard's event tensors instead of the whole mesh's;
        - the **emulated multi-host twin**: built over an
          :class:`~isotope_tpu_torch.parallel.mesh.EmulatedMesh`, the
          same loop replays ANY host count on one device.

        The host merge always replays the overlap=off reduction order
        (blocks within a shard, then shards).
        """
        def body():
            plan = self._plan_run(load, num_requests, source,
                                  offered_qps, block_size, trim)
            telemetry.counter_inc("sharded_emulated_runs")
            telemetry.gauge_set("shard_count", self.n_shards)
            self._args_put(plan)
            shards = self._each_shard(
                lambda s: self._local_scan(load, plan, s, source)
            )
            return self._merge_shard_summaries(shards)

        return self._agreed(body, "sharded.emulated")

    def run_attributed(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        offered_qps=None,
        block_size: int = 65_536,
        trim: bool = False,
        tail: bool = False,
        tail_cut=None,
    ):
        """Sharded twin of :meth:`Simulator.run_attributed`: every shard
        reduces its block loop to (RunSummary, AttributionSummary) and
        the blame accumulators merge with a sum (``tail_cut`` held out),
        the exemplars with an all-gather and the global top-K (every
        rank returns the same).  The tail cut is estimated once, before
        any shard.  Returns ``(RunSummary, AttributionSummary)``."""
        self._require_attribution()
        self._require_mesh("run_attributed")
        cut = [tail_cut]

        def prepare():
            if tail and cut[0] is None:
                cut[0] = self.sim.estimate_tail_cut(
                    load, num_requests, source, block_size=block_size
                )

        def merge(local):
            summary, attr = local
            merged = self._gather_svc(
                self._merge_summary_collective(summary)[0]
            )
            return merged, self._merge_attribution(attr)

        return self._collective_run(
            "run_attributed", load, num_requests, source, offered_qps,
            block_size, trim,
            scan=lambda plan: self._local_scan(
                load, plan, self.shard, source, attr=True,
                tail_cut=cut[0] if tail else None,
            ),
            merge=merge, prepare=prepare,
        )

    def run_attributed_emulated(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        offered_qps=None,
        block_size: int = 65_536,
        trim: bool = False,
        tail: bool = False,
        tail_cut=None,
    ):
        """The attributed mesh program replayed shard by shard on one
        device, the collectives merged on the host (shard-order sums,
        the host top-K exemplar merge) — the degradation rung and
        equivalence reference of :meth:`run_attributed`."""
        from isotope_tpu_torch.metrics import attribution

        self._require_attribution()

        def body():
            cut = tail_cut
            if tail and cut is None:
                cut = self.sim.estimate_tail_cut(
                    load, num_requests, source, block_size=block_size
                )
            plan = self._plan_run(load, num_requests, source,
                                  offered_qps, block_size, trim)
            self._args_put(plan)
            shards = self._each_shard(lambda s: self._local_scan(
                load, plan, s, source, attr=True,
                tail_cut=cut if tail else None,
            ))
            summary = self._merge_shard_summaries([s for s, _ in shards])
            return summary, _on_device(
                attribution.merge_host([a for _, a in shards]),
                self.device,
            )

        return self._agreed(body, "sharded.emulated")

    def run_timeline(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        offered_qps=None,
        block_size: int = 65_536,
        trim: bool = False,
        window_s=None,
    ):
        """Sharded twin of :meth:`Simulator.run_timeline`: every shard
        reduces its block loop to (RunSummary, TimelineSummary) and the
        timeline leaves merge with a sum (``window_s`` held out) —
        windows align because all shards share the absolute sim-time
        axis.  Returns ``(RunSummary, TimelineSummary)``."""
        self._require_timeline()
        self._require_mesh("run_timeline")

        def merge(local):
            summary, tl = local
            merged = self._gather_svc(
                self._merge_summary_collective(summary)[0]
            )
            return merged, self._merge_timeline(tl)

        return self._collective_run(
            "run_timeline", load, num_requests, source, offered_qps,
            block_size, trim,
            scan=lambda plan: self._local_scan(
                load, plan, self.shard, source,
                tl_plan=self._timeline_plan(plan, window_s),
            ),
            merge=merge,
        )

    def run_timeline_emulated(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        offered_qps=None,
        block_size: int = 65_536,
        trim: bool = False,
        window_s=None,
    ):
        """The timeline mesh program replayed shard by shard on one
        device, the sum merged on the host (shard-order sums) — the
        degradation rung and equivalence reference of
        :meth:`run_timeline`."""
        from isotope_tpu_torch.metrics import timeline as timeline_mod

        self._require_timeline()

        def body():
            plan = self._plan_run(load, num_requests, source,
                                  offered_qps, block_size, trim)
            tl_plan = self._timeline_plan(plan, window_s)
            self._args_put(plan)
            shards = self._each_shard(lambda s: self._local_scan(
                load, plan, s, source, tl_plan=tl_plan,
            ))
            summary = self._merge_shard_summaries([s for s, _ in shards])
            return summary, _on_device(
                timeline_mod.merge_host([t for _, t in shards]),
                self.device,
            )

        return self._agreed(body, "sharded.emulated")

    # -- fleets (sim/ensemble.py) ----------------------------------------

    def run_ensemble(self, load: LoadModel, num_requests: int, source,
                     spec=None, *, chunk: Optional[int] = None, **kw):
        """The Monte Carlo fleet over the mesh: members are whole runs,
        so the mesh spreads the member axis and splits no request
        stream.  Each rank runs its members through the Simulator's own
        fleet (folded chunks on the card, :meth:`Simulator.
        _fleet_members`) and the member stacks are gathered into member
        order; every rank returns the same
        :class:`~isotope_tpu_torch.sim.ensemble.EnsembleSummary`, bit
        for bit equal to :meth:`run_ensemble_emulated` and to the solo
        fleet run at ``chunk=`` this fleet's ``chunk``.

        ``per_shard = ceil(M / n_shards)`` members ride each rank, in
        balanced rounds of ``width`` (the chunk law at ``per_shard``
        members, ``chunk`` or ``spec.chunk``): round r's chunk of shard
        s holds the members ``[c * width, (c + 1) * width)``, ``c = r *
        n_shards + s``.  Keywords as :meth:`Simulator.run_ensemble`'s
        (no carry export); an attributed fleet's tail pilot runs once,
        on the fleet's source."""
        return self._fleet_collective("run_ensemble", chunk, lambda: (
            self.sim._plan_fleet(load, num_requests, source, spec, **kw)
        ))

    def run_ensemble_emulated(self, load: LoadModel, num_requests: int,
                              source, spec=None, *,
                              chunk: Optional[int] = None, **kw):
        """The mesh fleet's twin on one device: the same member chunks,
        walked in (round, shard) order, i.e. member order — bit for bit
        :meth:`run_ensemble` (no collective touches a member).  The
        fleet's degradation rung and the laptop twin of a mesh."""
        return self._fleet_emulated(lambda: self.sim._plan_fleet(
            load, num_requests, source, spec, **kw
        ), chunk)

    def run_policies_ensemble(self, load: LoadModel, num_requests: int,
                              source, spec=None, **kw):
        """A fleet of :meth:`Simulator.run_policies` runs over the mesh,
        members spread and gathered as :meth:`run_ensemble`'s (each
        rank's chunks fold their members' control laws,
        :meth:`Simulator._protected_chunks`); no collective crosses
        members and any mesh serves it.  Keywords as
        :meth:`Simulator.run_policies_ensemble`'s (no carry export)."""
        self._require_protected_fleet(load, False)
        return self._protected_fleet(load, num_requests, source, spec,
                                     False, kw, emulated=False)

    def run_rollouts_ensemble(self, load: LoadModel, num_requests: int,
                              source, spec=None, **kw):
        """A fleet of :meth:`Simulator.run_rollouts` runs over the mesh
        (:meth:`run_policies_ensemble`)."""
        self._require_protected_fleet(load, True)
        return self._protected_fleet(load, num_requests, source, spec,
                                     True, kw, emulated=False)

    def run_policies_ensemble_emulated(self, load: LoadModel,
                                       num_requests: int, source,
                                       spec=None, **kw):
        """:meth:`run_policies_ensemble`'s twin on one device."""
        self._require_protected_fleet(load, False)
        return self._protected_fleet(load, num_requests, source, spec,
                                     False, kw, emulated=True)

    def run_rollouts_ensemble_emulated(self, load: LoadModel,
                                       num_requests: int, source,
                                       spec=None, **kw):
        """:meth:`run_rollouts_ensemble`'s twin on one device."""
        self._require_protected_fleet(load, True)
        return self._protected_fleet(load, num_requests, source, spec,
                                     True, kw, emulated=True)

    def _protected_fleet(self, load, num_requests, source, spec, roll,
                         kw, emulated: bool):
        kw = dict(kw)
        chunk = kw.pop("chunk", None)

        def plan():
            return self.sim._plan_protected_fleet(
                load, num_requests, source, spec, roll=roll, **kw
            )

        if emulated:
            return self._fleet_emulated(plan, chunk)
        return self._fleet_collective(
            "run_rollouts_ensemble" if roll else "run_policies_ensemble",
            chunk, plan,
        )

    def fleet_geometry(self, members: int, cap: int) -> Tuple[int, int]:
        """``(width, rounds)`` of ``members`` spread over the mesh under
        a chunk ``cap``: ``per_shard = ceil(members / n_shards)``, cut
        into balanced rounds of at most ``cap`` members."""
        per_shard = -(-members // self.n_shards)
        width = max(1, min(int(cap), per_shard))
        rounds = -(-per_shard // width)
        return -(-per_shard // rounds), rounds

    def shard_members(self, members: int, width: int, rounds: int,
                      shard: int) -> list:
        """The member rows of ``shard``: its chunk of every round
        (chunk ``c = r * n_shards + shard`` holds ``[c * width, (c + 1)
        * width)``, cut at ``members``)."""
        rows = []
        for r in range(rounds):
            c = r * self.n_shards + shard
            rows.extend(range(min(c * width, members),
                              min((c + 1) * width, members)))
        return rows

    def _fleet_plan_geometry(self, plan, chunk):
        fp = plan()
        n_mem = fp.spec.members
        cap, sizes = self.sim._fleet_chunk(fp, -(-n_mem // self.n_shards),
                                           chunk)
        width, rounds = self.fleet_geometry(n_mem, cap)
        telemetry.gauge_set("ensemble_members", n_mem)
        telemetry.gauge_set("ensemble_members_per_shard", width)
        telemetry.gauge_set("ensemble_rounds", rounds)
        return fp, width, rounds, sizes

    def _fleet_collective(self, what: str, chunk, plan):
        """Plan a fleet (``plan()``), run this rank's members, agree,
        gather the member stacks into member order, agree again."""
        self._require_mesh(what)
        err = local = None
        try:
            fp, width, rounds, sizes = self._fleet_plan_geometry(plan,
                                                                 chunk)
            telemetry.counter_inc("sharded_ensemble_runs")
            faults.check("sharded.compute")
            if self.dcn_axes:
                faults.check("sharded.dcn_collective")
            n_mem = fp.spec.members
            rows = self.shard_members(n_mem, width, rounds, self.shard)
            # a rank with no member runs member 0 as a pad, so its part
            # of the gather has the fleet's layout; the pad is dropped
            local = self.sim._fleet_members(fp, rows or [0], width)
        except Exception as e:
            err = e
        self._agree(err, "sharded.compute")
        cols = self.gather_members(local, [
            self.shard_members(n_mem, width, rounds, s)
            for s in range(self.n_shards)
        ], rounds * width)
        self._gather_check()
        return self.sim._fleet_result(fp, cols, width, sizes)

    def _fleet_emulated(self, plan, chunk):
        def body():
            fp, width, _, sizes = self._fleet_plan_geometry(plan, chunk)
            telemetry.counter_inc("sharded_ensemble_emulated_runs")
            with telemetry.phase("sharded.emulated"):
                # the contiguous width-chunks of every (round, shard), in
                # member order: the ranks' chunks, one after another
                cols = self.sim._fleet_members(
                    fp, range(fp.spec.members), width
                )
            return self.sim._fleet_result(fp, cols, width, sizes)

        return self._agreed(body, "sharded.emulated")

    def gather_members(self, tree, shard_rows, rows: int):
        """Every rank's member-stacked ``tree`` (its rows
        ``shard_rows[shard]``, at least one row) gathered into member
        order: each rank pads its stack to ``rows`` rows, one
        ``all_gather`` a dtype, then a row index puts member m where it
        belongs.  The gathered leaves are the ranks' bits."""
        from isotope_tpu_torch.sim.ensemble import tree_map

        dist = _dist()
        leaves = []

        def collect(x):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"a member stack holds a {type(x)!r}")
            leaves.append(x)
            return len(leaves) - 1

        skeleton = tree_map(collect, tree)
        n_mem = sum(len(r) for r in shard_rows)
        order = torch.empty(n_mem, dtype=torch.int64)
        for s, r in enumerate(shard_rows):
            order[torch.tensor(r, dtype=torch.int64)] = (
                s * rows + torch.arange(len(r), dtype=torch.int64)
            )
        order = order.to(self.device)
        k = len(shard_rows[self.shard])
        out = list(leaves)
        by_dtype = {}
        for i, x in enumerate(leaves):
            by_dtype.setdefault(x.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            wire = torch.uint8 if dtype == torch.bool else dtype
            cols = [
                leaves[i][:k].reshape(
                    k, int(np.prod(leaves[i].shape[1:]))
                ).to(wire)
                for i in idx
            ]
            width = sum(c.shape[1] for c in cols)
            buf = torch.zeros((rows, width), dtype=wire, device=self.device)
            if k:
                buf[:k] = torch.cat(cols, 1)
            full = buf.new_empty((self.n_shards * rows, width))
            if self.n_shards > 1:
                _quiet(dist.all_gather_into_tensor, full, buf)
            else:
                full = buf
            full = full.index_select(0, order)
            off = 0
            for i, c in zip(idx, cols):
                w = c.shape[1]
                out[i] = full[:, off:off + w].reshape(
                    (n_mem,) + tuple(leaves[i].shape[1:])
                ).to(dtype)
                off += w
        return tree_map(lambda i: out[i], skeleton)

    def _gather_check(self) -> None:
        """The ``sharded.gather`` fault site, agreed by every rank."""
        err = None
        try:
            faults.check("sharded.gather")
        except Exception as e:
            err = e
        self._agree(err, "sharded.gather")

    # -- search brackets (sim/search.py) --------------------------------

    def run_search(self, load: LoadModel, num_requests: int, source, spec,
                   *, block_size: int = 65_536,
                   chunk: Optional[int] = None):
        """The successive-halving bracket over the mesh
        (:func:`~isotope_tpu_torch.sim.search.run_search_sharded`): each
        rung's fleet spreads its candidates as :meth:`run_ensemble`'s
        members, their summaries and carries gathered; every rank ranks
        the gathered rung identically, so the lineage is
        :meth:`run_search_emulated`'s bit for bit."""
        from isotope_tpu_torch.sim import search as search_mod

        self._require_mesh("run_search")
        return search_mod.run_search_sharded(
            self, load, num_requests, source, spec,
            block_size=block_size, chunk=chunk,
        )

    def run_search_emulated(self, load: LoadModel, num_requests: int,
                            source, spec, *, block_size: int = 65_536,
                            chunk: Optional[int] = None):
        """The mesh bracket's twin on one device: the same rung
        geometry, the chunks walked in member order."""
        from isotope_tpu_torch.sim import search as search_mod

        return search_mod.run_search_emulated(
            self, load, num_requests, source, spec,
            block_size=block_size, chunk=chunk,
        )

    # -- protected runs (sim/policies.py, sim/rollout.py) ---------------

    def run_policies(self, load: LoadModel, num_requests: int, source,
                     offered_qps=None, block_size: int = 65_536,
                     trim: bool = False, window_s=None,
                     attribution: bool = False, tail: bool = False,
                     tail_cut=None):
        """Sharded twin of :meth:`Simulator.run_policies`: every shard
        runs its slice of the request stream under the SHARED policy
        state.  Each block's observations (the recorder's block, the
        (S, W) retry observations) are all-gathered and summed in the
        twin's shard order before the laws advance, and ``t_done`` is
        the mesh's minimum, so every rank actuates the same breaker and
        HPA trajectory, bit for bit :meth:`run_policies_emulated`'s.
        Returns ``(RunSummary, TimelineSummary, PolicySummary[,
        AttributionSummary])``; the summary (and the blame) merge with
        the plain run's collectives.  Needs a mesh with ``svc = 1``."""
        self._require_protected(load, False)
        self._require_mesh("run_policies")
        return self._protected_run(
            False, load, num_requests, source, offered_qps, block_size,
            trim, window_s, attribution, tail, tail_cut,
        )

    def run_rollouts(self, load: LoadModel, num_requests: int, source,
                     offered_qps=None, block_size: int = 65_536,
                     trim: bool = False, window_s=None,
                     attribution: bool = False, tail: bool = False,
                     tail_cut=None):
        """Sharded twin of :meth:`Simulator.run_rollouts`, as
        :meth:`run_policies` with the (S, 2, W, 4) rollout observations
        merged too.  Returns ``(RunSummary, TimelineSummary,
        RolloutSummary[, PolicySummary][, AttributionSummary])``."""
        self._require_protected(load, True)
        self._require_mesh("run_rollouts")
        return self._protected_run(
            True, load, num_requests, source, offered_qps, block_size,
            trim, window_s, attribution, tail, tail_cut,
        )

    def run_policies_emulated(self, load: LoadModel, num_requests: int,
                              source, offered_qps=None,
                              block_size: int = 65_536, trim: bool = False,
                              window_s=None, attribution: bool = False,
                              tail: bool = False, tail_cut=None):
        """The policy mesh program on one device: unlike the other
        twins, which run one whole shard after another, the control
        laws couple the shards every block, so every shard's loop steps
        in lockstep, block by block, and the shards' observations merge
        in shard order (each slice's shards, then the slice partials)
        before the shared laws advance once."""
        self._require_protected(load, False)
        return self._protected_emulated(
            False, load, num_requests, source, offered_qps, block_size,
            trim, window_s, attribution, tail, tail_cut,
        )

    def run_rollouts_emulated(self, load: LoadModel, num_requests: int,
                              source, offered_qps=None,
                              block_size: int = 65_536, trim: bool = False,
                              window_s=None, attribution: bool = False,
                              tail: bool = False, tail_cut=None):
        """The rollout mesh program on one device
        (:meth:`run_policies_emulated`)."""
        self._require_protected(load, True)
        return self._protected_emulated(
            True, load, num_requests, source, offered_qps, block_size,
            trim, window_s, attribution, tail, tail_cut,
        )

    def _protected_prologue(self, load, num_requests, source, offered_qps,
                            block_size, trim, window_s, attribution, tail,
                            tail_cut, counter: str):
        """Shared by the collective run and the twin: the attribution
        precondition, the tail cut (one pilot on the run's source), the
        plan and its window grid, the policy fault sites.  Returns
        ``(plan, tl_plan, tail cut or None)``."""
        if attribution and not self.sim.params.attribution:
            raise ValueError(
                "attributed protected runs need SimParams("
                "attribution=True)"
            )
        if attribution and tail and tail_cut is None:
            tail_cut = self.sim.estimate_tail_cut(
                load, num_requests, source, block_size=block_size
            )
        plan = self._plan_run(load, num_requests, source, offered_qps,
                              block_size, trim)
        tl_plan = self._timeline_plan(plan, window_s)
        telemetry.counter_inc(counter)
        if self.sim._policies is not None:
            faults.check("policies.stuck_breaker")
            faults.check("policies.autoscaler_lag")
        return plan, tl_plan, tail_cut if (attribution and tail) else None

    def _protected_steps(self, load, plan: _RunPlan, shard: int, source,
                         control, attribution: bool, tail_cut):
        """Shard ``shard``'s protected block loop under ``control`` (a
        generator, :meth:`Simulator._summary_steps`)."""
        return self.sim._summary_steps(
            load, plan.num_blocks * plan.block,
            RootedSource(source, SHARD_INDEX_BASE + shard), plan.block,
            self.collector, plan.trim, control, attr=attribution,
            tail_cut=tail_cut,
            plan=(plan.offered, plan.block, plan.num_blocks),
            shards=self.n_shards,
        )

    def _protected_run(self, roll: bool, load, num_requests, source,
                       offered_qps, block_size, trim, window_s,
                       attribution, tail, tail_cut):
        what = "rollout" if roll else "policy"
        merge = _ControlMerge(self)
        err = local = control = None
        try:
            plan, tl_plan, cut = self._protected_prologue(
                load, num_requests, source, offered_qps, block_size, trim,
                window_s, attribution, tail, tail_cut,
                f"sharded_{what}_runs",
            )
            control = _BlockControl(self.sim, tl_plan,
                                    self.sim._policies is not None, roll,
                                    merge=merge)
            merge.arm(control, plan.num_blocks)
            self._args_put(plan)
            faults.check("sharded.compute")
            if self.dcn_axes:
                faults.check("sharded.dcn_collective")
            local = drain(self._protected_steps(
                load, plan, self.shard, source, control, attribution, cut,
            ))
        except Exception as e:
            err = e
            merge.abort(e)
        self._agree(err, "sharded.compute")
        summary, attr = local if attribution else (local, None)
        out = (self._gather_svc(
            self._merge_summary_collective(summary)[0]
        ),) + control.outputs()
        if attribution:
            out = out + (self._merge_attribution(attr),)
        if telemetry.detail_enabled():
            with telemetry.phase("sharded.gather"):
                self._sync()
        self._gather_check()
        return out

    def _protected_emulated(self, roll: bool, load, num_requests, source,
                            offered_qps, block_size, trim, window_s,
                            attribution, tail, tail_cut):
        from isotope_tpu_torch.metrics import attribution as attr_mod

        what = "rollout" if roll else "policy"

        def body():
            plan, tl_plan, cut = self._protected_prologue(
                load, num_requests, source, offered_qps, block_size, trim,
                window_s, attribution, tail, tail_cut,
                f"sharded_{what}_emulated_runs",
            )
            shared = _BlockControl(self.sim, tl_plan,
                                   self.sim._policies is not None, roll)
            self._args_put(plan)
            views = [_ShardControl(shared) for _ in range(self.n_shards)]
            steps = [
                self._protected_steps(load, plan, s, source, views[s],
                                      attribution, cut)
                for s in range(self.n_shards)
            ]
            with telemetry.phase("sharded.emulated"):
                for _ in range(plan.num_blocks):
                    for st in steps:
                        next(st)
                    shared.fold(*self.merge_observations(
                        [v.pending for v in views]
                    ))
                outs = [drain(st) for st in steps]
                self._sync()
            if attribution:
                summaries = [o[0] for o in outs]
            else:
                summaries = outs
            out = (self._merge_shard_summaries(summaries),)
            out = out + shared.outputs()
            if attribution:
                out = out + (_on_device(
                    attr_mod.merge_host([o[1] for o in outs]), self.device,
                ),)
            return out

        return self._agreed(body, "sharded.emulated")

    def merge_observations(self, shards):
        """The merge rule of a protected mesh run: ``shards`` holds
        each shard's ``(observations, t_done)`` of one block (in shard
        order); returns ``(merged observations, t_done)``.  Every leaf
        sums in shard order, each slice's shards first and then the
        slice partials (``window_s`` is kept), and ``t_done`` is the
        minimum.  The collective path gathers the shards' observations
        and applies this same rule, so every rank and the twin fold the
        same bits."""
        obs = [o for o, _ in shards]
        tl = [o[0] for o in obs]
        tl_sum = type(tl[0])(tl[0].window_s, *(
            self._hier([t[i] for t in tl]) for i in range(1, len(tl[0]))
        ))
        robs = None if obs[0][1] is None else self._hier([o[1] for o in obs])
        pobs = None if obs[0][2] is None else self._hier([o[2] for o in obs])
        t_done = torch.stack([t for _, t in shards]).amin()
        return (tl_sum, robs, pobs), t_done

    def _hier(self, vals):
        """``vals`` (one a shard, in shard order) summed sequentially
        at their own dtype, each slice's shards first, then the slice
        partials: the emulated twin's association."""
        n_slices = self.shape.get(SLICE_AXIS, 1)
        per_slice = len(vals) // n_slices

        def seq(vs):
            acc = vs[0]
            for v in vs[1:]:
                acc = acc + v
            return acc

        return seq([seq(vals[i * per_slice:(i + 1) * per_slice])
                    for i in range(n_slices)])

    # -- planning -------------------------------------------------------

    def _plan_run(self, load, num_requests: int, source,
                  offered_qps=None, block_size: int = 65_536,
                  trim: bool = False) -> _RunPlan:
        """Resolve the physical run shape (see :class:`_RunPlan`)."""
        # every sharded entry point plans here: lb preconditions (no
        # saturated loads) + the lb.degraded_backend fault site
        self.sim._check_lb_load(load)
        n_local = -(-num_requests // self.n_shards)
        if load.kind == OPEN_LOOP:
            offered = float(load.qps)
            block = max(1, min(block_size, n_local))
        else:
            if load.connections % self.n_shards:
                raise ValueError(
                    f"closed-loop connections ({load.connections}) must "
                    f"divide evenly over {self.n_shards} shards"
                )
            if offered_qps is None:
                # the un-rooted source, as the reference's key: the
                # paced solver caps its pilots at 2,048 requests, the
                # saturated law time-averages over the real total
                offered_qps = self.sim.solve_closed_rate(
                    load, num_requests, source
                )
            offered = float(offered_qps)
            conns_local = max(load.connections // self.n_shards, 1)
            # block_size is a soft memory bound: when per-shard
            # connections exceed it the block grows to ``conns_local``
            per = max(1, min(block_size, n_local) // conns_local)
            block = per * conns_local
        num_blocks = max(1, -(-n_local // block))
        if trim:
            from isotope_tpu_torch.metrics.fortio import trim_window_bounds

            window = trim_window_bounds(
                num_blocks * block * self.n_shards, offered
            )
        else:
            window = (0.0, float("inf"))
        return _RunPlan(
            offered=offered, block=block, num_blocks=num_blocks,
            window=window, saturated=self.sim._saturated(load), trim=trim,
        )

    def _timeline_plan(self, plan: _RunPlan, window_s):
        """The window grid of a sharded run: every shard bins into the
        SAME absolute sim-time grid (shard clocks all start at t=0),
        sized from the TOTAL request count and offered rate."""
        total = plan.num_blocks * plan.block * self.n_shards
        return self.sim.plan_timeline_windows(total, plan.offered,
                                              window_s)

    def _args_put(self, plan: _RunPlan) -> None:
        """Build the run's argument tables (the visit fixed point and the
        phase windows at the planned rate) on the device, under the
        ``sharded.args_put`` phase and fault site."""
        with telemetry.phase("sharded.args_put"):
            faults.check("sharded.args_put")
            self.sim._vis_arg(plan.offered)
            self.sim._windows_arg(plan.offered, plan.saturated)
            if telemetry.detail_enabled():
                self._sync()

    # -- one shard ------------------------------------------------------

    def _local_scan(self, load, plan: _RunPlan, shard: int, source, *,
                    attr: bool = False, tail_cut=None, tl_plan=None):
        """Shard ``shard``'s pre-collective block loop: the Simulator's
        own loop under ``RootedSource(source, 500_000 + shard)``, paced
        at ``1 / n_shards`` of the stream.  Shared verbatim between the
        collective path and the emulated twin.  Returns the
        RunSummary, ``(summary, attribution)`` with ``attr``, or
        ``(summary, timeline)`` with ``tl_plan``."""
        control = (
            _BlockControl(self.sim, tl_plan, False, False)
            if tl_plan is not None else None
        )
        out = self.sim._run_summary(
            load, plan.num_blocks * plan.block,
            RootedSource(source, SHARD_INDEX_BASE + shard), plan.block,
            self.collector, plan.trim, control, attr=attr,
            tail_cut=tail_cut,
            plan=(plan.offered, plan.block, plan.num_blocks),
            shards=self.n_shards,
        )
        if control is not None:
            return out, control.tl_acc
        return out

    def _each_shard(self, scan) -> list:
        """``scan(shard)`` of every shard in order, serialized so live
        memory stays bounded by ONE shard."""
        out = []
        with telemetry.phase("sharded.emulated"):
            for s in range(self.n_shards):
                out.append(scan(s))
                self._sync()
        return out

    # -- the collective path --------------------------------------------

    def _collective_run(self, what, load, num_requests, source,
                        offered_qps, block_size, trim, scan, merge,
                        prepare=None, overlap=False):
        """Plan, scan and merge one collective run, with the ranks'
        failure agreement after the scan and after the
        ``sharded.gather`` site."""
        self._require_mesh(what)
        err = plan = local = None
        try:
            if prepare is not None:
                prepare()
            plan = self._plan_run(load, num_requests, source,
                                  offered_qps, block_size, trim)
            if what == "run":
                # the rows simulated are num_blocks * block per shard
                # (shard fill + connection and block rounding): the
                # gauge is the fraction beyond the requests asked for
                telemetry.counter_inc("sharded_runs")
                telemetry.gauge_set("shard_count", self.n_shards)
                telemetry.gauge_set(
                    "shard_rows_imbalance_fraction",
                    (plan.num_blocks * plan.block * self.n_shards
                     - num_requests) / max(num_requests, 1),
                )
            else:
                telemetry.counter_inc(
                    "sharded_attributed_runs" if what == "run_attributed"
                    else "sharded_timeline_runs"
                )
            self._args_put(plan)
            faults.check("sharded.compute")
            if self.dcn_axes:
                # the dropped cross-host collective site: a mesh with a
                # slice axis is about to reduce across hosts
                faults.check("sharded.dcn_collective")
            if scan is not None:
                local = scan(plan)
        except Exception as e:
            err = e
        self._agree(err, "sharded.compute")
        if overlap:
            out = self._gather_svc(self._overlap_scan(load, plan, source))
        else:
            out = merge(local)
        if telemetry.detail_enabled():
            with telemetry.phase("sharded.gather"):
                self._sync()
            telemetry.record_device_memory()
        err = None
        try:
            faults.check("sharded.gather")
        except Exception as e:
            err = e
        self._agree(err, "sharded.gather")
        return out

    def _overlap_scan(self, load, plan: _RunPlan, source) -> RunSummary:
        """This rank's block loop with the merge pipelined one block
        behind: block *k*'s merge is issued at the top of step *k+1*
        and waited before the ``summary_accumulate`` fold; step 0
        merges a zero primer, the last block's merge follows the loop.

        The same draws and block summaries as the plain path — only the
        reduction order differs (each block merged across shards, then
        accumulated over blocks), so integer-valued fields match
        exactly and float sums to reduction-order float32 noise.  A
        block that raises on one rank leaves its rank contributing zero
        summaries with its status code through the remaining merges,
        so no rank waits in a collective; every rank raises after the
        last one.  Returns the merged summary's svc tiles."""
        dev = self.device
        S = self.compiled.num_services
        blocks = self.sim.run_blocks(
            load, plan.num_blocks * plan.block,
            RootedSource(source, SHARD_INDEX_BASE + self.shard),
            block_size=plan.block,
            plan=(plan.offered, plan.block, plan.num_blocks),
            shards=self.n_shards,
        )
        win = None
        if plan.trim:
            win = (self.sim._scalar(plan.window[0]),
                   self.sim._scalar(plan.window[1]))
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        acc = zeros_summary(self.collector, S,
                            svc_rows=self.s_pad // self.n_svc, device=dev)
        pending = zeros_summary(self.collector, S, device=dev)  # primer
        status = torch.zeros((), dtype=F32, device=dev)
        err = None
        for b in range(plan.num_blocks + 1):
            code = 0 if err is None else _CODES[classify(err)]
            merging = self._issue_merge(pending, code, side)
            nxt = None
            if b < plan.num_blocks:
                if err is None:
                    try:
                        nxt = summarize(next(blocks), self.collector,
                                        window=win)
                    except Exception as e:
                        err = e
                if nxt is None:
                    nxt = zeros_summary(self.collector, S, device=dev)
            merged, merged_status = self._wait_merge(merging, side)
            acc = summary_accumulate(acc, merged)
            status = torch.maximum(status, merged_status)
            pending = nxt
        self._raise_agreed(int(status.item()), err, "sharded.compute")
        return acc

    def _issue_merge(self, pending: RunSummary, code: int, side):
        """Issue ``pending``'s merge: on the card on the ``side`` stream
        (the compute stream runs on), else in place."""
        if side is None:
            return self._merge_summary_collective(pending, code)
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._merge_summary_collective(pending, code)
        for t in _leaves(pending):
            t.record_stream(side)
        return out

    def _wait_merge(self, merging, side):
        if side is None:
            return merging
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(side)
        for t in _leaves(merging):
            t.record_stream(cur)
        return merging

    # -- collectives ----------------------------------------------------

    def _reduce(self, tensors: Sequence[torch.Tensor], op, axes=None):
        """``tensors`` reduced with ``op`` over each axis of ``axes`` in
        turn (an axis of size 1 is skipped), or over every rank at once
        (``axes`` None); one flat buffer a dtype.  Returns the reduced
        tensors in order."""
        dist = _dist()
        if axes is None:
            groups = [None] if self.n_shards > 1 else []
        else:
            groups = [self._groups[a] for a in axes if a in self._groups]
        if not groups:
            return list(tensors)
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            buf = torch.cat([tensors[i].reshape(-1) for i in idx])
            for g in groups:
                dist.all_reduce(buf, op=op, group=g, async_op=True).wait()
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = buf[off:off + n].view(tensors[i].shape)
                off += n
        return out

    def _merge_summary_collective(self, local: RunSummary,
                                  code: int = 0):
        """The mesh metric reduction over one shard's RunSummary
        (shared by the plain, overlap, attributed and recorded runs).
        Returns ``(merged summary with svc tiles, agreed status)``:
        ``code`` is this rank's status, carried in the MAX reduction.

        Order: the in-host axes (``data``, ``svc``) reduce first, the
        ``slice`` axis last; the per-service histograms reduce over
        ``data``, reduce-scatter over ``svc`` and only then cross
        ``slice``, on 1/svc tiles.
        """
        dist = _dist()
        SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX
        every = self.ici_axes + self.dcn_axes
        m = local.metrics
        (count, error_count, hop_events, latency_sum, latency_hist,
         win_count, win_error_count, win_latency_hist, incoming_total,
         outgoing_total, outgoing_size_hist, outgoing_size_sum,
         duration_sum, response_size_sum) = self._reduce([
            local.count, local.error_count, local.hop_events,
            local.latency_sum, local.latency_hist, local.win_count,
            local.win_error_count, local.win_latency_hist,
            m.incoming_total, m.outgoing_total, m.outgoing_size_hist,
            m.outgoing_size_sum, m.duration_sum, m.response_size_sum,
        ], SUM, every)
        # one MAX buffer: the minimum rides negated (exact), the status
        # code is this rank's failure class (0 = ok)
        neg_min, latency_max, end_max, status = self._reduce([
            -local.latency_min, local.latency_max, local.end_max,
            torch.full((), float(code), dtype=F32, device=self.device),
        ], MAX, every)
        duration_hist, response_size_hist = self._scatter_svc(
            m.duration_hist, m.response_size_hist
        )
        # Chan/Welford merge of per-shard centered second moments
        mean_local = local.latency_sum / torch.clamp(local.count, min=1.0)
        mean_tot = latency_sum / torch.clamp(count, min=1.0)
        (m2_tot,) = self._reduce([
            local.latency_m2 + local.count * (mean_local - mean_tot) ** 2
        ], SUM, every)
        return RunSummary(
            count=count,
            error_count=error_count,
            hop_events=hop_events,
            latency_sum=latency_sum,
            latency_m2=m2_tot,
            latency_min=-neg_min,
            latency_max=latency_max,
            latency_hist=latency_hist,
            end_max=end_max,
            win_lo=local.win_lo,   # identical on every shard
            win_hi=local.win_hi,
            win_count=win_count,
            win_error_count=win_error_count,
            win_latency_hist=win_latency_hist,
            metrics=ServiceMetrics(
                incoming_total=incoming_total,
                outgoing_total=outgoing_total,
                outgoing_size_hist=outgoing_size_hist,
                outgoing_size_sum=outgoing_size_sum,
                duration_hist=duration_hist,
                duration_sum=duration_sum,
                response_size_hist=response_size_hist,
                response_size_sum=response_size_sum,
            ),
            utilization=local.utilization,
            unstable=local.unstable,
        ), status

    def _scatter_svc(self, *hists):
        """Per-service (S, ...) histograms summed over the in-host
        request axes, padded to ``s_pad`` rows, reduce-scattered over
        ``svc`` and summed over ``slice``: this rank's tiles."""
        dist = _dist()
        S = hists[0].shape[0]
        flat = torch.cat([h.reshape(S, -1) for h in hists], 1)
        (flat,) = self._reduce([flat], dist.ReduceOp.SUM,
                               self.ici_request_axes)
        if self.s_pad > S:
            flat = torch.cat([flat, flat.new_zeros(self.s_pad - S,
                                                   flat.shape[1])])
        if SVC_AXIS in self._groups:
            tile = flat.new_empty(self.s_pad // self.n_svc, flat.shape[1])
            _quiet(dist.reduce_scatter_tensor, tile, flat.contiguous(),
                   op=dist.ReduceOp.SUM, group=self._groups[SVC_AXIS])
            flat = tile
        (flat,) = self._reduce([flat], dist.ReduceOp.SUM, self.dcn_axes)
        return self._split_cols(flat, hists)

    @staticmethod
    def _split_cols(flat, like):
        out, off = [], 0
        for h in like:
            w = int(np.prod(h.shape[1:]))
            out.append(flat[:, off:off + w].reshape(
                (flat.shape[0],) + tuple(h.shape[1:])
            ))
            off += w
        return out

    def _gather_svc(self, summary: RunSummary) -> RunSummary:
        """The svc tiles gathered at the entry point's boundary: every
        rank then holds the global ``(s_pad, ...)`` histograms."""
        if SVC_AXIS not in self._groups:
            return summary
        dist = _dist()
        m = summary.metrics
        hists = (m.duration_hist, m.response_size_hist)
        rows = hists[0].shape[0]
        tile = torch.cat([h.reshape(rows, -1) for h in hists], 1)
        full = tile.new_empty(self.s_pad, tile.shape[1])
        _quiet(dist.all_gather_into_tensor, full, tile.contiguous(),
               group=self._groups[SVC_AXIS])
        dur, resp = self._split_cols(full, hists)
        return summary._replace(metrics=m._replace(
            duration_hist=dur, response_size_hist=resp,
        ))

    def _merge_attribution(self, attr):
        """The blame accumulators summed over the mesh (``tail_cut``
        held out); the exemplars all-gathered in shard order and cut to
        the global top-K (ties: lowest shard, then lowest row first —
        ``jax.lax.top_k``'s order)."""
        if self.n_shards == 1:
            return attr
        dist = _dist()
        keys = [f for f in attr._fields if f not in ("tail_cut",
                                                     "exemplars")]
        summed = self._reduce([getattr(attr, f) for f in keys],
                              dist.ReduceOp.SUM)
        out = attr._replace(**dict(zip(keys, summed)))
        ex = attr.exemplars
        if ex is not None:
            k = ex.latency.shape[0]
            cat = type(ex)(*(self._gather_world(x) for x in ex))
            keep = torch.argsort(-cat.latency, stable=True)[:k]
            out = out._replace(exemplars=type(ex)(*(x[keep] for x in cat)))
        return out

    def _merge_timeline(self, tl):
        """The recorder's series summed over the mesh (``window_s``
        held out)."""
        if self.n_shards == 1:
            return tl
        dist = _dist()
        summed = self._reduce(list(tl[1:]), dist.ReduceOp.SUM)
        return type(tl)(tl.window_s, *summed)

    def _gather_world(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along its leading axis, in rank
        (= shard) order; bool rides as uint8."""
        dist = _dist()
        src = x.to(torch.uint8) if x.dtype == torch.bool else x
        out = src.new_empty((self.n_shards * x.shape[0],)
                            + tuple(x.shape[1:]))
        _quiet(dist.all_gather_into_tensor, out, src.contiguous())
        return out.to(torch.bool) if x.dtype == torch.bool else out

    # -- failure agreement ----------------------------------------------

    def _agree(self, err: Optional[BaseException], stage: str) -> None:
        """All-reduce (MAX) this rank's status code over the mesh and
        raise on every rank when any rank failed; without ranks (an
        :class:`EmulatedMesh`) a failure simply raises."""
        code = 0 if err is None else _CODES[classify(err)]
        if not self.emulated:
            dist = _dist()
            flag = torch.tensor([code], dtype=torch.int32,
                                device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            code = int(flag.item())
        self._raise_agreed(code, err, stage)

    @staticmethod
    def _raise_agreed(code: int, err, stage: str) -> None:
        if not code:
            return
        cls = _CLASSES[code]
        if err is not None and classify(err) == cls:
            raise err
        detail = (
            f": {type(err).__name__}: {err}" if err is not None
            else " on another rank"
        )
        raise MeshFault(f"{stage} failed ({cls}){detail}", cls) from err

    def _agreed(self, body, stage: str):
        """``body()`` with the ranks' failure agreement after it (the
        emulated rung of a real mesh; a twin just raises)."""
        err = out = None
        try:
            out = body()
        except Exception as e:
            err = e
        self._agree(err, stage)
        return out

    # -- host merge (the emulated twin) ---------------------------------

    def _merge_shard_summaries(self, shards) -> RunSummary:
        """Replay of the mesh collectives over per-shard summaries.

        Cross-shard sums accumulate SEQUENTIALLY in shard order at the
        summaries' own dtype, each slice's shards first and then the
        slice partials (the reference's association), and the Welford
        cross-shard term repeats the float32 steps of the collective
        merge.  The per-service histograms come back padded to
        ``s_pad`` rows, the collective path's global layout.
        """
        def allsum(get):
            return self._hier([get(s) for s in shards])

        def stack(get):
            return torch.stack([get(s) for s in shards])

        def scatter_svc(get):
            # the sum over request axes + the tiled reduce-scatter over
            # svc == the zero-padded total laid out over the svc axis
            x = allsum(get)
            pad = self.s_pad - x.shape[0]
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            return x

        counts = stack(lambda s: s.count)
        sums = stack(lambda s: s.latency_sum)
        m2s = stack(lambda s: s.latency_m2)
        n_tot = allsum(lambda s: s.count)
        s_tot = allsum(lambda s: s.latency_sum)
        mean_local = sums / torch.clamp(counts, min=1.0)
        mean_tot = s_tot / torch.clamp(n_tot, min=1.0)
        terms = m2s + counts * (mean_local - mean_tot) ** 2
        m2_tot = self._hier(list(terms))
        metrics = None
        if shards[0].metrics is not None:
            metrics = ServiceMetrics(
                incoming_total=allsum(lambda s: s.metrics.incoming_total),
                outgoing_total=allsum(lambda s: s.metrics.outgoing_total),
                outgoing_size_hist=allsum(
                    lambda s: s.metrics.outgoing_size_hist
                ),
                outgoing_size_sum=allsum(
                    lambda s: s.metrics.outgoing_size_sum
                ),
                duration_hist=scatter_svc(
                    lambda s: s.metrics.duration_hist
                ),
                duration_sum=allsum(lambda s: s.metrics.duration_sum),
                response_size_hist=scatter_svc(
                    lambda s: s.metrics.response_size_hist
                ),
                response_size_sum=allsum(
                    lambda s: s.metrics.response_size_sum
                ),
            )
        return RunSummary(
            count=n_tot,
            error_count=allsum(lambda s: s.error_count),
            hop_events=allsum(lambda s: s.hop_events),
            latency_sum=s_tot,
            latency_m2=m2_tot,
            latency_min=stack(lambda s: s.latency_min).amin(0),
            latency_max=stack(lambda s: s.latency_max).amax(0),
            latency_hist=allsum(lambda s: s.latency_hist),
            end_max=stack(lambda s: s.end_max).amax(0),
            win_lo=shards[0].win_lo,
            win_hi=shards[0].win_hi,
            win_count=allsum(lambda s: s.win_count),
            win_error_count=allsum(lambda s: s.win_error_count),
            win_latency_hist=allsum(lambda s: s.win_latency_hist),
            metrics=metrics,
            utilization=shards[0].utilization,
            unstable=shards[0].unstable,
        )

    # -- guards ---------------------------------------------------------

    def _require_mesh(self, what: str) -> None:
        """The collective entry points need ranks behind the mesh."""
        if self.emulated:
            raise ValueError(
                f"{what} needs a device mesh; this ShardedSimulator "
                f"was built over {self.mesh!r} (no devices) — use the "
                f"*_emulated twin, which replays any host count on "
                f"one device"
            )

    def _require_protected(self, load: LoadModel, roll: bool) -> None:
        """The reference's refusals of a protected mesh run: its tables,
        the recorder, no saturated load, and ``svc = 1`` (the control
        state is replicated over the shards, which a svc-sharded
        metric layout would split)."""
        what = "rollout" if roll else "policy"
        if (self.sim._rollouts if roll else self.sim._policies) is None:
            raise ValueError(
                f"{what} runs need compiled {what} tables "
                f"(ShardedSimulator(..., {what.replace('y', 'ie')}s=...))"
            )
        if not self.sim.params.timeline:
            raise ValueError(
                f"{what} runs need SimParams(timeline=True)"
            )
        if self.sim._saturated(load):
            raise ValueError(
                f"{what} runs do not support saturated -qps max loads "
                "(static finite-population tables; see "
                f"Simulator.run_{what.replace('y', 'ie')}s)"
            )
        if self.n_svc != 1:
            raise ValueError(
                f"{what} runs need a mesh with svc=1: the per-service "
                "control state is replicated across shards (every shard "
                "advances the same trajectory from the merged window "
                "signals), which a svc-sharded metric layout would split"
            )

    def _require_protected_fleet(self, load: LoadModel, roll: bool) -> None:
        """A protected fleet's tables and recorder (any mesh serves it:
        no collective crosses members), and its fault sites."""
        what = "rollout" if roll else "policy"
        if (self.sim._rollouts if roll else self.sim._policies) is None:
            raise ValueError(
                f"{what} fleets need compiled {what} tables "
                f"(ShardedSimulator(..., {what.replace('y', 'ie')}s=...))"
            )
        if not self.sim.params.timeline:
            raise ValueError(
                f"{what} fleets need SimParams(timeline=True) — the "
                "flight recorder is the control loop's observation side"
            )
        if self.sim._policies is not None:
            faults.check("policies.stuck_breaker")
            faults.check("policies.autoscaler_lag")

    def _require_attribution(self) -> None:
        if not self.sim.params.attribution:
            raise ValueError(
                "attributed runs need SimParams(attribution=True)"
            )

    def _require_timeline(self) -> None:
        if not self.sim.params.timeline:
            raise ValueError(
                "timeline runs need SimParams(timeline=True)"
            )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _ShardControl:
    """One shard's view of a lockstep twin's shared
    :class:`_BlockControl`: its blocks run under the shared effects, and
    its observations wait in ``pending`` for the shards' merge."""

    def __init__(self, shared: _BlockControl):
        self.shared = shared
        self.pol, self.roll = shared.pol, shared.roll
        self.pending = None

    def effects(self):
        return self.shared.effects()

    def observe(self, res, t_done) -> None:
        self.pending = (self.shared.contributions(res), t_done)


class _ControlMerge:
    """The merge hook of a protected mesh run's control
    (:class:`_BlockControl`): each block's observations and ``t_done``
    are all-gathered (one buffer a dtype, with this rank's status code)
    and merged by :meth:`ShardedSimulator.merge_observations`.  A rank
    whose block failed takes part in the next merge with zero
    observations and its status code; every rank then raises there, so
    none waits in a later collective."""

    def __init__(self, sh: ShardedSimulator):
        self.sh = sh
        self.control = None
        self.blocks = 0
        self.done = 0
        self.closed = False

    def arm(self, control: _BlockControl, blocks: int) -> None:
        self.control, self.blocks = control, blocks

    def __call__(self, parts, t_done, code: int = 0):
        sh = self.sh
        dist = _dist()
        tl, robs, pobs = parts
        slots = list(tl[1:]) + [robs, pobs]
        leaves = [x for x in slots if x is not None]
        head = torch.stack([
            t_done.to(F32).reshape(()),
            torch.tensor(float(code), dtype=F32, device=sh.device),
        ])
        groups = {F32: []}
        for i, x in enumerate(leaves):
            groups.setdefault(x.dtype, []).append(i)
        rows = [[None] * len(leaves) for _ in range(sh.n_shards)]
        for dtype, idx in groups.items():
            buf = torch.cat(([head] if dtype == F32 else [])
                            + [leaves[i].reshape(-1) for i in idx])
            full = buf.new_empty(sh.n_shards * buf.numel())
            _quiet(dist.all_gather_into_tensor, full, buf)
            full = full.view(sh.n_shards, buf.numel())
            off = 0
            if dtype == F32:
                times, stat = full[:, 0], full[:, 1]
                off = 2
            for i in idx:
                n = leaves[i].numel()
                for r in range(sh.n_shards):
                    rows[r][i] = full[r, off:off + n].view(leaves[i].shape)
                off += n
        self.done += 1
        code_max = int(stat.max().item())
        if code_max:
            self.closed = True
            cls = _CLASSES[code_max]
            raise MeshFault(
                f"sharded.compute failed ({cls}) on another rank", cls
            )
        shards = []
        for r in range(sh.n_shards):
            got = iter(rows[r])
            vals = [None if x is None else next(got) for x in slots]
            shards.append((
                (type(tl)(tl.window_s, *vals[:-2]), vals[-2], vals[-1]),
                times[r],
            ))
        return sh.merge_observations(shards)

    def abort(self, err: BaseException) -> None:
        """This rank failed: join the merge the other ranks wait in
        (if any is left) with zero observations and its status code."""
        if (self.control is None or self.closed
                or self.done >= self.blocks):
            return
        c = self.control
        zeros = (
            type(c.tl_acc)(c.tl_acc.window_s,
                           *(torch.zeros_like(x) for x in c.tl_acc[1:])),
            torch.zeros_like(c.robs) if c.roll is not None else None,
            torch.zeros_like(c.pobs) if c.pol is not None else None,
        )
        try:
            self(zeros, torch.zeros((), dtype=F32, device=self.sh.device),
                 code=_CODES[classify(err)])
        except MeshFault:
            pass
