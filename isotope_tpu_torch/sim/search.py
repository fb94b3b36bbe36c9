"""Config search: successive-halving brackets over a fleet's members.

The port of ``isotope_tpu.sim.search``.  A :class:`SearchSpec` screens
a candidate population (an :class:`~isotope_tpu_torch.sim.ensemble.
EnsembleSpec`: qps / cpu / error scales a candidate) by classic
successive halving:

- rung 0 runs all N candidates for a SHORT horizon as one fleet,
  plain or protected (folded ``"vmap"`` chunks on the card: one census
  call of (M*N, B, P) a level; member by member ``"map"`` on the CPU);
- candidates are ranked on the device by a severity channel
  (:func:`~isotope_tpu_torch.sim.splitting.severity_scores_device`:
  ``err_share``, ``p99`` SLO-violation depth, ``trips`` for protected
  populations; ``err_peak`` falls back to ``err_share``), ties broken
  by a per-candidate uniform (:func:`tiebreak_draws`), through two
  stable sorts (the reference's ``lexsort``);
- the best ``1/eta`` advance: ``compiler/compile.ensemble_take``
  gathers their rows of the stacked fleet inputs AND of the
  ``(t0, conn_t0, req_off)`` carries (the full control state for a
  protected population), so the next rung continues the survivors'
  trajectories at a longer horizon instead of re-simulating from t=0.
  The survivors' ids are read back each rung (their draw sources are
  host objects); everything else stays on the device until the final
  lineage is copied to the host.

Determinism: candidate k's rung-0 row equals its ``run_ensemble``
member, a survivor's continuation draws the unbroken run's blocks
(index ``1_000_000 + start_block + b`` of ``RootedSource(source,
seed)``) from its carried clocks, and ties rank by the tie-break
uniforms, so the lineage is a pure function of (spec, source, horizon).
The document's ``traces`` and each rung's ``evidence.compile_s`` count
the reference's engine traces and compile wall, which the port has
none of: they are 0.  On a device mesh (:func:`run_search_sharded`)
each rung's candidates spread over the ranks as a mesh fleet's members
and their summaries and carries are gathered, so every rank ranks the
same rung; :func:`run_search_emulated` walks the same chunks on one
device.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.resilience import faults
from isotope_tpu_torch.sim.ensemble import EnsembleSpec
from isotope_tpu_torch.sim.splitting import SEVERITIES

DOC_SCHEMA = "isotope-search/v1"

#: rank channels — the splitting estimator's severity channels
SEARCH_RANKS = SEVERITIES


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One successive-halving bracket over a candidate population.

    ``candidates`` is the stacked config population (every
    :class:`EnsembleSpec` perturbation axis is a search axis).
    ``eta`` is the halving rate: each rung keeps the best
    ``ceil(width / eta)``.  ``rungs`` counts screening levels
    including the final full-horizon rung.  ``growth`` scales the
    cumulative horizon between rungs (None = ``eta``, the classic
    budget-balanced bracket: every rung spends about the same total
    simulated requests).  ``rank`` picks the severity channel
    (:data:`SEARCH_RANKS`); ``p99`` needs ``slo_s``.  ``seed`` derives
    the deterministic tie-break draws.  ``chunk`` caps members per
    rung dispatch (None = carry-aware cost model).
    """

    candidates: EnsembleSpec
    eta: int = 4
    rungs: int = 3
    growth: Optional[int] = None
    rank: str = "err_share"
    slo_s: Optional[float] = None
    seed: int = 0
    chunk: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.candidates, EnsembleSpec):
            object.__setattr__(
                self, "candidates",
                EnsembleSpec.from_dict(dict(self.candidates)),
            )
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2; got {self.eta}")
        if self.rungs < 1:
            raise ValueError(f"rungs must be >= 1; got {self.rungs}")
        if self.growth is not None and self.growth < 2:
            raise ValueError(
                f"growth must be >= 2 (or None = eta); got "
                f"{self.growth}: the horizon schedule could not "
                "increase between rungs (VET-T026)"
            )
        if self.rank not in SEARCH_RANKS:
            raise ValueError(
                f"unknown search rank {self.rank!r} (expected one of "
                f"{SEARCH_RANKS})"
            )
        if self.rank == "p99" and (
            self.slo_s is None or self.slo_s <= 0
        ):
            raise ValueError(
                "rank='p99' needs slo_s > 0 (the latency that maps "
                "to severity 1.0)"
            )
        if self.chunk is not None and self.chunk < 1:
            raise ValueError("chunk must be >= 1 (or None = auto)")

    @property
    def members(self) -> int:
        return self.candidates.members

    def resolved_growth(self) -> int:
        return self.eta if self.growth is None else self.growth

    def rung_widths(self) -> Tuple[int, ...]:
        """Live candidates per rung: ``ceil(N / eta^r)``."""
        n = self.members
        return tuple(
            -(-n // self.eta ** r) for r in range(self.rungs)
        )

    def check(self) -> None:
        """Run-entry validation (the loud version of VET-T026)."""
        self.candidates.check()
        widths = self.rung_widths()
        for a, b in zip(widths, widths[1:]):
            if b >= a:
                raise ValueError(
                    f"population of {self.members} cannot support "
                    f"{self.rungs} rungs at eta={self.eta}: rung "
                    f"widths {widths} stop shrinking (VET-T026) — "
                    "grow the population or drop rungs"
                )

    def to_dict(self) -> dict:
        return {
            "candidates": self.candidates.to_dict(),
            "eta": self.eta,
            "rungs": self.rungs,
            "growth": self.growth,
            "rank": self.rank,
            "slo_s": self.slo_s,
            "seed": self.seed,
            "chunk": self.chunk,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SearchSpec":
        return cls(
            candidates=EnsembleSpec.from_dict(d["candidates"]),
            eta=int(d.get("eta", 4)),
            rungs=int(d.get("rungs", 3)),
            growth=d.get("growth"),
            rank=d.get("rank", "err_share"),
            slo_s=d.get("slo_s"),
            seed=int(d.get("seed", 0)),
            chunk=d.get("chunk"),
        )


class RungPlan(NamedTuple):
    """One rung's static shape."""

    rung: int
    width: int        # live candidates
    bucket: int       # width padded to the pow2 executable family
    start_block: int  # cumulative blocks already simulated (b0)
    num_blocks: int   # this rung's continuation segment
    cum_requests: int  # per-candidate requests simulated through here


def plan_bracket(spec: SearchSpec, num_requests: int,
                 block: int) -> Tuple[RungPlan, ...]:
    """Resolve the bracket's static rung schedule.

    The cumulative horizon after rung r is
    ``ceil(total_blocks / growth^(rungs-1-r))`` blocks — the final
    rung lands exactly on the requested horizon and each earlier rung
    screens at ``1/growth`` of the next one's budget.  Rungs simulate
    only their *segment* (cumulative minus what the carries already
    hold), which is where the warm-start saving lives.  A schedule
    that fails to increase (horizon too short for the rung count) is
    the runtime edge VET-T026 lints for — raised loudly here.
    """
    from isotope_tpu_torch.compiler.compile import rung_bucket

    spec.check()
    total_nb = max(1, -(-int(num_requests) // int(block)))
    growth = spec.resolved_growth()
    cum = [
        max(1, -(-total_nb // growth ** (spec.rungs - 1 - r)))
        for r in range(spec.rungs)
    ]
    for a, b in zip(cum, cum[1:]):
        if b <= a:
            raise ValueError(
                f"search horizon schedule is not increasing "
                f"({cum} blocks of {block} requests over "
                f"{spec.rungs} rungs at growth={growth}) — raise "
                "num_requests or drop rungs/growth (VET-T026)"
            )
    widths = spec.rung_widths()
    plans = []
    prev = 0
    for r in range(spec.rungs):
        plans.append(RungPlan(
            rung=r,
            width=widths[r],
            bucket=rung_bucket(widths[r]),
            start_block=prev,
            num_blocks=cum[r] - prev,
            cum_requests=cum[r] * block,
        ))
        prev = cum[r]
    return tuple(plans)


@dataclasses.dataclass(frozen=True)
class RungResult:
    """One rung's lineage: who ran, how they scored, who survived."""

    rung: int
    width: int
    chunk: int
    start_block: int
    num_blocks: int
    cum_requests: int
    candidates: np.ndarray   # (width,) global candidate ids, rank order of the PREVIOUS rung
    severity: np.ndarray     # (width,) this rung's severity per candidate
    survivors: np.ndarray    # global ids advanced (rank order; final rung: the winner)
    summaries: object        # member-stacked RunSummary (host tensors)
    # per-rung evidence: how close the cut was — enough for ``explain``
    # to narrate the bracket without re-running it
    order: Optional[np.ndarray] = None   # (width,) rank order (row indices)
    # the reference's engine traces and first-call compile wall of the
    # rung: the port compiles nothing, so both stay 0
    traces: int = 0
    compile_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class SearchSummary:
    """One bracket's outcome: winner + full per-rung survivor lineage."""

    spec: SearchSpec
    block: int
    plan: Tuple[RungPlan, ...]
    rungs: List[RungResult]
    winner: int
    winner_severity: float
    offered_qps: np.ndarray   # (N,) per-candidate planned rates
    traces: int               # 0: the port traces no engine program
    mode: str                 # "vmap" (folded, on CUDA) or "map"

    def winner_config(self) -> dict:
        """The surviving candidate's exact config — the warm start
        the ``optimize`` roadmap item picks up."""
        pop = self.spec.candidates
        k = self.winner

        def scale(arr):
            return None if arr is None else float(arr[k])

        return {
            "candidate": k,
            "seed": pop.seeds[k],
            "qps_scale": scale(pop.qps_scale),
            "cpu_scale": scale(pop.cpu_scale),
            "error_scale": scale(pop.error_scale),
            "offered_qps": float(self.offered_qps[k]),
            "severity": self.winner_severity,
            "rank": self.spec.rank,
        }

    def winner_summary(self):
        """The winner's bracket-combined RunSummary: its per-rung
        segment rows merged with the streaming accumulate (same float
        caveat as :func:`~isotope_tpu_torch.sim.summary.
        summary_accumulate`)."""
        from isotope_tpu_torch.sim import summary as summary_mod
        from isotope_tpu_torch.sim.ensemble import member_summary

        acc = None
        for r in self.rungs:
            row = int(np.where(r.candidates == self.winner)[0][0])
            part = member_summary(r.summaries, row)
            acc = part if acc is None else summary_mod.summary_accumulate(
                acc, part
            )
        return acc

    def pooled(self):
        """Every simulated row of the whole bracket reduced to ONE
        RunSummary — the bench unit (total hop events the bracket
        bought for its wall-clock)."""
        from isotope_tpu_torch.sim import summary as summary_mod

        acc = None
        for r in self.rungs:
            part = summary_mod.reduce_stacked(r.summaries)
            acc = part if acc is None else summary_mod.summary_accumulate(
                acc, part
            )
        return acc

    def to_doc(self, label: str = "") -> dict:
        """The ``<label>.search.json`` isotope-search/v1 artifact."""
        return {
            "schema": DOC_SCHEMA,
            "label": label,
            "rank": self.spec.rank,
            "rank_effective": (
                "err_share" if self.spec.rank == "err_peak"
                else self.spec.rank
            ),
            "eta": self.spec.eta,
            "growth": self.spec.resolved_growth(),
            "candidates": self.spec.members,
            "block": self.block,
            "traces": self.traces,
            "mode": self.mode,
            "winner": self.winner_config(),
            "lineage": [
                self._rung_entry(r) for r in self.rungs
            ],
            "spec": self.spec.to_dict(),
        }

    def _rung_entry(self, r: RungResult) -> dict:
        """One lineage row with its evidence block: per-rung
        trace/compile cost (0 in the port) plus the CUT LINE — the
        last-kept vs first-cut severities (rank channel values) — so
        ``explain`` can narrate why the winner beat the runner-up at
        every rung without re-running the bracket."""
        entry = {
            "rung": r.rung,
            "width": r.width,
            "chunk": r.chunk,
            "start_block": r.start_block,
            "num_blocks": r.num_blocks,
            "cum_requests": r.cum_requests,
            "candidates": [int(x) for x in r.candidates],
            "severity": [float(x) for x in r.severity],
            "survivors": [int(x) for x in r.survivors],
        }
        evidence = {
            "traces": int(r.traces),
            "compile_s": round(float(r.compile_s), 4),
        }
        if r.order is not None:
            keep = len(r.survivors)
            ranked = [int(r.candidates[i]) for i in r.order]
            evidence["rank_order"] = ranked
            last_kept = int(r.order[keep - 1])
            cut = {
                "kept": keep,
                "last_kept": {
                    "candidate": int(r.candidates[last_kept]),
                    "severity": float(r.severity[last_kept]),
                },
            }
            if keep < r.width:
                first_cut = int(r.order[keep])
                cut["first_cut"] = {
                    "candidate": int(r.candidates[first_cut]),
                    "severity": float(r.severity[first_cut]),
                }
                cut["margin"] = float(
                    r.severity[first_cut] - r.severity[last_kept]
                )
            entry["cut"] = cut
        entry["evidence"] = evidence
        return entry


def check_doc(doc: dict) -> dict:
    """Validate an isotope-search/v1 document (round-trip guard)."""
    if doc.get("schema") != DOC_SCHEMA:
        raise ValueError(
            f"not an {DOC_SCHEMA} document: {doc.get('schema')!r}"
        )
    return doc


def load_doc(path: str) -> dict:
    with open(path) as f:
        return check_doc(json.load(f))


# -- the bracket engine ------------------------------------------------


def tiebreak_draws(spec: SearchSpec, device="cpu") -> torch.Tensor:
    """One uniform per candidate: the rank tie-break, float32 on
    ``device``.  Candidate k's is drawn from a ``torch.Generator``
    seeded by ``SeedSequence([spec.seed, seeds[k]])`` on the host, so
    it is a function of the spec alone — independent of the run's
    draws, of the device and of which rung the candidate reaches."""
    out = []
    for s in spec.candidates.seeds:
        state = np.random.SeedSequence(
            [int(spec.seed), int(s)]
        ).generate_state(2, np.uint32)
        g = torch.Generator()
        g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        out.append(torch.rand((), generator=g, dtype=torch.float32))
    return torch.stack(out).to(device)


def _floor_pow2(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def rank_order(sev: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """Row order by severity ascending, ties by the tie-break uniform
    ascending, then by row: the reference's ``lexsort((tb, sev))`` as
    two stable sorts."""
    by_tb = torch.argsort(tb, stable=True)
    return by_tb[torch.argsort(sev[by_tb], stable=True)]


def _rank_advance(summ, pol, tb, ids, cur, carry, rank, slo_s, keep):
    """Severity, rank order and the survivors' rows of the stacked
    inputs, carries, ids and tie-breaks, on the device."""
    from isotope_tpu_torch.compiler.compile import ensemble_take
    from isotope_tpu_torch.sim.splitting import severity_scores_device

    sev = severity_scores_device(rank, summ, slo_s, policies=pol)
    order = rank_order(sev, tb)
    surv = order[:keep]
    return (
        sev,
        order,
        ensemble_take(cur, surv),
        ensemble_take(carry, surv),
        ids.index_select(0, surv),
        tb.index_select(0, surv),
    )


def search_auto_chunk(sim, members: int, block: int,
                      connections: int, load=None,
                      jittered: bool = False) -> int:
    """The carry-aware member chunk: the fleet chunk law with the
    search carries' bytes a member on the ledger.  With the bracket's
    ``load``, a member's block bytes come from the folded pilot
    (``analysis/costmodel.fleet_member_bytes``, ``jittered`` scales);
    without one, the reference's plan-only peak."""
    from isotope_tpu_torch.analysis import costmodel

    cap = costmodel.device_capacity_bytes(device=sim.device)
    carry = costmodel.search_carry_bytes(connections)
    if load is None or cap is None:
        return costmodel.ensemble_chunk(
            members, costmodel.peak_bytes_at_block(sim, block), cap,
            carry_bytes_per_member=carry,
        )
    sizes = costmodel.fleet_member_bytes(sim, load, block,
                                         jittered=jittered)
    return costmodel.fleet_chunk(members, sizes, cap,
                                 carry_bytes_per_member=carry)


def _host(tree):
    from isotope_tpu_torch.sim.ensemble import tree_map

    return tree_map(lambda x: x.detach().cpu(), tree)


def _run_bracket(sim, spec: SearchSpec, plan, args, tables, cur, carry,
                 dispatch) -> SearchSummary:
    """The loop both brackets drive: per rung dispatch -> rank on the
    device -> gather the survivors' stacked inputs and carries ->
    continue.  ``dispatch(rp, ids, cur, carry)`` runs rung ``rp`` for
    the candidates ``ids`` (host list) and returns ``(stacked summary,
    stacked policy summary or None, carry out, chunk)``."""
    pop = spec.candidates
    dev = sim.device
    tb = tiebreak_draws(spec, dev)
    ids = torch.arange(pop.members, dtype=torch.int64, device=dev)
    ids_host = list(range(pop.members))
    lineage, chunks = [], []
    for r, rp in enumerate(plan):
        summ, pol, carry_out, chunk_sz = dispatch(rp, ids_host, cur, carry)
        keep = plan[r + 1].width if r + 1 < len(plan) else 1
        sev, order, cur, carry, ids_n, tb = _rank_advance(
            summ, pol, tb, ids, cur, carry_out, spec.rank, spec.slo_s,
            keep,
        )
        lineage.append((ids, sev, order, summ))
        chunks.append(chunk_sz)
        ids = ids_n
        if r + 1 < len(plan):
            # the survivors' draw sources are host objects
            ids_host = ids.tolist()
    lineage = _host(lineage)
    rungs = []
    for rp, (ids_r, sev_r, order_r, summ_r), chunk_sz in zip(
        plan, lineage, chunks
    ):
        ids_np = ids_r.numpy()
        order_np = order_r.numpy()
        keep = (
            plan[rp.rung + 1].width
            if rp.rung + 1 < len(plan) else 1
        )
        rungs.append(RungResult(
            rung=rp.rung,
            width=rp.width,
            chunk=int(chunk_sz),
            start_block=rp.start_block,
            num_blocks=rp.num_blocks,
            cum_requests=rp.cum_requests,
            candidates=ids_np,
            severity=sev_r.numpy(),
            survivors=ids_np[order_np[:keep]],
            summaries=summ_r,
            order=order_np,
        ))
    winner = int(rungs[-1].survivors[0])
    win_row = int(np.where(rungs[-1].candidates == winner)[0][0])
    return SearchSummary(
        spec=spec,
        block=args["block"],
        plan=plan,
        rungs=rungs,
        winner=winner,
        winner_severity=float(rungs[-1].severity[win_row]),
        offered_qps=args["offered"],
        traces=0,
        mode=tables.mode,
    )


def _plan(sim, load, num_requests: int, source, spec: SearchSpec,
          block_size: int):
    from isotope_tpu_torch.compiler.compile import compile_ensemble

    spec.check()
    sim._check_lb_load(load)
    tables = compile_ensemble(spec.candidates, sim.device)
    args = sim._ensemble_args(
        load, num_requests, source, spec.candidates, tables,
        block_size=block_size, trim=False,
    )
    return tables, args, plan_bracket(spec, num_requests, args["block"])


def run_search(sim, load, num_requests: int, source, spec: SearchSpec,
               *, block_size: int = 65_536,
               chunk: Optional[int] = None) -> SearchSummary:
    """Run one successive-halving bracket on one device.  Candidate k
    draws from ``RootedSource(source, seeds[k])``; each rung is a plain
    fleet of its survivors (folded by ``Simulator._fleet_chunks``, or
    member by member by ``Simulator._plain_fleet``) in chunks of
    ``min(bucket, floor_pow2(cap))`` members, ``cap`` = ``chunk``,
    ``spec.chunk`` or :func:`search_auto_chunk`."""
    tables, args, plan = _plan(sim, load, num_requests, source, spec,
                               block_size)
    block, conns = args["block"], args["conns"]
    cap = chunk if chunk is not None else spec.chunk
    if cap is None:
        cap = search_auto_chunk(sim, plan[0].bucket, block, conns,
                                load=load, jittered=tables.jittered)

    def dispatch(rp, ids, cur, carry):
        chunk_sz = max(1, min(rp.bucket, _floor_pow2(cap)))
        if tables.mode == "vmap":
            summ, carry_out, _, _ = sim._fleet_chunks(
                args, ids, cur, chunk_sz, False, rp.start_block,
                rp.num_blocks, carry,
            )
        else:
            summ, carry_out = sim._plain_fleet(
                args, tables, ids, False, start_block=rp.start_block,
                num_blocks=rp.num_blocks, carry=carry,
            )
        return summ, None, carry_out, chunk_sz

    # the folded rungs read the stacked inputs; "map" members read the
    # plan's host rows
    stacked = (sim._ensemble_stacked_args(args, tables)
               if tables.mode == "vmap" else None)
    return _run_bracket(
        sim, spec, plan, args, tables, stacked,
        sim.zero_ensemble_carry(spec.members, conns), dispatch,
    )


def _mesh_rungs(sh, load, num_requests: int, source, spec: SearchSpec,
                block_size: int, chunk: Optional[int],
                emulated: bool) -> SearchSummary:
    """A plain bracket whose rungs run over ``sh``'s mesh (a
    ``parallel.ShardedSimulator``): rung r's ``width`` candidates spread
    as ``sh.fleet_geometry(width, cap)`` says (``cap`` the chunk, or
    the carry-aware chunk law at ``ceil(width_0 / n_shards)``
    candidates), each rank folding its chunks; ``emulated`` walks every
    chunk on this device, in candidate order."""
    sim = sh.sim
    tables, args, plan = _plan(sim, load, num_requests, source, spec,
                               block_size)
    block, conns = args["block"], args["conns"]
    cap = chunk if chunk is not None else spec.chunk
    if cap is None:
        cap = search_auto_chunk(sim, -(-plan[0].width // sh.n_shards),
                                block, conns, load=load,
                                jittered=tables.jittered)

    def run_rows(rp, ids, cur, carry, rows, width):
        from isotope_tpu_torch.compiler.compile import ensemble_take

        idx = torch.tensor(rows, dtype=torch.int64)
        ids_r = [ids[i] for i in rows]
        cur_r = ensemble_take(cur, idx) if cur is not None else None
        carry_r = ensemble_take(carry, idx)
        if tables.mode == "vmap":
            summ, carry_out, _, _ = sim._fleet_chunks(
                args, ids_r, cur_r, width, False, rp.start_block,
                rp.num_blocks, carry_r,
            )
        else:
            summ, carry_out = sim._plain_fleet(
                args, tables, ids_r, False, start_block=rp.start_block,
                num_blocks=rp.num_blocks, carry=carry_r,
            )
        return [summ, carry_out]

    def dispatch(rp, ids, cur, carry):
        width, rounds = sh.fleet_geometry(len(ids), cap)
        if emulated:
            with telemetry.phase("sharded.emulated"):
                summ, carry_out = run_rows(rp, ids, cur, carry,
                                           list(range(len(ids))), width)
            return summ, None, carry_out, width
        shard_rows = [sh.shard_members(len(ids), width, rounds, s)
                      for s in range(sh.n_shards)]
        err = local = None
        try:
            faults.check("sharded.compute")
            # a rank with no candidate runs the rung's first as a pad
            local = run_rows(rp, ids, cur, carry,
                             shard_rows[sh.shard] or [0], width)
        except Exception as e:
            err = e
        sh._agree(err, "sharded.compute")
        summ, carry_out = sh.gather_members(local, shard_rows,
                                            rounds * width)
        sh._gather_check()
        return summ, None, carry_out, width

    # the folded rungs read the stacked inputs; "map" members read the
    # plan's host rows
    stacked = (sim._ensemble_stacked_args(args, tables)
               if tables.mode == "vmap" else None)
    return _run_bracket(
        sim, spec, plan, args, tables, stacked,
        sim.zero_ensemble_carry(spec.members, conns), dispatch,
    )


def run_search_sharded(sh, load, num_requests: int, source,
                       spec: SearchSpec, *, block_size: int = 65_536,
                       chunk: Optional[int] = None) -> SearchSummary:
    """The bracket over ``sh``'s device mesh: every rank returns the
    same lineage, :func:`run_search_emulated`'s bit for bit.  The ranks
    agree on a failure after each rung's local fleet and after its
    gather (the ``sharded.compute`` and ``sharded.gather`` sites)."""
    telemetry.counter_inc("sharded_search_runs")
    return _mesh_rungs(sh, load, num_requests, source, spec, block_size,
                       chunk, emulated=False)


def run_search_emulated(sh, load, num_requests: int, source,
                        spec: SearchSpec, *, block_size: int = 65_536,
                        chunk: Optional[int] = None) -> SearchSummary:
    """The mesh bracket's twin on one device (any
    ``parallel.EmulatedMesh``)."""
    telemetry.counter_inc("sharded_search_emulated_runs")
    return _mesh_rungs(sh, load, num_requests, source, spec, block_size,
                       chunk, emulated=True)


def run_search_protected(sim, load, num_requests: int, source,
                         spec: SearchSpec, *, roll: bool = False,
                         block_size: int = 65_536,
                         chunk: Optional[int] = None,
                         window_s: Optional[float] = None
                         ) -> SearchSummary:
    """A successive-halving bracket over a PROTECTED population: each
    candidate a full ``run_policies`` / ``run_rollouts`` member whose
    breakers, budgets, HPA and rollout controller ride the carry
    between rungs (``Simulator._protected_fleet``), so a breaker that
    tripped at the screening horizon is still open when the next rung
    resumes.  The ``trips`` channel ranks by breaker trips and budget
    ejections of the cumulative policy series.  The recorder's window
    grid is planned once over the full horizon, so rung 0's rows are
    the protected fleet's at the screening horizon.  Each rung runs its
    survivors as a protected fleet in the population's mode: folded
    ``"vmap"`` chunks (one block loop of M x N rows whose control laws
    carry (M, S) states) from the survivors' gathered input rows, as
    the plain rungs do, or member by member (``"map"``)."""
    if roll and sim._rollouts is None:
        raise ValueError(
            "protected rollout brackets need compiled rollout tables "
            "(Simulator(..., rollouts=...))"
        )
    if not roll and sim._policies is None:
        raise ValueError(
            "protected policy brackets need compiled policy tables "
            "(Simulator(..., policies=...))"
        )
    if not sim.params.timeline:
        raise ValueError(
            "protected brackets need SimParams(timeline=True) — the "
            "flight recorder is the control loop's observation side"
        )
    if sim._saturated(load):
        raise ValueError(
            "protected brackets do not support saturated -qps max "
            "loads (see run_policies)"
        )
    tables, args, plan = _plan(sim, load, num_requests, source, spec,
                               block_size)
    block, conns = args["block"], args["conns"]
    tl_plan = sim.plan_timeline_windows(
        args["num_blocks"] * block, float(args["offered"][0]), window_s,
    )
    with_pol = sim._policies is not None
    cap = chunk if chunk is not None else spec.chunk
    if cap is None:
        cap = sim.protected_ensemble_chunk(plan[0].bucket, block, tl_plan,
                                           roll, load=load,
                                           jittered=tables.jittered)

    def dispatch(rp, ids, cur, carry):
        chunk_sz = max(1, min(rp.bucket, _floor_pow2(cap)))
        cols, carry_out = sim._protected_fleet(
            args, tables, ids, roll, window_s, tl_plan, carry,
            start_block=rp.start_block, num_blocks=rp.num_blocks,
            chunk_sz=chunk_sz, stacked=cur,
        )
        # [summary, tl[, roll][, pol]] stacked; pol feeds "trips"
        pol = cols[2 + (1 if roll else 0)] if with_pol else None
        return cols[0], pol, carry_out, chunk_sz

    # the folded rungs read the stacked inputs; "map" members read the
    # plan's host rows
    stacked = (sim._ensemble_stacked_args(args, tables)
               if tables.mode == "vmap" else None)
    return _run_bracket(
        sim, spec, plan, args, tables, stacked,
        sim.zero_protected_carry(spec.members, conns, tl_plan, roll=roll),
        dispatch,
    )
