"""On-device tail-latency attribution: critical-path blame, in torch.

The port of ``isotope_tpu.metrics.attribution``.  Each request's client
latency is decomposed along the critical path of its unrolled call tree
inside the block loop, so the per-request tensors are reduced to O(H)
blame vectors and O(S * buckets) blame histograms before they leave the
device.  Nothing O(N * H) reaches the host.

Decomposition (exact, telescoping):

- the client edge contributes its wire round trip (a refused connection
  under chaos contributes exactly the refused-connect cost);
- a hop on the critical path contributes its queueing **wait** and its
  **self** time (CPU draw + sleeps + any step time the concurrent calls
  did not cover);
- at each executed call-bearing step, the *winning* call (the per-step
  ``max`` the engine's WaitGroup join takes: the lowest call index whose
  duration equals the step's maximum) passes the path to its attempts:
  an uncapped attempt charges its request+response **wire** time to the
  caller->callee edge and recurses into the callee, a timeout-capped
  attempt charges the full **timeout** to the edge and stops.

Summing every charge reproduces the client latency up to float32
accumulation order; the per-request difference is accumulated as
``residual`` (nonzero only for ungraceful-kill resets).  Tail
attribution re-weights every accumulator by ``latency >= cut``, and
exemplar mining keeps the top-K slowest requests' per-hop vectors.

Where the port's arithmetic is fixed so that the card and the CPU give
the same answer on the same :class:`SimResults`:

- a call's serial attempts are summed in attempt order (gathers, not an
  atomic scatter-add), and the winner is the first maximum through an
  integer ``amin`` scatter, so the card and the CPU pick the same call;
- the per-hop charged duration ``D`` (a scatter-add over the winning
  attempts) is summed in float64 and rounded once to float32, so the
  order of the card's atomic adds does not reach its float32 value;
- blame buckets take their log in float64 (``blame_bucket_index`` of a
  float64 tensor), so one ULP of the float32 log cannot move a value
  across a bucket edge between devices.  Against the JAX package (a
  float32 log, a float32 scatter) a value within float32 spacings of an
  edge can land one bucket over;
- every count (requests, crit counts, errors, the blame histograms) is
  an int64 sum (``index_add_`` for the histograms), exact in any order;
  the seconds-valued accumulators stay float32, as the reference's do;
- exemplars are the first K of a stable sort of ``-latency``, which
  takes equal latencies lowest index first, as ``jax.lax.top_k`` does.

On the card the sweep is one hand-written kernel, ``blame_sweep``
(``native/blame.py``, ``native/csrc/blame.cu``), which reads the block's
hop tensors once and adds its sums into the run's accumulator in a fixed
order into an :func:`accumulator`; on the CPU it is the op chain
:func:`_sweep`, and :func:`blame_sweep_sequential` is the chain with the
kernel's order of summation.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from isotope_tpu_torch.compiler.program import CompiledGraph, hop_wire_times
from isotope_tpu_torch.native import blame

F32 = torch.float32
I64 = torch.int64

# Coarse log-spaced blame buckets: per-service blame histograms are
# (S, NUM_BLAME_BUCKETS); the flight recorder's per-window latency
# histogram (metrics/timeline.py) bins with the same edges
NUM_BLAME_BUCKETS = 64
_BLO, _BHI = 1e-6, 10.0  # seconds
_B_LOG_LO = float(np.log(_BLO))
_B_INV_LOG_R = float((NUM_BLAME_BUCKETS - 2) / np.log(_BHI / _BLO))

BLAME_EDGES = np.concatenate(
    [[0.0], np.geomspace(_BLO, _BHI, NUM_BLAME_BUCKETS - 1), [np.inf]]
)


def blame_bucket_index(v: torch.Tensor) -> torch.Tensor:
    """Bucket index per value (int64): the arithmetic-index trick of
    ``metrics/histogram.bucket_index`` at the coarse width, in the
    precision of ``v``."""
    t = (torch.log(v) - _B_LOG_LO) * _B_INV_LOG_R
    t = torch.clamp(t, -1.0, NUM_BLAME_BUCKETS - 2)
    idx = torch.floor(torch.nan_to_num(t, nan=0.0)).to(torch.int64) + 1
    return torch.where(torch.isnan(t), NUM_BLAME_BUCKETS - 1, idx)


def blame_bucket_centers() -> np.ndarray:
    centers = np.empty(NUM_BLAME_BUCKETS)
    centers[0] = BLAME_EDGES[1] / 2
    centers[1:-1] = np.sqrt(BLAME_EDGES[1:-2] * BLAME_EDGES[2:-1])
    centers[-1] = BLAME_EDGES[-2]
    return centers


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ExemplarBatch(NamedTuple):
    """Top-K slowest requests' per-hop vectors, O(K * H), sorted
    slowest first (``tail_rank`` = row index)."""

    latency: torch.Tensor      # (K,)
    start: torch.Tensor        # (K,)
    error: torch.Tensor        # (K,) bool
    hop_sent: torch.Tensor     # (K, H) bool
    hop_error: torch.Tensor    # (K, H) bool
    hop_latency: torch.Tensor  # (K, H)
    hop_start: torch.Tensor    # (K, H)


def empty_exemplars(k: int, num_hops: int, device="cpu") -> ExemplarBatch:
    """The seed batch of an attributed run: latency -inf, so any real
    request displaces a seed row."""

    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ExemplarBatch(
        latency=torch.full((k,), -np.inf, dtype=F32, device=device),
        start=z(k),
        error=z(k, dtype=torch.bool),
        hop_sent=z(k, num_hops, dtype=torch.bool),
        hop_error=z(k, num_hops, dtype=torch.bool),
        hop_latency=z(k, num_hops),
        hop_start=z(k, num_hops),
    )


class AttributionSummary(NamedTuple):
    """Device-reduced critical-path blame for one run.

    Blame vectors are indexed by HOP (BFS order); per-service and
    per-edge tables are host-side groupbys (:func:`service_blame`,
    :func:`edge_blame`).  ``*_tail`` fields restrict to requests with
    client latency >= ``tail_cut`` (zero when the run had no cut).
    Counts are int64, seconds float32.
    """

    count: torch.Tensor          # scalar — requests attributed
    tail_count: torch.Tensor     # scalar — requests past the tail cut
    tail_cut: torch.Tensor       # scalar — the cut used (+inf = mean only)
    residual: torch.Tensor       # scalar — sum(client latency - attributed)
    residual_abs: torch.Tensor   # scalar — sum |client latency - attributed|
    crit_count: torch.Tensor     # (H,) times the hop was on the crit path
    wait_blame: torch.Tensor     # (H,) queueing wait on the crit path
    self_blame: torch.Tensor     # (H,) CPU + sleeps + uncovered step time
    net_blame: torch.Tensor      # (H,) wire time of the edge INTO the hop
    timeout_blame: torch.Tensor  # (H,) timeout charges on the edge into it
    error_count: torch.Tensor    # (H,) executed hops that returned 500
    tail_crit_count: torch.Tensor
    tail_wait_blame: torch.Tensor
    tail_self_blame: torch.Tensor
    tail_net_blame: torch.Tensor
    tail_timeout_blame: torch.Tensor
    hist: torch.Tensor           # (S, NUM_BLAME_BUCKETS) per-service blame
    tail_hist: torch.Tensor      # (S, NUM_BLAME_BUCKETS)
    exemplars: Optional[ExemplarBatch]

    @property
    def total_blame_s(self) -> float:
        return float(
            as_numpy(self.wait_blame).sum()
            + as_numpy(self.self_blame).sum()
            + as_numpy(self.net_blame).sum()
            + as_numpy(self.timeout_blame).sum()
        )

    @property
    def tail_total_blame_s(self) -> float:
        return float(
            as_numpy(self.tail_wait_blame).sum()
            + as_numpy(self.tail_self_blame).sum()
            + as_numpy(self.tail_net_blame).sum()
            + as_numpy(self.tail_timeout_blame).sum()
        )


# -- static tables ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _LevelTables:
    """Static index tables for one depth level's blame sweep."""

    offset: int                 # hop slice of this level in BFS order
    size: int
    child_offset: int           # hop slice of the children (level d+1)
    child_size: int
    parent_local: Optional[torch.Tensor]   # (C,) parent of each child
    call_of_child: Optional[torch.Tensor]  # (C,) call in [0, K)
    slot_of_call: Optional[torch.Tensor]   # (K,) slot in [0, n_slots)
    n_slots: int
    num_calls: int
    # attempt a of call k is child att_child[a][k]; None where every
    # call has an attempt a, else the mask (the first attempt always
    # exists); ``ident``: one attempt per call, child k is call k
    att_child: Tuple[torch.Tensor, ...]
    att_mask: Tuple[Optional[torch.Tensor], ...]
    ident: bool
    call_index: Optional[torch.Tensor]     # (K,) arange
    slot_base: Optional[torch.Tensor]      # (n_slots,) sleep floor
    child_rtt: Optional[torch.Tensor]      # (C,) request+response wire
    child_timeout: Optional[torch.Tensor]  # (C,) +inf when none
    has_timeout: bool
    svc_base: torch.Tensor      # (L,) service id * NUM_BLAME_BUCKETS


@dataclasses.dataclass(frozen=True)
class AttrTables:
    """Everything :func:`attribute_block` needs, built once per
    Simulator from the compiled graph and network model."""

    levels: Tuple[_LevelTables, ...]
    num_hops: int
    num_services: int
    root_net: float        # client->entry wire round trip
    refused_net: float     # refused-connect cost (down entry)
    sweep: blame.SweepTables  # the same structure packed for the kernel


def build_tables(compiled: CompiledGraph, net, device="cpu") -> AttrTables:
    """Lower the compiled graph's call structure into blame-sweep index
    tables on ``device``.  The sweep reads nothing but the engine's
    (N, H) outputs, so it does not depend on the level encoding (dense,
    tiled, sparse) that produced them."""
    net_out, net_back = hop_wire_times(compiled, net)
    rtt = net_out + net_back

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    H = compiled.num_hops
    # the kernel's packed tables: each hop's call-bearing steps (slots),
    # each slot's calls in call order, each call's attempts in attempt
    # order (masked attempts left out), as CSR over global hop ids
    slots_of_hop = np.zeros(H, np.int64)
    hop_bin = np.zeros(H, np.int64)
    hop_rtt = np.zeros(H, np.float32)
    hop_timeout = np.full(H, np.inf, np.float32)
    level_timeout = []
    slot_bases, calls_of_slot, atts_of_call, att_hops = [], [], [], []

    levels: List[_LevelTables] = []
    for d, lvl in enumerate(compiled.levels):
        offset = int(lvl.hop_ids[0])
        hop_bin[offset:offset + lvl.num_hops] = (
            np.asarray(lvl.service, np.int64) * NUM_BLAME_BUCKETS
        )
        common = dict(
            offset=offset, size=lvl.num_hops,
            svc_base=t(hop_bin[offset:offset + lvl.num_hops], I64),
        )
        if lvl.num_children == 0:
            level_timeout.append(False)
            levels.append(_LevelTables(
                child_offset=0, child_size=0, parent_local=None,
                call_of_child=None, slot_of_call=None, n_slots=0,
                num_calls=0, att_child=(), att_mask=(), ident=False,
                call_index=None, slot_base=None, child_rtt=None,
                child_timeout=None, has_timeout=False, **common,
            ))
            continue
        C = lvl.num_children
        K = lvl.num_calls
        parent_local = (lvl.child_seg // compiled.max_steps).astype(np.int64)
        # child -> owning call (every child is exactly one call's
        # attempt; a call's attempts are consecutive children)
        call_of_child = np.zeros(C, np.int64)
        for a in range(lvl.max_attempts):
            valid = lvl.att_valid[a]
            call_of_child[lvl.att_child[a][valid]] = np.arange(K)[valid]
        # call-bearing steps only: no (L x Pmax) dense step grid
        slot_segs = np.unique(lvl.call_seg)
        slot_of_call = np.searchsorted(slot_segs, lvl.call_seg)
        slot_base = lvl.step_base[
            slot_segs // compiled.max_steps,
            slot_segs % compiled.max_steps,
        ].astype(np.float32)
        timeout = lvl.call_timeout[call_of_child].astype(np.float32)
        ident = (
            lvl.max_attempts == 1 and K == C
            and np.array_equal(lvl.att_child[0], np.arange(K))
        )
        nxt = compiled.levels[d + 1]
        child_offset = int(nxt.hop_ids[0])
        np.add.at(slots_of_hop, offset + slot_segs // compiled.max_steps, 1)
        slot_bases.append(slot_base)
        by_slot = np.argsort(slot_of_call, kind="stable")
        calls_of_slot.append(np.bincount(slot_of_call,
                                         minlength=len(slot_segs)))
        valid = lvl.att_valid[:, by_slot].T
        atts_of_call.append(valid.sum(1))
        att_hops.append(child_offset + lvl.att_child[:, by_slot].T[valid])
        hop_rtt[child_offset:child_offset + C] = rtt[lvl.child_ids]
        hop_timeout[child_offset:child_offset + C] = timeout
        level_timeout.append(bool(np.isfinite(timeout).any()))
        levels.append(_LevelTables(
            child_offset=child_offset, child_size=C,
            parent_local=t(parent_local, I64),
            call_of_child=t(call_of_child, I64),
            slot_of_call=t(slot_of_call, I64),
            n_slots=len(slot_segs), num_calls=K,
            att_child=tuple(
                t(np.where(lvl.att_valid[a], lvl.att_child[a], 0), I64)
                for a in range(lvl.max_attempts)
            ),
            att_mask=tuple(
                None if lvl.att_valid[a].all()
                else t(lvl.att_valid[a], torch.bool)
                for a in range(lvl.max_attempts)
            ),
            ident=ident,
            call_index=t(np.arange(K), I64),
            slot_base=t(slot_base, F32),
            child_rtt=t(rtt[lvl.child_ids], F32),
            child_timeout=t(timeout, F32),
            has_timeout=bool(np.isfinite(timeout).any()),
            **common,
        ))

    def ptr(counts):
        return np.concatenate([[0], np.cumsum(np.concatenate(
            counts or [np.zeros(0, np.int64)]))])

    sweep = blame.pack_tables(
        level_offset=[lv.offset for lv in levels] + [H],
        level_timeout=level_timeout,
        slot_ptr=ptr([slots_of_hop]),
        slot_base=np.concatenate(slot_bases or [np.zeros(0, np.float32)]),
        call_ptr=ptr(calls_of_slot),
        att_ptr=ptr(atts_of_call),
        att_hop=np.concatenate(att_hops or [np.zeros(0, np.int64)]),
        hop_rtt=hop_rtt, hop_timeout=hop_timeout, hop_bin=hop_bin,
        log_lo=_B_LOG_LO, inv_log_r=_B_INV_LOG_R, device=device,
    )
    return AttrTables(
        levels=tuple(levels),
        num_hops=compiled.num_hops,
        num_services=compiled.num_services,
        root_net=float(rtt[0]),
        refused_net=float(2.0 * net.entry_one_way(0.0)),
        sweep=sweep,
    )


# -- the on-device blame sweep ----------------------------------------------


def _call_durations(lvl: _LevelTables, att_dur: torch.Tensor) -> torch.Tensor:
    """(N, K) call durations: the serial attempts of each call summed in
    attempt order (the order the reference's scatter-add adds them)."""
    if lvl.ident:
        return att_dur
    dur = None
    for child, mask in zip(lvl.att_child, lvl.att_mask):
        term = att_dur[:, child]
        if mask is not None:
            term = torch.where(mask, term, 0.0)
        dur = term if dur is None else dur + term
    return dur


def _winner_charges(lvl: _LevelTables, w, sent_c, lat_c):
    """Per-child critical-path charges at one level.

    ``w`` is the level's (N, L) crit weights; returns
    ``(D, on_crit, att_dur, capped)``: the per-parent charged duration
    and the per-child path weights and durations.
    """
    n = sent_c.shape[0]
    K, S = lvl.num_calls, lvl.n_slots
    # attempt duration exactly as the engine's call outcome: capped by
    # the call's timeout; an unsent / refused attempt costs 0
    raw = lvl.child_rtt + lat_c
    att_dur = sent_c * (
        torch.minimum(raw, lvl.child_timeout) if lvl.has_timeout else raw
    )
    dur_call = _call_durations(lvl, att_dur)
    slots = lvl.slot_of_call.expand(n, -1)
    slot_max = torch.zeros((n, S), dtype=F32, device=att_dur.device)
    slot_max = slot_max.scatter_reduce(1, slots, dur_call, "amax",
                                       include_self=True)
    beats_sleep = (slot_max >= lvl.slot_base)[:, lvl.slot_of_call]
    # the winner is the engine's WaitGroup argmax: the first maximum
    cand = torch.where(dur_call == slot_max[:, lvl.slot_of_call],
                       lvl.call_index, K)
    win_idx = torch.full((n, S), K, dtype=I64, device=att_dur.device)
    win_idx = win_idx.scatter_reduce(1, slots, cand, "amin",
                                     include_self=True)
    is_win = (lvl.call_index == win_idx[:, lvl.slot_of_call]) & beats_sleep
    on_crit = w[:, lvl.parent_local] * is_win[:, lvl.call_of_child] * sent_c
    capped = (raw > lvl.child_timeout) if lvl.has_timeout else None
    # summed in float64 and rounded once: the card's atomic order does
    # not reach the float32 value
    D = torch.zeros((n, lvl.size), dtype=torch.float64, device=w.device)
    D = D.index_add_(1, lvl.parent_local, (on_crit * att_dur).double())
    return D.to(F32), on_crit, att_dur, capped


def attribute_block(
    res,
    tables: AttrTables,
    *,
    tail_cut: Optional[float] = None,
    top_k: int = 0,
    ex_state: Optional[ExemplarBatch] = None,
    members: int = 0,
    acc: Optional[AttributionSummary] = None,
) -> Tuple[AttributionSummary, Optional[ExemplarBatch]]:
    """Reduce one block's SimResults to an AttributionSummary, added to
    the run's accumulator ``acc`` (None: the block's own summary).

    ``tail_cut`` arms the conditional-tail accumulators; ``top_k`` > 0
    merges this block's slowest requests into ``ex_state`` (returned
    beside the summary, whose ``exemplars`` is None).

    ``members = M > 0`` reduces a folded fleet block (M x N rows,
    member-major) to each member's summary and exemplars, stacked along
    a leading member axis: the sweep runs once over all rows, the row
    sums run over each member's (M, N) view (float32 sums within
    summation order of the member's solo block), the histograms bin
    with member offsets (exact), the exemplars rank within each member.

    On a CUDA tensor the ``blame_sweep`` kernel adds the block into
    ``acc`` in place (an :func:`accumulator`; None makes one) and raises
    on what it does not take; on the CPU the op chain :func:`_sweep`
    gives the block's summary and :func:`accumulate` adds it.
    """
    if res.hop_wait is None:
        raise ValueError(
            "attribution needs SimResults.hop_wait (produced by "
            "Simulator runs; synthetic SimResults must fill it)"
        )
    if res.hop_latency.device.type == "cuda":
        shape = (members, tables.num_hops, tables.num_services)
        if acc is None:
            acc = accumulator(*shape, res.hop_latency.device)
        blame.blame_sweep(res, tables,
                          *_acc_buffers(acc, *shape, res.hop_latency.device),
                          tail_cut=tail_cut, members=members)
    else:
        n = res.hop_latency.shape[0]
        part = _sweep(res, tables, tail_cut, members,
                      _member_sums(members, n), _column_sums)
        acc = accumulate(acc, part)
    if top_k > 0:
        ex_state = _update_exemplars(res, ex_state, top_k, members)
    return acc, ex_state


def blame_sweep_sequential(res, tables: AttrTables, *,
                           tail_cut: Optional[float] = None,
                           members: int = 0,
                           acc: Optional[AttributionSummary] = None,
                           ) -> AttributionSummary:
    """The ``blame_sweep`` kernel's own order of operations in plain
    torch: the op chain :func:`_sweep` with its sums taken as the kernel
    takes them (``native/blame.py`` ``kernel_sums``), then added to
    ``acc`` (:func:`accumulate`).  The kernel equals it bit for bit on
    the card."""
    n = res.hop_latency.shape[0]
    part = _sweep(res, tables, tail_cut, members,
                  *blame.kernel_sums(tables.sweep, members, n))
    return accumulate(acc, part)


def _member_sums(members: int, n: int):
    """The chain's row sum: each member's, (M, ...), in a folded block."""

    def rsum(x):
        if members:
            return x.view(members, n // members, *x.shape[1:]).sum(1)
        return x.sum(0)

    return rsum


def _column_sums(x: torch.Tensor, level: Optional[int]) -> torch.Tensor:
    """The chain's per-request sum over a level's columns."""
    return x.sum(1)


def _sweep(res, tables: AttrTables, tail_cut: Optional[float],
           members: int, rsum, colsum) -> AttributionSummary:
    """One block's summary by the op chain.  ``rsum(x)`` sums ``x`` over
    the rows (each member's); ``colsum(x, d)`` sums ``x`` over its
    columns for each request: the children of level ``d``, or a level's
    own hops where ``d`` is None.  The chain sums with torch's own
    reductions (:func:`_member_sums`, :func:`_column_sums`),
    ``native/blame.py`` ``blame_sweep_sequential`` in the kernel's order.
    """
    lat_all = res.hop_latency
    wait_all = res.hop_wait
    dev = lat_all.device
    n = lat_all.shape[0]
    M = members
    lead = (M,) if M else ()
    sent_f = res.hop_sent.to(F32)
    tail_w = (
        (res.client_latency >= tail_cut).to(F32)
        if tail_cut is not None else None
    )

    def zeros(size, dtype=F32):
        return torch.zeros(lead + (size,), dtype=dtype, device=dev)

    n_hist = tables.num_services * NUM_BLAME_BUCKETS
    # each member's histogram bins past the earlier members'
    hist_off = (
        torch.arange(M, device=dev).repeat_interleave(n // M)[:, None]
        * n_hist if M else None
    )
    net0 = torch.where(res.hop_sent[:, 0], tables.root_net,
                       tables.refused_net).to(F32)
    per_req = net0
    w = sent_f[:, :1]  # (N, 1) level 0 crit weights

    crit_l, wait_l, self_l = [], [], []
    net_l = [rsum(net0)[..., None]]
    tmo_l = [zeros(1)]
    t_crit_l, t_wait_l, t_self_l = [], [], []
    t_net_l = [
        rsum(net0 * tail_w)[..., None] if tail_w is not None else zeros(1)
    ]
    t_tmo_l = [zeros(1)]
    hist = torch.zeros(max(M, 1) * n_hist, dtype=I64, device=dev)
    t_hist = torch.zeros(max(M, 1) * n_hist, dtype=I64, device=dev)

    for d, lvl in enumerate(tables.levels):
        sl = slice(lvl.offset, lvl.offset + lvl.size)
        lat = lat_all[:, sl]
        wait = wait_all[:, sl]
        if lvl.child_size:
            csl = slice(lvl.child_offset, lvl.child_offset + lvl.child_size)
            D, on_crit, att_dur, capped = _winner_charges(
                lvl, w, sent_f[:, csl], lat_all[:, csl]
            )
            if capped is not None:
                w_next = on_crit * ~capped
                net_c = w_next * lvl.child_rtt
                tmo_c = on_crit * capped * att_dur
            else:
                w_next = on_crit
                net_c = on_crit * lvl.child_rtt
                tmo_c = None
            net_l.append(rsum(net_c))
            tmo_l.append(
                rsum(tmo_c) if tmo_c is not None else zeros(lvl.child_size)
            )
            per_req = per_req + colsum(net_c, d)
            if tmo_c is not None:
                per_req = per_req + colsum(tmo_c, d)
            if tail_w is not None:
                t_net_l.append(rsum(net_c * tail_w[:, None]))
                t_tmo_l.append(
                    rsum(tmo_c * tail_w[:, None])
                    if tmo_c is not None else zeros(lvl.child_size)
                )
            else:
                t_net_l.append(zeros(lvl.child_size))
                t_tmo_l.append(zeros(lvl.child_size))
        else:
            D = 0.0
            w_next = None

        hop_wait = w * wait
        hop_self = w * (lat - wait) - D
        contrib = hop_wait + hop_self  # == w * lat - D
        per_req = per_req + colsum(contrib, None)
        w_int = w.to(I64)
        crit_l.append(rsum(w_int))
        wait_l.append(rsum(hop_wait))
        self_l.append(rsum(hop_self))
        # clamp before bucketing: float32 accumulation can leave an
        # off-path hop's contribution a hair below zero
        flat_idx = lvl.svc_base + blame_bucket_index(
            torch.clamp(contrib, min=0.0).double()
        )
        if hist_off is not None:
            flat_idx = flat_idx + hist_off
        hist.index_add_(0, flat_idx.reshape(-1), w_int.reshape(-1))
        if tail_w is not None:
            wt_int = (w * tail_w[:, None]).to(I64)
            t_crit_l.append(rsum(wt_int))
            t_wait_l.append(rsum(hop_wait * tail_w[:, None]))
            t_self_l.append(rsum(hop_self * tail_w[:, None]))
            t_hist.index_add_(0, flat_idx.reshape(-1), wt_int.reshape(-1))
        else:
            t_crit_l.append(zeros(lvl.size, I64))
            t_wait_l.append(zeros(lvl.size))
            t_self_l.append(zeros(lvl.size))
        w = w_next

    resid = res.client_latency - per_req
    err_count = rsum(res.hop_sent & res.hop_error)

    S = tables.num_services
    summary = AttributionSummary(
        count=torch.full(lead, n // max(M, 1), dtype=I64, device=dev),
        tail_count=(
            rsum(tail_w.to(I64)) if tail_w is not None
            else torch.zeros(lead, dtype=I64, device=dev)
        ),
        tail_cut=torch.full(
            lead, tail_cut if tail_cut is not None else np.inf,
            dtype=F32, device=dev,
        ),
        residual=rsum(resid),
        residual_abs=rsum(torch.abs(resid)),
        crit_count=torch.cat(crit_l, -1),
        wait_blame=torch.cat(wait_l, -1),
        self_blame=torch.cat(self_l, -1),
        net_blame=torch.cat(net_l, -1),
        timeout_blame=torch.cat(tmo_l, -1),
        error_count=err_count,
        tail_crit_count=torch.cat(t_crit_l, -1),
        tail_wait_blame=torch.cat(t_wait_l, -1),
        tail_self_blame=torch.cat(t_self_l, -1),
        tail_net_blame=torch.cat(t_net_l, -1),
        tail_timeout_blame=torch.cat(t_tmo_l, -1),
        hist=hist.reshape(*lead, S, NUM_BLAME_BUCKETS),
        tail_hist=t_hist.reshape(*lead, S, NUM_BLAME_BUCKETS),
        exemplars=None,
    )
    return summary


def _top_rows(latency: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest latencies along the last axis,
    largest first, equal ones lowest index first (``jax.lax.top_k``'s
    order, on every device)."""
    return torch.argsort(-latency, dim=-1, stable=True)[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor, members: int):
    """Rows ``idx`` of ``x``; a folded block's (M, k) indices pick
    within each member's (M, N, ...) rows."""
    if not members:
        return x[idx]
    rows = x.view(members, -1, *x.shape[1:])
    return rows[torch.arange(members, device=x.device)[:, None], idx]


def _update_exemplars(res, ex: Optional[ExemplarBatch], k: int,
                      members: int = 0) -> ExemplarBatch:
    """Merge this block's top-K slowest requests into the carry (a
    folded block's: each member's into its own, (M, K, ...))."""
    M = members
    lat = res.client_latency
    if M:
        lat = lat.view(M, -1)
    k = min(k, lat.shape[-1])
    idx = _top_rows(lat, k)
    batch = ExemplarBatch(*(
        _take_rows(x, idx, M) for x in (
            res.client_latency, res.client_start, res.client_error,
            res.hop_sent, res.hop_error, res.hop_latency, res.hop_start,
        )
    ))
    if ex is None:
        return batch
    axis = 1 if M else 0
    merged = ExemplarBatch(*(
        torch.cat([a, b], axis) for a, b in zip(ex, batch)
    ))
    keep = _top_rows(merged.latency, k)
    if not M:
        return ExemplarBatch(*(a[keep] for a in merged))
    pick = torch.arange(M, device=keep.device)[:, None]
    return ExemplarBatch(*(a[pick, keep] for a in merged))


def _acc_layout(members: int, num_hops: int, num_services: int):
    """``{field: (buffer, offset, length, shape)}`` of an
    :func:`accumulator`'s views into its float32 (``"f"``) and int64
    (``"i"``) buffers, each member's after the earlier members' (so a
    field is contiguous, ``(M, ...)``); and the two buffers' sizes.  The
    ``blame_sweep`` kernel writes to these offsets (``csrc/blame.cu``
    ``blame_reduce_kernel``; the float32 fields in ``blame.FIELDS``'
    order)."""
    mp, h = max(members, 1), num_hops
    nb = num_services * NUM_BLAME_BUCKETS
    mh = mp * h
    lay = {}
    for k, name in enumerate(blame.FIELDS[:8]):
        lay[name] = ("f", k * mh, h, (h,))
    lay["residual"] = ("f", 8 * mh, 1, ())
    lay["residual_abs"] = ("f", 8 * mh + mp, 1, ())
    lay["tail_cut"] = ("f", 8 * mh + 2 * mp, 1, ())
    lay["crit_count"] = ("i", 0, h, (h,))
    lay["tail_crit_count"] = ("i", mh, h, (h,))
    lay["error_count"] = ("i", 2 * mh, h, (h,))
    lay["count"] = ("i", 3 * mh, 1, ())
    lay["tail_count"] = ("i", 3 * mh + mp, 1, ())
    lay["hist"] = ("i", 3 * mh + 2 * mp, nb, (num_services, NUM_BLAME_BUCKETS))
    lay["tail_hist"] = ("i", 3 * mh + 2 * mp + mp * nb, nb,
                        (num_services, NUM_BLAME_BUCKETS))
    return lay, 8 * mh + 3 * mp, 3 * mh + 2 * mp + 2 * mp * nb


def accumulator(members: int, num_hops: int, num_services: int,
                device) -> AttributionSummary:
    """An empty run accumulator for the ``blame_sweep`` kernel: zero
    sums and counts, the tail cut at -inf (each block's cut is taken
    with ``max``, as :func:`accumulate` takes it); its fields are views
    of two flat buffers laid out by :func:`_acc_layout`."""
    lay, nf, ni = _acc_layout(members, num_hops, num_services)
    nf8 = -(-nf // 2) * 2                      # the int64 buffer 8-aligned
    raw = torch.zeros(nf8 * 4 + ni * 8, dtype=torch.uint8, device=device)
    bufs = {"f": raw[:nf * 4].view(F32), "i": raw[nf8 * 4:].view(I64)}
    mp = max(members, 1)
    lead = (members,) if members else ()
    acc = AttributionSummary(**{
        name: bufs[b][off:off + mp * n].view(lead + shape)
        for name, (b, off, n, shape) in lay.items()
    }, exemplars=None)
    acc.tail_cut.fill_(-np.inf)
    return acc


def _acc_buffers(acc: AttributionSummary, members: int, num_hops: int,
                 num_services: int, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The float32 and int64 buffers of ``acc``, which must be an
    :func:`accumulator` of these shapes on ``device``."""
    lay, nf, ni = _acc_layout(members, num_hops, num_services)
    lead = (members,) if members else ()
    bases = {"f": acc.wait_blame, "i": acc.crit_count}
    for name, (b, off, _, shape) in lay.items():
        x, base = getattr(acc, name), bases[b]
        dtype = F32 if b == "f" else I64
        if (not isinstance(x, torch.Tensor) or x.device != device
                or x.dtype != dtype or tuple(x.shape) != lead + shape
                or not x.is_contiguous()
                or x.untyped_storage().data_ptr()
                != base.untyped_storage().data_ptr()
                or x.data_ptr() != base.data_ptr() + off * x.element_size()):
            raise ValueError(
                f"attribution: acc.{name} is not a view of an accumulator "
                "of these shapes (pass None, or what attribute_block "
                "returned)")
    # the fields tile each buffer from its first to its last element
    return (acc.wait_blame.as_strided((nf,), (1,)),
            acc.crit_count.as_strided((ni,), (1,)))


def accumulate(acc: Optional[AttributionSummary],
               part: AttributionSummary) -> AttributionSummary:
    """Fold one block's summary into the run's (element sums; the tail
    cut is the same constant in every block, kept)."""
    if acc is None:
        return part
    summed = [
        None if a is None else a + b
        for a, b in zip(acc._replace(exemplars=None),
                        part._replace(exemplars=None))
    ]
    return AttributionSummary(*summed)._replace(
        tail_cut=torch.maximum(acc.tail_cut, part.tail_cut)
    )


def reduce_stacked(
    parts: Sequence[AttributionSummary],
    exemplars: Optional[ExemplarBatch] = None,
) -> AttributionSummary:
    """Reduce the per-block summaries to one; ``exemplars`` is the
    final top-K state."""
    acc = None
    for p in parts:
        acc = accumulate(acc, p)
    return acc._replace(exemplars=exemplars)


def merge_exemplars_host(
    batches: Sequence[ExemplarBatch], k: Optional[int] = None
) -> ExemplarBatch:
    """Top-K merge of exemplar batches on the host (numpy)."""
    cat = ExemplarBatch(*(
        np.concatenate([as_numpy(b[i]) for b in batches])
        for i in range(len(ExemplarBatch._fields))
    ))
    k = k if k is not None else len(as_numpy(batches[0].latency))
    order = np.argsort(-cat.latency, kind="stable")[:k]
    return ExemplarBatch(*(a[order] for a in cat))


def merge_host(shards: Sequence[AttributionSummary]) -> AttributionSummary:
    """Host sum of per-shard summaries, in shard order (numpy)."""
    acc = [None if a is None else as_numpy(a)
           for a in shards[0]._replace(exemplars=None)]
    for s in shards[1:]:
        acc = [
            None if a is None else a + as_numpy(b)
            for a, b in zip(acc, s._replace(exemplars=None))
        ]
    out = AttributionSummary(*acc)._replace(
        tail_cut=as_numpy(shards[0].tail_cut)
    )
    ex = [s.exemplars for s in shards if s.exemplars is not None]
    if ex:
        out = out._replace(exemplars=merge_exemplars_host(ex))
    return out


# -- host-side tables -------------------------------------------------------


def service_blame(compiled: CompiledGraph, attr: AttributionSummary,
                  tail: bool = False) -> List[dict]:
    """Per-service blame rows (seconds + share of total blame), sorted
    by descending share."""
    hs = compiled.hop_service
    S = compiled.num_services

    def by_svc(v):
        return np.bincount(hs, weights=np.asarray(as_numpy(v), np.float64),
                           minlength=S)

    wait = by_svc(attr.tail_wait_blame if tail else attr.wait_blame)
    self_ = by_svc(attr.tail_self_blame if tail else attr.self_blame)
    net = by_svc(attr.tail_net_blame if tail else attr.net_blame)
    tmo = by_svc(attr.tail_timeout_blame if tail else attr.timeout_blame)
    crit = by_svc(attr.tail_crit_count if tail else attr.crit_count)
    errs = by_svc(attr.error_count)
    total = float(wait.sum() + self_.sum() + net.sum() + tmo.sum())
    count = float(attr.tail_count if tail else attr.count)
    rows = []
    for s in range(S):
        blame = wait[s] + self_[s] + net[s] + tmo[s]
        if blame <= 0 and crit[s] <= 0 and errs[s] <= 0:
            continue
        rows.append(
            {
                "service": compiled.services.names[s],
                "share": blame / total if total > 0 else 0.0,
                "blame_s": blame,
                "wait_s": float(wait[s]),
                "self_s": float(self_[s]),
                "net_s": float(net[s]),
                "timeout_s": float(tmo[s]),
                "crit_per_request": (
                    float(crit[s]) / count if count else 0.0
                ),
                "errors": float(errs[s]),
            }
        )
    rows.sort(key=lambda r: -r["share"])
    return rows


def edge_blame(compiled: CompiledGraph, attr: AttributionSummary,
               tail: bool = False) -> List[dict]:
    """Per caller->callee edge wire/timeout blame (the client edge is
    ``client -> <entry>``), sorted by descending blame."""
    names = compiled.services.names
    hs = compiled.hop_service
    parent = compiled.hop_parent
    net = np.asarray(
        as_numpy(attr.tail_net_blame if tail else attr.net_blame), np.float64
    )
    tmo = np.asarray(
        as_numpy(attr.tail_timeout_blame if tail else attr.timeout_blame),
        np.float64,
    )
    crit = np.asarray(
        as_numpy(attr.tail_crit_count if tail else attr.crit_count), np.float64
    )
    errs = np.asarray(as_numpy(attr.error_count), np.float64)
    agg: dict = {}
    for h in range(compiled.num_hops):
        caller = "client" if parent[h] < 0 else names[hs[parent[h]]]
        key = (caller, names[hs[h]])
        row = agg.setdefault(
            key, {"net_s": 0.0, "timeout_s": 0.0, "crit": 0.0,
                  "errors": 0.0}
        )
        row["net_s"] += net[h]
        row["timeout_s"] += tmo[h]
        row["crit"] += crit[h]
        row["errors"] += errs[h]
    out = [
        {"caller": c, "callee": e, **v}
        for (c, e), v in agg.items()
        if v["net_s"] or v["timeout_s"] or v["crit"] or v["errors"]
    ]
    out.sort(key=lambda r: -(r["net_s"] + r["timeout_s"]))
    return out


def to_doc(compiled: CompiledGraph, attr: AttributionSummary,
           top: int = 0) -> dict:
    """The ``<label>.blame.json`` artifact (``isotope-blame/v1``): mean
    and tail service/edge tables plus the invariant evidence (residual,
    counts)."""
    count = max(float(attr.count), 1.0)
    tail_on = bool(np.isfinite(float(attr.tail_cut)))
    doc = {
        "schema": "isotope-blame/v1",
        "count": float(attr.count),
        "tail_cut_s": float(attr.tail_cut) if tail_on else None,
        "tail_count": float(attr.tail_count),
        "mean_attributed_s": attr.total_blame_s / count,
        "residual_s_per_request": float(attr.residual) / count,
        "residual_abs_s_per_request": float(attr.residual_abs) / count,
        "services": service_blame(compiled, attr)[: top or None],
        "edges": edge_blame(compiled, attr)[: top or None],
    }
    if tail_on:
        doc["tail_services"] = service_blame(
            compiled, attr, tail=True
        )[: top or None]
        doc["tail_edges"] = edge_blame(compiled, attr, tail=True)[
            : top or None
        ]
    return doc


def format_table(doc: dict, top: int = 12) -> str:
    """Human-readable blame table (the ``simulate`` CLI)."""
    tail_rows = {r["service"]: r for r in doc.get("tail_services") or []}
    lines = [
        f"critical-path blame over {doc['count']:.0f} requests "
        f"(mean attributed {doc['mean_attributed_s'] * 1e3:.3f} ms, "
        f"residual {doc['residual_abs_s_per_request'] * 1e6:.3f} us/req)"
    ]
    if doc.get("tail_cut_s") is not None:
        lines.append(
            f"tail cut: {doc['tail_cut_s'] * 1e3:.3f} ms "
            f"({doc['tail_count']:.0f} requests past it)"
        )
    hdr = (
        f"{'service':<24} {'share':>7} {'wait':>9} {'self':>9} "
        f"{'net':>9} {'timeout':>9}"
    )
    if tail_rows:
        hdr += f" {'tail share':>10}"
    lines.append(hdr)
    for r in doc["services"][:top]:
        line = (
            f"{r['service']:<24} {r['share'] * 100:>6.1f}% "
            f"{r['wait_s']:>9.4f} {r['self_s']:>9.4f} "
            f"{r['net_s']:>9.4f} {r['timeout_s']:>9.4f}"
        )
        t = tail_rows.get(r["service"])
        if tail_rows:
            line += f" {t['share'] * 100:>9.1f}%" if t else f" {'-':>10}"
        lines.append(line)
    return "\n".join(lines)


def exemplar_results(attr: AttributionSummary):
    """A :class:`~isotope_tpu_torch.sim.engine.SimResults` view of the
    mined exemplars on the CPU, so the trace exporters accept them
    without a dense re-run (rows stay slowest-first; the run-level
    fields are zeroed)."""
    from isotope_tpu_torch.sim.engine import SimResults

    ex = attr.exemplars
    if ex is None:
        raise ValueError(
            "attribution summary carries no exemplars (run with "
            "attribution_top_k > 0)"
        )
    cpu = ExemplarBatch(*(torch.as_tensor(as_numpy(x)) for x in ex))
    k, h = cpu.hop_latency.shape
    return SimResults(
        client_start=cpu.start,
        client_latency=cpu.latency,
        client_error=cpu.error,
        hop_sent=cpu.hop_sent,
        hop_error=cpu.hop_error,
        hop_latency=cpu.hop_latency,
        hop_start=cpu.hop_start,
        utilization=torch.zeros(1, dtype=F32),
        unstable=torch.zeros(1, dtype=torch.bool),
        offered_qps=torch.tensor(0.0, dtype=F32),
        hop_wait=torch.zeros((k, h), dtype=F32),
    )
