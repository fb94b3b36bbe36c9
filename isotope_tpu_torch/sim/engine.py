"""The vectorized event-tree simulation engine, in torch.

The port of ``isotope_tpu.sim.engine``'s main path.  One block of
requests is one tensor program over a (request x hop) grid:

- an upward sweep over the depth levels of the unrolled call tree
  computes each hop's server-side duration: concurrent fan-outs join by
  a scatter-max census per (parent, step) slot, serial retry attempts
  sum, a finite timeout clamps and transport-fails an attempt, and the
  census join (max with the sleep floor, step mask, fail/error
  truncation, row sum, exclusive step prefix) runs in the hand-written
  CUDA kernel of ``native/census.py`` on the card;
- a downward sweep decides which hops were actually sent, and a second
  one assigns absolute start times;
- arrivals are a Poisson cumsum (open loop) or per-connection pacing
  (closed loop, Fortio's workers);
- queueing waits are sampled from the M/M/k law at each service's
  offered load, with the sibling, hierarchical and retry Gaussian
  copulas of the reference.

Random numbers come from a draw source (``sim/draws.py``), so the same
draws can drive this engine and the JAX one.  The JAX engine groups
close-shaped levels into ``lax.scan`` buckets to bound its trace size;
this port sweeps every level one by one, which computes the same
values (the JAX package pins buckets against unrolled levels).

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): chaos, churn, mTLS, policies, rollouts, lb laws,
attribution, timelines, ensembles, the saturated ``-qps max`` closed
loop, and levels whose step encoding is tiled or sparse.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isotope_tpu_torch.compiler import buckets
from isotope_tpu_torch.compiler.program import CompiledGraph, hop_wire_times
from isotope_tpu_torch.native.census import census
from isotope_tpu_torch.sim import queueing
from isotope_tpu_torch.sim.config import (
    CLOSED_LOOP,
    OPEN_LOOP,
    SERVICE_TIME_DETERMINISTIC,
    SERVICE_TIME_LOGNORMAL,
    SERVICE_TIME_PARETO,
    LoadModel,
    SimParams,
)
from isotope_tpu_torch.sim.draws import (
    BLOCK_INDEX_BASE,
    SVC_EXPONENTIAL,
    SVC_NORMAL,
    Draws,
    DrawSpec,
)
from isotope_tpu_torch.sim.feedback import RetryFeedback

F32 = torch.float32


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to isotope_tpu_torch yet "
        f"(ROADMAP.md queue 1: {item})"
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another one.  Without a GPU and without an explicit device this
    raises instead of quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "isotope_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class SimResults(NamedTuple):
    """Raw per-request / per-hop outcomes of one simulated block.

    Hop axis order is the compiled BFS order (level-concatenated).  All
    times are seconds; ``hop_start`` is when the request arrives at the
    service (before queueing), ``hop_latency`` the server-side duration
    (wait + script + cpu).
    """

    client_start: torch.Tensor    # (N,) client send time
    client_latency: torch.Tensor  # (N,) client-observed round trip
    client_error: torch.Tensor    # (N,) bool — entry returned a 500
    hop_sent: torch.Tensor        # (N, H) bool — hop actually executed
    hop_error: torch.Tensor       # (N, H) bool — hop returned 500 (where sent)
    hop_latency: torch.Tensor     # (N, H) f32
    hop_start: torch.Tensor       # (N, H) f32
    utilization: torch.Tensor     # (S,) rho per service at the offered load
    unstable: torch.Tensor        # (S,) bool — offered load >= capacity
    offered_qps: torch.Tensor     # scalar f32 — the rate the queues saw

    @property
    def client_end(self) -> torch.Tensor:
        return self.client_start + self.client_latency

    @property
    def hop_events(self) -> torch.Tensor:
        """Total executed hops — the benchmark's unit of work."""
        return self.hop_sent.sum()


@dataclasses.dataclass(frozen=True)
class _Level:
    """Device-resident constants for one depth level (dense encoding)."""

    offset: int                     # start of this level's slice in hop order
    size: int
    pmax: int
    step_mask: torch.Tensor         # (L, Pmax) f32 — 1 where a real step
    step_base: torch.Tensor         # (L, Pmax) f32
    child_seg: torch.Tensor         # (C,) i64 — parent_local * Pmax + step
    child_parent_local: torch.Tensor  # (C,) i64
    child_step: torch.Tensor        # (C,) i32 — step index within the parent
    child_rtt: torch.Tensor         # (C,) f32 — request + response wire time
    child_net_out: torch.Tensor     # (C,) f32 — one-way request wire time
    child_send_prob: torch.Tensor   # (C,) f32
    call_seg: torch.Tensor          # (K,) i64 — parent_local * Pmax + step
    call_hop: torch.Tensor          # (K,) i64 — parent_local
    call_step: torch.Tensor         # (K,) i32
    call_timeout: torch.Tensor      # (K,) f32, +inf when none
    att_child: Tuple[torch.Tensor, ...]  # per attempt: (K,) i64 in [0, C]
    att_valid: Tuple[torch.Tensor, ...]  # per attempt: (K,) bool
    # single-attempt levels where call k's only child is child k: the
    # attempt loop degenerates to elementwise ops
    ident_attempts: bool = False
    # any call with a finite timeout (else timeouts can't fire)
    finite_timeout: bool = False
    # c when call_seg == repeat(arange(size*pmax), c): the per-step
    # aggregation is a reshape-reduce instead of a scatter
    uniform_calls: Optional[int] = None
    # call-free levels: busy time is fully static — (L,) seconds
    leaf_busy: Optional[torch.Tensor] = None

    @property
    def num_children(self) -> int:
        return len(self.child_seg)

    @property
    def num_calls(self) -> int:
        return len(self.call_seg)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, accurate in both tails in float32.

    ``torch.special.ndtr`` computes ``(1 + erf(x / sqrt 2)) / 2`` and
    loses all relative precision in the lower tail (it returns 0 at
    x = -6 in float32, which would turn a wait draw into a 46/rate
    outlier).  This is the reference's formulation: ``erfc`` of |x|
    away from the centre.
    """
    half_sqrt_2 = float(np.float32(0.5) * np.sqrt(np.float32(2.0)))
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(
        z < half_sqrt_2,
        1.0 + torch.erf(w),
        torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)),
    )
    return 0.5 * y


def _call_outcome(t, timeout):
    """(transport_failure, duration) of one call attempt.

    A finite ``timeout`` clamps the round trip ``t`` and fails the call
    past it; ``None`` means no timeout can fire, and then no transport
    failure can occur (a down callee, the other transport failure of the
    reference, comes with the chaos slice).
    """
    if timeout is None:
        return None, t
    return t > timeout, torch.minimum(t, timeout)


class Simulator:
    """Holds a compiled graph's device tables and runs blocks on them."""

    def __init__(
        self,
        compiled: CompiledGraph,
        params: SimParams = SimParams(),
        chaos=(),
        churn=(),
        mtls=None,
        policies=None,
        rollouts=None,
        lb=None,
        *,
        device=None,
    ):
        if chaos or churn or mtls is not None:
            raise _unsupported(
                "chaos, traffic-split churn and mTLS schedules",
                "scenario physics inside _simulate_core",
            )
        if lb is not None:
            raise _unsupported("lb laws", "sim/lb.py")
        if policies is not None or rollouts is not None:
            raise _unsupported(
                "policies and rollouts", "protected layers"
            )
        if params.attribution or params.timeline:
            raise _unsupported(
                "attribution and the timeline recorder", "observability"
            )
        if params.ensemble:
            raise _unsupported("scenario ensembles", "fleets")
        self.device = resolve_device(device)
        dev = self.device
        self.compiled = compiled
        self.params = params
        t = compiled.services
        net = params.network
        self._k_max = int(t.replicas.max())
        self._mu = 1.0 / params.cpu_time_s

        # -- offered load: one phase, one traffic combo ---------------------
        visits_np = compiled.expected_visits()
        self._visits = torch.tensor(visits_np, dtype=F32, device=dev)
        self._visits_pc_np = visits_np[None, :]
        self._visits_pc = torch.tensor(
            self._visits_pc_np, dtype=F32, device=dev
        )
        self._replicas_pc = torch.tensor(
            np.maximum(t.replicas.astype(np.int64), 1)[None, :],
            dtype=torch.int32, device=dev,
        )

        # -- retry-storm feedback (load-dependent visits) -------------------
        # With finite call timeouts the retry/truncation probabilities
        # are load-dependent, so the visit table is a per-rate fixed
        # point (sim/feedback.py); without them the static table is exact.
        self._feedback = None
        if any(
            bool(np.isfinite(l.call_timeout).any()) for l in compiled.levels
        ):
            self._feedback = RetryFeedback(
                compiled, params, self._mu,
                np.maximum(t.replicas.astype(np.int64), 1)[None, :],
                np.zeros((1, compiled.num_services), bool),
                np.ones((1, compiled.num_hops)),
                self._visits_pc_np,
            )
            if not self._feedback.active:  # pragma: no cover - guard match
                self._feedback = None

        hs = compiled.hop_service
        self._hop_service = torch.tensor(hs, dtype=torch.int64, device=dev)
        self._hop_err_rate = torch.tensor(
            t.error_rate[hs], dtype=F32, device=dev
        )
        net_out, net_back = hop_wire_times(compiled, net)
        self._root_net = float(net_out[0] + net_back[0])
        self._entry_one_way = net.entry_one_way(0.0)

        # -- static RNG elimination -----------------------------------------
        # Coins that cannot land both ways are not drawn: no sub-1 send
        # probability -> no send coins, no errorRate -> no error coins.
        self._need_send = bool((compiled.hop_send_prob[1:] < 1.0).any())
        self._need_err = bool((t.error_rate[hs] > 0.0).any())

        def tensor(x, dtype):
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        levels: List[_Level] = []
        offset = 0
        for lvl in compiled.levels:
            cids = lvl.child_ids
            # per-level step width: the widest script among THIS level's
            # services, not the graph-wide max_steps stride
            pmax = max(int(lvl.step_is_real.sum(1).max(initial=0)), 1)
            parent_local = lvl.child_seg // compiled.max_steps
            child_step = lvl.child_seg % compiled.max_steps
            call_local = lvl.call_seg // compiled.max_steps
            call_step = lvl.call_seg % compiled.max_steps
            n_calls = len(lvl.call_seg)
            ident = (
                lvl.att_child.shape[0] == 1
                and n_calls == len(cids)
                and bool(lvl.att_valid.all())
                and np.array_equal(
                    lvl.att_child[0], np.arange(n_calls, dtype=np.int32)
                )
            )
            call_seg_p = call_local * pmax + call_step
            slots = lvl.num_hops * pmax
            uniform: Optional[int] = None
            if n_calls > 0 and n_calls % slots == 0:
                c = n_calls // slots
                if np.array_equal(
                    call_seg_p, np.repeat(np.arange(slots), c)
                ):
                    uniform = c
            sleep_real = lvl.step_is_real.astype(np.float64) * (
                lvl.step_base
            )
            leaf_busy = None
            if n_calls == 0:
                leaf_busy = tensor(sleep_real.sum(1), F32)
            else:
                enc, _ = buckets.level_encoding(
                    lvl.num_hops, pmax, len(np.unique(call_seg_p)),
                    lvl.step_is_real[:, :pmax].sum(1),
                    sparse_level_elems=params.sparse_level_elems,
                    tiling=params.sparse_tiling,
                    tile_pmax=params.sparse_tile_pmax,
                )
                if enc != "dense":
                    raise _unsupported(
                        f"a level with the {enc!r} step encoding",
                        "tiled and sparse levels",
                    )
            levels.append(
                _Level(
                    offset=offset,
                    size=lvl.num_hops,
                    pmax=pmax,
                    step_mask=tensor(lvl.step_is_real[:, :pmax], F32),
                    step_base=tensor(lvl.step_base[:, :pmax], F32),
                    child_seg=tensor(
                        parent_local * pmax + child_step, torch.int64
                    ),
                    child_parent_local=tensor(parent_local, torch.int64),
                    child_step=tensor(child_step, torch.int32),
                    child_rtt=tensor(
                        net_out[cids] + net_back[cids], F32
                    ),
                    child_net_out=tensor(net_out[cids], F32),
                    child_send_prob=tensor(
                        compiled.hop_send_prob[cids], F32
                    ),
                    call_seg=tensor(call_seg_p, torch.int64),
                    call_hop=tensor(call_local, torch.int64),
                    call_step=tensor(call_step, torch.int32),
                    call_timeout=tensor(lvl.call_timeout, F32),
                    att_child=tuple(
                        tensor(a, torch.int64) for a in lvl.att_child
                    ),
                    att_valid=tuple(
                        tensor(v, torch.bool) for v in lvl.att_valid
                    ),
                    ident_attempts=ident,
                    finite_timeout=bool(
                        np.isfinite(lvl.call_timeout).any()
                    ),
                    uniform_calls=uniform,
                    leaf_busy=leaf_busy,
                )
            )
            offset += lvl.num_hops
        self._levels: Tuple[_Level, ...] = tuple(levels)
        self._track_err = self._need_err or any(
            bool(np.isfinite(l.call_timeout).any()) for l in compiled.levels
        )

        # -- sibling copula: static hop -> group id map ---------------------
        # Concurrent sibling hops (children spawned by the same parent
        # step, retry attempts included) share correlated wait draws.
        # Group normals are drawn as (n, G) and expanded by a static
        # column gather; hops outside any group get their own slot.
        group = np.zeros(compiled.num_hops, np.int64)
        n_multi = 0
        off = 1  # hop 0 is the root; level d's children follow in order
        gid = {("root",): 0}
        gparent = [0]  # group -> parent group (the root group is its own)
        for d, lvl in enumerate(compiled.levels):
            segs = np.asarray(lvl.child_seg)
            counts: Dict[int, int] = {}
            for seg in segs:
                counts[int(seg)] = counts.get(int(seg), 0) + 1
            for local, seg in enumerate(segs):
                key = (d, int(seg))
                if key not in gid:
                    gid[key] = len(gid)
                    parent_hop = lvl.hop_ids[
                        int(seg) // compiled.max_steps
                    ]
                    gparent.append(int(group[parent_hop]))
                    if counts[int(seg)] > 1:
                        n_multi += 1
                group[off + local] = gid[key]
            off += lvl.num_children
        self._sib_group = torch.tensor(group, device=dev)
        self._num_sib_groups = len(gid)
        self._copula_active = n_multi > 0 and params.sibling_copula_r > 0.0

        # -- hierarchical copula mix (SimParams.hierarchical_copula_gamma) --
        # Same-depth sibling groups whose lowest common ancestor sits L
        # levels up correlate at gamma^L; groups at different depths stay
        # independent.  Every (ancestor group, depth offset) pair gets its
        # own unit normal; only multi-member groups join the hierarchy.
        self._copula_mix = None
        self._copula_rows = None
        self._copula_dim = len(gid)
        gamma = params.hierarchical_copula_gamma
        sizes = np.bincount(group, minlength=len(gid))
        active_groups = np.nonzero(sizes > 1)[0]
        if (
            self._copula_active
            and gamma > 0.0
            and len(gid) > 1
            and len(active_groups)
        ):
            G = len(gid)
            pair_idx: Dict[Tuple[int, int], int] = {}
            rows = []  # (row-in-A, factor, coeff)
            for i, g in enumerate(active_groups):
                w, a, lev = 1.0, int(g), 0
                while a != 0:
                    if lev == 0:
                        f = a  # own base factor
                    else:
                        key = (a, lev)
                        if key not in pair_idx:
                            pair_idx[key] = G + len(pair_idx)
                        f = pair_idx[key]
                    rows.append((i, f, np.sqrt(w * (1.0 - gamma))))
                    w *= gamma
                    a = gparent[a]
                    lev += 1
                key = (0, lev)
                if key not in pair_idx:
                    pair_idx[key] = G + len(pair_idx)
                rows.append((i, pair_idx[key], np.sqrt(w)))
            mix = np.zeros((len(active_groups), G + len(pair_idx)))
            for i, f, c in rows:
                mix[i, f] = c
            self._copula_mix = tensor(mix, F32)
            self._copula_rows = tensor(active_groups, torch.int64)
            self._copula_dim = G + len(pair_idx)

        # -- retry copula: static hop -> call-group map ---------------------
        # Serial retry attempts of ONE call share an extra normal on top
        # of the sibling term; hops outside any multi-attempt call carry
        # weight 0 and gather a sentinel column.
        rg = np.zeros(compiled.num_hops, np.int64)
        in_rg = np.zeros(compiled.num_hops, bool)
        n_rg = 0
        for lvl in compiled.levels:
            if not len(lvl.call_seg):
                continue
            att_counts = lvl.att_valid.sum(0)
            for k in np.nonzero(att_counts > 1)[0]:
                gids = lvl.child_ids[lvl.att_child[lvl.att_valid[:, k], k]]
                rg[gids] = n_rg
                in_rg[gids] = True
                n_rg += 1
        self._retry_group = torch.tensor(
            np.where(in_rg, rg, n_rg), device=dev
        )
        self._num_retry_groups = n_rg
        self._retry_active = n_rg > 0 and params.retry_copula_r > 0.0
        if self._retry_active and (
            params.sibling_copula_r + params.retry_copula_r >= 1.0
        ):
            raise ValueError(
                "sibling_copula_r + retry_copula_r must be < 1 when the "
                "topology has multi-attempt calls (both correlations "
                "apply to retry hops)"
            )
        retry_w = np.where(
            in_rg, np.sqrt(params.retry_copula_r), 0.0
        ).astype(np.float32)
        # per-hop weights of the copula terms, computed on the host in
        # the reference's float precision
        r = params.sibling_copula_r if self._copula_active else 0.0
        own_sq = 1.0 - r
        if self._retry_active:
            own_sq = own_sq - retry_w**2
        self._retry_w = tensor(retry_w, F32)
        self._sib_w = float(np.sqrt(r))
        self._own_w = (
            tensor(np.sqrt(own_sq), F32)
            if self._retry_active
            else float(np.sqrt(own_sq))
        )
        self._rate_cache: Dict[tuple, float] = {}

    # -- draws ------------------------------------------------------------

    def draw_spec(self, n: int, kind: str) -> DrawSpec:
        """The random tensors one block of ``n`` requests consumes."""
        copula = self._copula_active or self._retry_active
        kind_svc = self.params.service_time
        if kind_svc == SERVICE_TIME_DETERMINISTIC:
            svc = None
        elif kind_svc == SERVICE_TIME_LOGNORMAL:
            svc = SVC_NORMAL
        else:  # exponential and pareto both start from unit exponentials
            svc = SVC_EXPONENTIAL
        return DrawSpec(
            n=n,
            hops=self.compiled.num_hops,
            need_send=self._need_send,
            need_err=self._need_err,
            copula=copula,
            sib_dim=(
                (
                    self._copula_dim
                    if self._copula_mix is not None
                    else self._num_sib_groups
                )
                if self._copula_active
                else 0
            ),
            retry_dim=(
                self._num_retry_groups + 1 if self._retry_active else 0
            ),
            svc=svc,
            arrivals=kind == OPEN_LOOP,
        )

    def _draws(self, source, index: Optional[int], n: int,
               kind: str) -> Draws:
        spec = self.draw_spec(n, kind)
        draws = source.draws(index, spec).to(self.device)
        draws.check(spec)
        return draws

    # -- public entry points ----------------------------------------------

    def _vis_arg(self, offered: float) -> torch.Tensor:
        """The (1, S) visit table the queues see at ``offered``: the
        static table, or the retry-feedback fixed point at that rate."""
        if self._feedback is None:
            return self._visits_pc
        return torch.tensor(
            self._feedback.visits_pc(float(offered)), dtype=F32,
            device=self.device,
        )

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=F32, device=self.device)

    @staticmethod
    def _check_load(load: LoadModel) -> None:
        if load.kind == CLOSED_LOOP and load.qps is None:
            raise _unsupported(
                "the saturated closed loop (-qps max, sim/closed.py)",
                "closed loop",
            )

    def run(
        self,
        load: LoadModel,
        num_requests: int,
        source,
    ) -> SimResults:
        """Simulate ``num_requests`` under ``load`` with draws from
        ``source`` (its index ``None``).

        Open loop: the queues see exactly ``load.qps``.  Paced closed
        loop: the rate the queues see is latency-dependent, solved by
        :meth:`solve_closed_rate` before the run.
        """
        self._check_load(load)
        if load.kind == OPEN_LOOP:
            res, _, _ = self._simulate_core(
                num_requests, OPEN_LOOP, 0,
                self._draws(source, None, num_requests, OPEN_LOOP),
                self._scalar(load.qps), self._scalar(0.0),
                self._scalar(load.qps), self._scalar(0.0),
                torch.zeros(1, dtype=F32, device=self.device),
                visits_pc=self._vis_arg(load.qps),
            )
            return res
        lam = self.solve_closed_rate(load, num_requests, source)
        c = load.connections
        res, _, _ = self._simulate_core(
            num_requests, CLOSED_LOOP, c,
            self._draws(source, None, num_requests, CLOSED_LOOP),
            self._scalar(lam), self._scalar(c / load.qps),
            self._scalar(lam), self._scalar(0.0),
            torch.zeros(c, dtype=F32, device=self.device),
            visits_pc=self._vis_arg(lam),
        )
        return res

    def solve_closed_rate(
        self,
        load: LoadModel,
        num_requests: int,
        source,
    ) -> float:
        """Equilibrium offered rate of Fortio's paced closed loop.

        ``g(lam) = min(qps, C / E[latency(lam)]) - lam`` is strictly
        decreasing with one root, found by bisection over short pilot
        runs (pilot ``i`` draws from index ``i`` of ``source``).  The
        rate is memoized per load shape.
        """
        self._check_load(load)
        cache_key = (load.qps, load.connections, min(num_requests, 2048))
        if cache_key in self._rate_cache:
            return self._rate_cache[cache_key]
        cap = 0.999 * self.capacity_qps()
        hi = min(load.qps, cap)
        pilot_n = min(num_requests, 2048)
        c = load.connections
        gap = self._scalar(c / load.qps)

        def implied(lam: float, i: int) -> float:
            res, _, _ = self._simulate_core(
                pilot_n, CLOSED_LOOP, c,
                self._draws(source, i, pilot_n, CLOSED_LOOP),
                self._scalar(lam), gap, self._scalar(lam),
                self._scalar(0.0),
                torch.zeros(c, dtype=F32, device=self.device),
                visits_pc=self._vis_arg(lam),
            )
            mean_lat = float(res.client_latency.mean())
            return min(c / max(mean_lat, 1e-9), load.qps)

        if implied(hi, 0) >= hi:
            # pacing (or capacity) binds before self-throttling
            self._rate_cache[cache_key] = hi
            return hi
        lo = 0.0
        for i in range(1, 12):  # the reference's 4 x 3 fixed-point iterations
            mid = 0.5 * (lo + hi)
            if implied(mid, i) >= mid:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-3 * hi:
                break
        lam = 0.5 * (lo + hi)
        self._rate_cache[cache_key] = lam
        return lam

    def run_summary(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        trim: bool = False,
    ):
        """Simulate >= ``num_requests`` in memory-bounded blocks and
        reduce them to one :class:`~isotope_tpu_torch.sim.summary.RunSummary`.

        A Python loop over blocks carries the open-loop clock ``t0`` and
        the per-connection clocks ``conn_t0`` from one block to the
        next, so the blocks form one continuous timeline; block ``b``
        draws from index ``1_000_000 + b`` of ``source``.  ``trim=True``
        also accumulates the collector's steady-state window (skip 62s,
        cap 180s) into the ``win_*`` fields, placed from the run's
        expected duration.  The per-service Prometheus series (the
        reference's ``collector``) come with a later slice.
        """
        from isotope_tpu_torch.metrics.fortio import trim_window_bounds
        from isotope_tpu_torch.sim import summary as summary_mod

        self._check_load(load)
        if load.kind == OPEN_LOOP:
            offered = float(load.qps)
            pace = 0.0
            conns = 0
            block = max(1, min(block_size, num_requests))
        else:
            conns = load.connections
            offered = self.solve_closed_rate(load, num_requests, source)
            pace = conns / load.qps
            # each connection needs at least one request per block, so
            # when connections > block_size the block grows to them
            per = max(1, min(block_size, num_requests) // conns)
            block = per * conns
        num_blocks = max(1, -(-num_requests // block))
        window = (
            trim_window_bounds(num_blocks * block, offered) if trim else None
        )
        visits_pc = self._vis_arg(offered)
        offered_t = self._scalar(offered)
        pace_t = self._scalar(pace)
        t0 = self._scalar(0.0)
        conn_t0 = torch.zeros(max(conns, 1), dtype=F32, device=self.device)
        win = (
            (self._scalar(window[0]), self._scalar(window[1]))
            if window is not None
            else None
        )
        parts = []
        for b in range(num_blocks):
            res, t0, conn_t0 = self._simulate_core(
                block, load.kind, conns,
                self._draws(source, BLOCK_INDEX_BASE + b, block, load.kind),
                offered_t, pace_t, offered_t, t0, conn_t0,
                visits_pc=visits_pc,
            )
            parts.append(summary_mod.summarize(res, window=win))
        return summary_mod.reduce_stacked(summary_mod.stack(parts))

    def default_block_size(self, budget_elems: int = 33_554_432) -> int:
        """A block size keeping each (block, H) event tensor near
        ``budget_elems`` elements (~128 MiB at f32)."""
        h = max(self.compiled.num_hops, 1)
        return int(max(256, min(524_288, budget_elems // h)))

    def census_shapes(self, n: int) -> List[Tuple[int, int, int, bool, bool]]:
        """``(N, B, P, fail, err)`` of each census call one block of ``n``
        requests makes, in call order: one per level with children,
        with a fail step where a call has a finite timeout and error
        coins where a hop has a nonzero error rate."""
        return [
            (n, lvl.size, lvl.pmax, lvl.finite_timeout, self._need_err)
            for lvl in reversed(self._levels)
            if lvl.num_children > 0
        ]

    def capacity_qps(self) -> float:
        """Saturation throughput: the bottleneck station's capacity."""
        t = self.compiled.services
        visits = self._visits.cpu().numpy()
        with np.errstate(divide="ignore"):
            per_svc = np.where(
                visits > 0,
                t.replicas * self._mu / np.maximum(visits, 1e-30),
                np.inf,
            )
        return float(per_svc.min())

    def _sample_service_time(self, draw: Optional[torch.Tensor], n: int):
        """Per-hop CPU time with mean ``cpu_time_s`` from the unit draws.

        Heavy-tail options (lognormal sigma, Pareto alpha) are scaled so
        the mean stays the configured CPU demand.
        """
        mean = self.params.cpu_time_s
        kind = self.params.service_time
        p = self.params.service_time_param
        if kind == SERVICE_TIME_DETERMINISTIC:
            return torch.full(
                (n, self.compiled.num_hops), mean, dtype=F32,
                device=self.device,
            )
        if kind == SERVICE_TIME_LOGNORMAL:
            return torch.exp(p * draw - 0.5 * p * p) * mean
        if kind == SERVICE_TIME_PARETO:
            return torch.exp(draw / p) * (mean * (p - 1.0) / p)
        return draw * mean

    # -- the tensor program ------------------------------------------------

    def _simulate_core(
        self,
        n: int,
        kind: str,
        connections: int,
        draws: Draws,
        offered_qps: torch.Tensor,
        pace_gap: torch.Tensor,
        arrival_qps: torch.Tensor,
        t0: torch.Tensor,
        conn_t0: torch.Tensor,
        visits_pc: Optional[torch.Tensor] = None,
    ) -> Tuple[SimResults, torch.Tensor, torch.Tensor]:
        """One block of ``n`` requests; returns ``(results, t_end,
        conn_end)`` for the next block's clocks.

        ``offered_qps`` drives the queueing model, ``arrival_qps`` paces
        the open-loop arrival stream; ``t0`` / ``conn_t0`` are the
        block's starting clocks.
        """
        dev = self.device
        zero = torch.zeros((), dtype=F32, device=dev)
        u_send, u_err = draws.u_send, draws.u_err

        # ---- wait draws: copulas in normal space, then U(0,1) marginals
        if self._copula_active or self._retry_active:
            z_wait = zero
            if self._copula_active:
                z_small = draws.z_small
                if self._copula_mix is not None:
                    z_act = torch.matmul(z_small, self._copula_mix.T)
                    z_groups = z_small[:, : self._num_sib_groups].clone()
                    z_groups[:, self._copula_rows] = z_act
                else:
                    z_groups = z_small[:, : self._num_sib_groups]
                z_wait = z_wait + self._sib_w * z_groups[:, self._sib_group]
            if self._retry_active:
                z_wait = z_wait + (
                    self._retry_w * draws.z_call[:, self._retry_group]
                )
            z_wait = z_wait + self._own_w * draws.z_h
            u_wait = ndtr(z_wait)
        else:
            u_wait = draws.u_wait

        # ---- open-loop arrival times -----------------------------------
        if kind == OPEN_LOOP:
            gaps = draws.arr / arrival_qps
            arrivals = t0 + torch.cumsum(gaps, 0)
        else:
            arrivals = None  # closed-loop arrivals derive from latencies

        # ---- queueing parameters (one phase) ----------------------------
        if visits_pc is None:
            visits_pc = self._visits_pc
        lam_pc = offered_qps * visits_pc
        qp = queueing.mmk_params(
            lam_pc, self._mu, self._replicas_pc, self._k_max
        )
        hop_svc = self._hop_service
        p_wait_nh = qp.p_wait[0][hop_svc][None, :]
        wait_rate_nh = qp.wait_rate[0][hop_svc][None, :]
        wait = queueing.sample_wait_conditional(
            p_wait_nh, wait_rate_nh, u_wait
        )  # (N, H)
        svc_time = self._sample_service_time(draws.svc, n)
        err_coin = None if u_err is None else u_err < self._hop_err_rate

        # ---- upward pass: outcomes + server-side durations ---------------
        # Deepest level first, so every call site sees its callees'
        # (hypothetical) latency and status.  ``None`` sentinels carry
        # static knowledge: err_lvls[d] is None when no hop can 500,
        # fail_lvls[d] when no call can transport-fail, used_lvls[d]
        # when every call is deterministically sent.
        L = len(self._levels)
        lat_lvls: List[Optional[torch.Tensor]] = [None] * L
        err_lvls: List[Optional[torch.Tensor]] = [None] * L
        fail_lvls: List[Optional[torch.Tensor]] = [None] * L
        used_lvls: List[Optional[torch.Tensor]] = [None] * L
        off_lvls: List[Optional[torch.Tensor]] = [None] * L
        for d in reversed(range(L)):
            lvl = self._levels[d]
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            err_lvl = (
                err_coin[:, sl].contiguous() if err_coin is not None else None
            )
            P = lvl.pmax
            fail_step = None
            if lvl.num_children > 0:
                nxt = self._levels[d + 1]
                csl = slice(nxt.offset, nxt.offset + nxt.size)
                C = lvl.num_children
                timeout = lvl.call_timeout if lvl.finite_timeout else None
                att_off = None
                if lvl.ident_attempts:
                    # single attempt, call k <-> child k: elementwise
                    tt = lvl.child_rtt + lat_lvls[d + 1]  # (N, C)
                    transport_a, dur_a = _call_outcome(tt, timeout)
                    if self._need_send:
                        coin = u_send[:, csl] < lvl.child_send_prob
                        used_lvls[d] = coin
                        dur_call = torch.where(coin, dur_a, zero)
                        final_transport = (
                            coin & transport_a
                            if transport_a is not None
                            else None
                        )
                    else:
                        dur_call = dur_a
                        final_transport = transport_a
                else:
                    # general path: serial retry attempts; dummy column C
                    # absorbs invalid attempt slots (the only duplicate
                    # indices of the attempt scatters, sliced off below)
                    lat_child = F.pad(lat_lvls[d + 1], (0, 1))
                    child_err = err_lvls[d + 1]
                    err_child = (
                        F.pad(child_err, (0, 1))
                        if child_err is not None
                        else None
                    )
                    rtt_child = F.pad(lvl.child_rtt, (0, 1))
                    a0 = lvl.att_child[0]
                    if self._need_send:
                        coin = u_send[:, csl][:, a0] < lvl.child_send_prob[a0]
                    else:
                        coin = torch.ones(
                            (n, lvl.num_calls), dtype=torch.bool, device=dev
                        )
                    dur_call = torch.zeros((n, lvl.num_calls), dtype=F32,
                                           device=dev)
                    final_transport = (
                        torch.zeros((n, lvl.num_calls), dtype=torch.bool,
                                    device=dev)
                        if lvl.finite_timeout
                        else None
                    )
                    used = torch.zeros((n, C + 1), dtype=torch.bool,
                                       device=dev)
                    att_off = torch.zeros((n, C + 1), dtype=F32, device=dev)
                    used_a = coin
                    for idx, valid in zip(lvl.att_child, lvl.att_valid):
                        use = used_a & valid
                        t = rtt_child[idx] + lat_child[:, idx]
                        transport_a, dur_a = _call_outcome(t, timeout)
                        failed_a = transport_a
                        if err_child is not None:
                            ec = err_child[:, idx]
                            failed_a = (
                                ec if failed_a is None else failed_a | ec
                            )
                        att_off[:, idx] = torch.where(use, dur_call, zero)
                        used[:, idx] = use
                        dur_call = dur_call + torch.where(use, dur_a, zero)
                        if final_transport is not None:
                            final_transport = torch.where(
                                use, transport_a, final_transport
                            )
                        used_a = (
                            use & failed_a
                            if failed_a is not None
                            else torch.zeros_like(use)
                        )
                    used_lvls[d] = used[:, :C]

                # -- aggregate calls into (parent, step) slots -------------
                if lvl.uniform_calls is not None:
                    # call_seg == repeat(arange(size*P), c): reshape-reduce
                    agg = dur_call.reshape(
                        n, lvl.size, P, lvl.uniform_calls
                    ).amax(-1)
                else:
                    agg = torch.zeros(
                        (n, lvl.size * P), dtype=F32, device=dev
                    ).scatter_reduce_(
                        1, lvl.call_seg.expand(n, -1), dur_call, "amax",
                        include_self=True,
                    ).reshape(n, lvl.size, P)
                if final_transport is not None:
                    fail_contrib = torch.where(
                        final_transport, lvl.call_step, P
                    ).to(torch.int32)
                    if lvl.uniform_calls is not None:
                        fail_step = fail_contrib.reshape(
                            n, lvl.size, P * lvl.uniform_calls
                        ).amin(-1)
                    else:
                        fail_step = torch.full(
                            (n, lvl.size), P, dtype=torch.int32, device=dev
                        ).scatter_reduce_(
                            1, lvl.call_hop.expand(n, -1), fail_contrib,
                            "amin", include_self=True,
                        )
                # fused census join (native/census.py): max + mask +
                # fail/err truncation + row sum + exclusive step prefix
                busy, excl = census(
                    lvl.step_base, lvl.step_mask, agg.contiguous(),
                    fail_step, err_lvl,
                )
                off = excl.reshape(n, -1)[:, lvl.child_seg]
                if att_off is not None:
                    off = off + used_lvls[d] * att_off[:, :C]
                off_lvls[d] = off
            else:
                # call-free level: busy time is fully static; an
                # errorRate 500 skips the whole script
                busy = lvl.leaf_busy.expand(n, lvl.size)
                if err_lvl is not None:
                    busy = busy * ~err_lvl
            fail_lvls[d] = fail_step
            lat_lvls[d] = wait[:, sl] + svc_time[:, sl] + busy
            # this hop's own response status: 500 iff errorRate coin or a
            # transport-failed step
            if err_lvl is not None and fail_step is not None:
                err_lvls[d] = err_lvl | (fail_step < P)
            elif err_lvl is not None:
                err_lvls[d] = err_lvl
            elif fail_step is not None:
                err_lvls[d] = fail_step < P

        # ---- downward pass: which hops actually execute ------------------
        sent_cur = torch.ones((n, 1), dtype=torch.bool, device=dev)
        sent_chunks: List[torch.Tensor] = []
        for d, lvl in enumerate(self._levels):
            sent_chunks.append(sent_cur)
            if d == L - 1:
                break
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            sent = sent_cur[:, lvl.child_parent_local]
            if err_coin is not None:
                sent = sent & ~err_coin[:, sl][:, lvl.child_parent_local]
            if fail_lvls[d] is not None:
                sent = sent & (
                    lvl.child_step
                    <= fail_lvls[d][:, lvl.child_parent_local]
                )
            if used_lvls[d] is not None:
                sent = sent & used_lvls[d]
            sent_cur = sent

        # ---- closed-loop arrivals (need latencies) -----------------------
        root_lat = self._root_net + lat_lvls[0][:, 0]
        if kind == CLOSED_LOOP:
            c = max(connections, 1)
            per = n // c
            rem = n - c * per
            lat_conn = root_lat[: c * per].reshape(c, per)
            spent = torch.maximum(lat_conn, pace_gap)
            starts = conn_t0[:, None] + torch.cumsum(spent, -1) - spent
            conn_end = conn_t0 + spent.sum(-1)
            if rem:
                # remainder requests (n % c) continue on the first ``rem``
                # connections — each starts when its connection frees up
                arrivals = torch.cat([starts.reshape(-1), conn_end[:rem]])
                spent_rem = torch.maximum(root_lat[c * per:], pace_gap)
                conn_end = torch.cat(
                    [conn_end[:rem] + spent_rem, conn_end[rem:]]
                )
            else:
                arrivals = starts.reshape(-1)
        else:
            conn_end = conn_t0

        # ---- downward pass 2: absolute start times -----------------------
        start_cur = (arrivals + self._entry_one_way)[:, None]
        start_chunks: List[torch.Tensor] = []
        for d, lvl in enumerate(self._levels):
            start_chunks.append(start_cur)
            if d == L - 1:
                break
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            base = (start_cur + wait[:, sl])[:, lvl.child_parent_local]
            start_cur = base + off_lvls[d] + lvl.child_net_out

        # ---- assembly into BFS hop order ---------------------------------
        hop_sent = torch.cat(sent_chunks, dim=1)
        err_hop = torch.cat(
            [
                e if e is not None
                else torch.zeros((n, lvl.size), dtype=torch.bool, device=dev)
                for e, lvl in zip(err_lvls, self._levels)
            ],
            dim=1,
        )
        res = SimResults(
            client_start=arrivals,
            client_latency=root_lat,
            client_error=err_hop[:, 0],
            hop_sent=hop_sent,
            hop_error=err_hop & hop_sent,
            hop_latency=torch.cat(lat_lvls, dim=1),
            hop_start=torch.cat(start_chunks, dim=1),
            utilization=qp.utilization.amax(0),
            unstable=qp.unstable.any(0),
            offered_qps=offered_qps,
        )
        t_end = conn_end.max() if kind == CLOSED_LOOP else arrivals[-1]
        return res, t_end, conn_end
