"""The vectorized event-tree simulation engine, in torch.

The port of ``isotope_tpu.sim.engine``'s main path.  One block of
requests is one tensor program over a (request x hop) grid:

- an upward sweep over the depth levels of the unrolled call tree
  computes each hop's server-side duration: serial retry attempts sum,
  a finite timeout clamps and transport-fails an attempt, and each
  level's join (``sim/joins.py``: the dense step grid on the census
  kernel of ``native/census.py``, the ragged census of a mostly padded
  grid, the tiles and sparse call slots of a skewed wide level, or a
  call-free level's static time) turns the calls into busy time;
- a downward sweep decides which hops were actually sent, and a second
  one assigns absolute start times;
- arrivals are a Poisson cumsum (open loop) or per-connection pacing
  (closed loop, Fortio's workers);
- queueing waits are sampled from the M/M/k law at each service's
  offered load, with the sibling, hierarchical and retry Gaussian
  copulas of the reference; the saturated closed loop (``-qps max``)
  samples the finite-population law of ``sim/closed.py`` instead;
- scenario physics: chaos phases (piecewise-constant replica counts,
  outages that refuse calls and truncate their callers' scripts, drain
  windows after an overloaded phase, ungraceful kills that reset the
  requests resident at the kill instant), traffic-split churn (per-hop
  send-probability weights) and the phased mTLS tax; each request takes
  its (chaos x churn) phase row from its nominal arrival time;
- per-service load-balancing laws (``sim/lb.py``: least_request,
  ring_hash, wrr) replace the M/M/k wait law where a topology declares
  them, and panic routing under chaos fast-fails the dead-backend share
  of a pool below its threshold through the 500 path;
- the flight recorder (``metrics/timeline.py``, :meth:`Simulator.
  run_timeline`) bins every block into per-service sim-time windows,
  and the protected runs (:meth:`Simulator.run_policies`,
  :meth:`Simulator.run_rollouts`) carry the control laws of
  ``sim/policies.py`` (breaker sheds on the 500 path, budgeted retries,
  autoscaled or ejected capacity) and ``sim/rollout.py`` (a version coin
  routing each hop to the canary arm's own station) from block to
  block, observing through the recorder;
- critical-path attribution (``metrics/attribution.py``,
  :meth:`Simulator.run_attributed` and the protected runs'
  ``attribution=True``) reduces every block to per-hop blame vectors,
  blame histograms and top-K exemplars in the same loop.

Random numbers come from a draw source (``sim/draws.py``), so the same
draws can drive this engine and the JAX one.  The JAX engine groups
close-shaped levels into ``lax.scan`` buckets to bound its trace size;
this port sweeps every level one by one, which computes the same
values (the JAX package pins buckets against unrolled levels).

Monte Carlo fleets (``sim/ensemble.py``, :meth:`Simulator.run_ensemble`
and the protected fleets) run their members one after another through
the solo block loop (``"map"``), or fold a chunk of M members into one
block of M x N request rows (``"vmap"``): plain, chaos (each row reads
its member's ``ChaosFx`` tables), protected (a folded
:class:`_BlockControl` carries the members' control laws over an (M, S)
state) and observed fleets (the recorder and the blame sweep bin by
member).  A fleet can export its carry (``FleetCarry``,
``ProtectedCarry``) and resume from it, so the search brackets' rungs
continue one unbroken block loop.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import time
from typing import (
    Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple,
)

import numpy as np
import torch
import torch.nn.functional as F

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.compiler.program import CompiledGraph, hop_wire_times
from isotope_tpu_torch.native.satwait import saturated_wait
from isotope_tpu_torch.resilience import faults
from isotope_tpu_torch.sim import closed, queueing
from isotope_tpu_torch.sim import lb as lb_mod
from isotope_tpu_torch.sim.config import (
    CLOSED_LOOP,
    OPEN_LOOP,
    SERVICE_TIME_DETERMINISTIC,
    SERVICE_TIME_LOGNORMAL,
    SERVICE_TIME_PARETO,
    ChaosEvent,
    LoadModel,
    MtlsSchedule,
    SimParams,
    TrafficSplit,
)
from isotope_tpu_torch.sim.draws import (
    BLOCK_INDEX_BASE,
    SAT_PILOT_SEED,
    SVC_EXPONENTIAL,
    SVC_NORMAL,
    Draws,
    DrawSpec,
)
from isotope_tpu_torch.sim.feedback import RetryFeedback
from isotope_tpu_torch.sim.joins import Join, level_join

F32 = torch.float32


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
    # per-hop queueing wait, (N, H) f32: only for SimParams.timeline or
    # .attribution simulators (the recorder's busy integral starts after
    # it, the blame sweep splits it off the self time)
    hop_wait: Optional[torch.Tensor] = None
    # per-hop version coin of a rollout-actuated block (sim/rollout.py),
    # (N, H) bool: True where the hop routed to the canary arm
    hop_canary: Optional[torch.Tensor] = None
    # would-send hops refused by a chaos-downed target, (N, H) bool:
    # rollout gates see a killed canary's refused calls as canary errors
    hop_refused: Optional[torch.Tensor] = None

    @property
    def client_end(self) -> torch.Tensor:
        return self.client_start + self.client_latency

    @property
    def hop_events(self) -> torch.Tensor:
        """Total executed hops — the benchmark's unit of work."""
        return self.hop_sent.sum()


@dataclasses.dataclass(frozen=True)
class _Level:
    """Device-resident constants for one depth level; ``join`` turns
    its calls into its hops' busy time (``sim/joins.py``)."""

    offset: int                     # start of this level's slice in hop order
    size: int
    pmax: int                       # widest script; the fail-step sentinel
    join: Join
    child_parent_local: torch.Tensor  # (C,) i64
    child_step: torch.Tensor        # (C,) i32 — step index within the parent
    child_rtt: torch.Tensor         # (C,) f32 — request + response wire time
    child_net_out: torch.Tensor     # (C,) f32 — one-way request wire time
    child_send_prob: torch.Tensor   # (C,) f32
    call_timeout: torch.Tensor      # (K,) f32, +inf when none
    att_child: Tuple[torch.Tensor, ...]  # per attempt: (K,) i64 in [0, C]
    att_valid: Tuple[torch.Tensor, ...]  # per attempt: (K,) bool
    # single-attempt levels where call k's only child is child k: the
    # attempt loop degenerates to elementwise ops
    ident_attempts: bool = False
    # any call with a finite timeout (else timeouts can't fire)
    finite_timeout: bool = False
    # (C,) i64 churn-weight column of each child (sentinel E: weight 1);
    # None without traffic splits
    child_churn_entry: Optional[torch.Tensor] = None

    @property
    def num_children(self) -> int:
        return len(self.child_parent_local)

    @property
    def num_calls(self) -> int:
        return len(self.call_timeout)


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


def _call_outcome(t, timeout, down_child):
    """(transport_failure, duration) of one call attempt.

    A finite ``timeout`` clamps the round trip ``t`` and fails the call
    past it; a down callee (``down_child``) transport-fails at zero cost
    (the connection is refused, nothing runs).  ``None`` inputs mean the
    failure mode is statically impossible, and a ``None`` transport
    result means no transport failure can occur at all.
    """
    transport = None
    dur = t
    if timeout is not None:
        transport = t > timeout
        dur = torch.minimum(t, timeout)
    if down_child is not None:
        transport = (
            down_child if transport is None else (down_child | transport)
        )
        dur = torch.where(down_child, 0.0, dur)
    return transport, dur


def _tree_product(compiled: CompiledGraph, own: np.ndarray) -> np.ndarray:
    """(..., H) products of ``own`` down the unrolled tree: the root's
    entry is 1 and each hop's is its parent's times its own (one multiply
    per hop, level by level in BFS order)."""
    out = np.ones_like(own)
    for lvl in compiled.levels:
        cids = lvl.child_ids
        if len(cids):
            out[..., cids] = (
                out[..., compiled.hop_parent[cids]] * own[..., cids]
            )
    return out


def _clock_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 prefix sums accumulated in float64, as torch's CPU
    ``cumsum`` accumulates float32: the request clocks (which place
    requests into phases and against kill instants) then agree between
    the card and the CPU, where a float32 scan on the card would drift
    from them by several ULP over a block."""
    return torch.cumsum(x, dim, dtype=torch.float64).to(torch.float32)


def _const(x, dtype, device) -> torch.Tensor:
    """A host array as a constant tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def drain(steps):
    """Run a generator of steps (``Simulator._summary_steps``) to its
    end; returns its result."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _cat_draws(parts: Sequence[Draws]) -> Draws:
    """Fleet members' block draws stacked along the request axis,
    member-major (the ungraceful-kill coins, (E, N, H), along their
    second axis): the draws of a folded block."""
    return Draws(*(
        None if ts[0] is None
        else torch.cat(ts, 1 if name == "u_kill" else 0)
        for name, ts in zip(Draws._fields, zip(*parts))
    ))


def block_rows(load: LoadModel, num_requests: int, block_size: int) -> int:
    """The requests of each block of a blocked run: at most
    ``block_size`` and ``num_requests``; a closed loop's block is a
    whole number of requests per connection (it grows to the connection
    count when that exceeds ``block_size``)."""
    if load.kind == OPEN_LOOP:
        return max(1, min(block_size, num_requests))
    conns = load.connections
    return max(1, min(block_size, num_requests) // conns) * conns


class _Clock:
    """The clocks a block loop carries from block to block: the open
    loop's ``t0``, the connections' ``conn_t0``, the closed loop's
    request offset ``req_off`` (requests each connection issued in
    earlier blocks, which places requests into phases) and the index
    ``block`` of the next block (its draws are index ``1_000_000 +
    block`` of the source).  A fleet's carry export
    (``Simulator.run_ensemble(carry_in=, return_carry=,
    block_offset=)``, the search brackets) starts a loop from one and
    reads it back after the loop."""

    def __init__(self, t0: torch.Tensor, conn_t0: torch.Tensor,
                 req_off: int = 0, block: int = 0):
        self.t0, self.conn_t0 = t0, conn_t0
        self.req_off, self.block = int(req_off), int(block)

    @classmethod
    def zero(cls, sim: "Simulator", conns: int) -> "_Clock":
        """The clocks a loop starts from: t = 0 at block 0."""
        return cls(sim._scalar(0.0),
                   torch.zeros(max(conns, 1), dtype=F32, device=sim.device))

    @classmethod
    def resume(cls, carry, m: int, block: int) -> "_Clock":
        """Member ``m``'s clock from a member-stacked ``(t0, conn_t0,
        req_off)`` carry, at block ``block``."""
        return cls(carry[0][m], carry[1][m], int(carry[2][m]), block)

    def export(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(t0, conn_t0, req_off)``, ``req_off`` a float32 0-d tensor
        (exact below 2**24 requests a connection), as the reference
        carries it."""
        return (self.t0, self.conn_t0,
                torch.tensor(float(self.req_off), dtype=F32,
                             device=self.t0.device))


class FleetCarry(NamedTuple):
    """A plain fleet's member-stacked carry: the reference's ``(t0,
    conn_t0, req_off)`` scan carry, (M,), (M, C) and (M,) float32."""

    t0: torch.Tensor
    conn_t0: torch.Tensor
    req_off: torch.Tensor


class ProtectedCarry(NamedTuple):
    """A protected fleet's member-stacked carry: the clocks and the full
    control state of :class:`_BlockControl` (the recorder's
    accumulator, the rollout observations, state and series, the (S, W)
    retry observations, the policy state and series; ``None`` for a
    layer the Simulator does not arm).  The states' host integer
    ``last_window`` rides as an int64 tensor."""

    t0: torch.Tensor
    conn_t0: torch.Tensor
    req_off: torch.Tensor
    tl_acc: object
    robs: Optional[torch.Tensor]
    rstate: object
    racc: object
    pobs: Optional[torch.Tensor]
    pstate: object
    pacc: object


class _BlockControl:
    """The carry of a recorded or protected block loop
    (``Simulator.run_timeline`` / ``run_policies`` / ``run_rollouts``):
    the flight recorder's accumulator and, when armed, the policy state
    (``sim/policies.py``) with its (S, W) retry observations and series,
    and the rollout state (``sim/rollout.py``) with its (S, 2, W, 4)
    per-arm observations and series.  :meth:`effects` is what the next
    block runs under; :meth:`observe` folds a finished block in and
    advances the control laws through the windows it completed.

    ``members = M > 0`` carries a folded fleet chunk's M members, every
    state and series stacked along a leading member axis (the states'
    ``last_window`` an (M,) int64 array): the effects are (M, S) rows,
    and each member's laws step only through its own completed windows.
    ``downed_w`` gives the members' own (M, S, W) chaos-downed counts (a
    chaos fleet's planners').

    ``merge`` (a shard of a protected mesh run, ``parallel/sharded.py``)
    maps ``(observations, t_done)`` of each block to the mesh's merged
    ones before the laws advance; None (a solo run) folds the block's
    own."""

    def __init__(self, sim: "Simulator", tl_plan: Tuple[int, float],
                 policies: bool, rollouts: bool, members: int = 0,
                 downed_w: Optional[torch.Tensor] = None, merge=None):
        from isotope_tpu_torch.metrics import timeline as timeline_mod

        dev = self.device = sim.device
        M = self.members = members
        self.merge = merge
        self._tl = timeline_mod
        self.spec = timeline_mod.build_spec(
            sim.compiled, tl_plan[0], tl_plan[1], dev
        )
        self.packed = sim.params.packed_carries
        self.tl_acc = timeline_mod.zeros_summary(self.spec, self.packed, dev,
                                                 members=M)
        S, W = sim.compiled.num_services, self.spec.num_windows
        lead = (M,) if M else ()
        self.roll = None
        if rollouts:
            from isotope_tpu_torch.sim import rollout as rollout_mod

            self.roll = rollout_mod
            self.rdtab = rollout_mod.device_tables(sim._rollouts, dev)
            self.rstate = self._stack(rollout_mod.init_state(self.rdtab))
            self.racc = rollout_mod.zeros_summary(self.spec, S, dev,
                                                  members=M)
            self.robs = torch.zeros(lead + (S, 2, W, 4), dtype=F32,
                                    device=dev)
        self.pol = None
        if policies:
            from isotope_tpu_torch.sim import policies as policies_mod

            self.pol = policies_mod
            self.pdtab = policies_mod.device_tables(sim._policies, dev)
            # the policy layer's behavioral chaos sites: an armed
            # ``lag`` delays the autoscaler's first sync, ``stuck``
            # keeps tripped breakers open
            self.pstate = self._stack(policies_mod.init_state(
                self.pdtab, lag_periods=faults.autoscaler_lag()
            ))
            self.stuck = faults.stuck_breaker()
            self.pacc = policies_mod.zeros_summary(self.spec, S, dev,
                                                   members=M)
            self.pobs = torch.zeros(lead + (S, W), dtype=F32, device=dev)
            # rollout runs split the canary-first kill delta off the
            # baseline arm the autoscaler manages
            self.downed_w = (
                downed_w if downed_w is not None
                else sim._policy_downed_windows(self.spec,
                                                base_split=rollouts)
            )
            self.retry_mask = torch.as_tensor(
                np.asarray(sim.compiled.hop_attempt) > 0
            ).to(dev)

    def _stack(self, state):
        """A law's initial state, once a member when folded."""
        if not self.members:
            return state
        return type(state)(*(
            x.expand(self.members, *x.shape).clone()
            if isinstance(x, torch.Tensor)
            else np.full(self.members, x, np.int64)
            for x in state
        ))

    def effects(self):
        """``(policy_fx, rollout_fx)`` of the next block."""
        return (
            self.pol.effects(self.pstate) if self.pol is not None else None,
            self.roll.effects(self.rstate) if self.roll is not None
            else None,
        )

    def observe(self, res: SimResults, t_done: torch.Tensor) -> None:
        """Fold one block in; ``t_done`` is the sim time every request
        of the run so far has passed (windows ending before it are
        final): (M,) a member in a folded chunk.  With a ``merge`` hook
        (a shard of a mesh run) the block's observations and ``t_done``
        pass through it first, so every shard advances the laws from the
        mesh's merged signals."""
        parts = self.contributions(res)
        if self.merge is not None:
            parts, t_done = self.merge(parts, t_done)
        self.fold(parts, t_done)

    def contributions(self, res: SimResults) -> tuple:
        """One block's observations: ``(timeline block, (S, 2, W, 4)
        rollout observations or None, (S, W) retry observations or
        None)``."""
        M = self.members
        return (
            self._tl.timeline_block(res, self.spec, self.packed, members=M),
            self.roll.observe_block(res, self.spec, members=M)
            if self.roll is not None else None,
            self.pol.observe_block(res, self.spec, self.retry_mask,
                                   members=M)
            if self.pol is not None else None,
        )

    def fold(self, parts: tuple, t_done: torch.Tensor) -> None:
        """Accumulate a block's observations (:meth:`contributions`)
        and advance the control laws through the windows ending before
        ``t_done``."""
        tl_blk, robs, pobs = parts
        self.tl_acc = self._tl.accumulate(self.tl_acc, tl_blk)
        if self.roll is not None:
            self.robs = self.robs + robs
            self.rstate, rdelta = self.roll.advance(
                self.rstate, self.rdtab, self.robs, t_done, self.spec
            )
            self.racc = self.roll.accumulate_summary(self.racc, rdelta)
        if self.pol is not None:
            self.pobs = self.pobs + pobs
            self.pstate, pdelta = self.pol.advance(
                self.pstate, self.pdtab, self.tl_acc, self.pobs, t_done,
                self.spec, stuck_breaker=self.stuck,
                downed_w=self.downed_w,
            )
            self.pacc = self.pol.accumulate_summary(self.pacc, pdelta)

    def rollout_summary(self):
        return self.roll.attach_observations(self.racc, self.robs)

    def outputs(self) -> tuple:
        """``(timeline[, rollout summary][, policy summary])``, the
        control's part of a protected run's outputs."""
        out = (self.tl_acc,)
        if self.roll is not None:
            out = out + (self.rollout_summary(),)
        if self.pol is not None:
            out = out + (self.pacc,)
        return out

    def export(self, clocks) -> ProtectedCarry:
        """The loop's full carry after its last block, with ``clocks``
        its ``(t0, conn_t0, req_off)``: resuming a fresh control from
        it (:meth:`resume`) continues the unbroken loop exactly."""
        def state(st):
            return st._replace(last_window=torch.as_tensor(
                st.last_window, dtype=torch.int64, device=self.device
            ))

        return ProtectedCarry(
            *clocks,
            tl_acc=self.tl_acc,
            robs=self.robs if self.roll is not None else None,
            rstate=state(self.rstate) if self.roll is not None else None,
            racc=self.racc if self.roll is not None else None,
            pobs=self.pobs if self.pol is not None else None,
            pstate=state(self.pstate) if self.pol is not None else None,
            pacc=self.pacc if self.pol is not None else None,
        )

    def resume(self, carry: ProtectedCarry) -> None:
        """Continue from one member's :class:`ProtectedCarry` (a folded
        control: its members' rows); each tensor copied: the loop never
        writes into the stacked carry."""
        from isotope_tpu_torch.sim.ensemble import tree_map

        carry = tree_map(torch.clone, carry)

        def last(st):
            if self.members:
                return st.last_window.cpu().numpy().astype(np.int64)
            return int(st.last_window)

        self.tl_acc = carry.tl_acc
        if self.roll is not None:
            self.robs, self.racc = carry.robs, carry.racc
            self.rstate = carry.rstate._replace(
                last_window=last(carry.rstate)
            )
        if self.pol is not None:
            self.pobs, self.pacc = carry.pobs, carry.pacc
            self.pstate = carry.pstate._replace(
                last_window=last(carry.pstate)
            )


class _FleetPlan(NamedTuple):
    """A fleet planned on the host (``Simulator._plan_fleet``,
    ``_plan_protected_fleet``): what every member of it runs, whichever
    device or shard of a mesh runs which members.  ``tail_cut`` is the
    blame's tail cut (None: mean blame, or no tail); ``roll`` is None
    for an unprotected fleet, else whether the rollout controller
    rides."""

    spec: object
    tables: object
    args: dict
    load: LoadModel
    num_requests: int
    block_size: int
    trim: bool
    member_events: Optional[list]
    planners: Optional[list]
    fx: object
    attribution: bool
    tail_cut: Optional[float]
    timeline: bool
    tl_plan: Optional[Tuple[int, float]]
    roll: Optional[bool]
    window_s: Optional[float]


class Simulator:
    """Holds a compiled graph's device tables and runs blocks on them."""

    def __init__(
        self,
        compiled: CompiledGraph,
        params: SimParams = SimParams(),
        chaos: Sequence[ChaosEvent] = (),
        churn: Sequence[TrafficSplit] = (),
        mtls: Optional[MtlsSchedule] = None,
        policies=None,
        rollouts=None,
        lb=None,
        *,
        device=None,
    ):
        # engine.build covers everything below: the host planning and
        # the device-constant upload
        faults.check("engine.build")
        t_build = time.perf_counter()
        self.device = resolve_device(device)
        dev = self.device
        self.compiled = compiled
        self.params = params
        t = compiled.services
        net = params.network
        self._k_max = int(t.replicas.max())

        def tensor(x, dtype):
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        # -- in-graph resilience policies (sim/policies.py) ------------------
        # ``None`` (the default) leaves every block's ops unchanged: all
        # policy effects below gate on it.  The autoscaler can grow a
        # station past the static replica max, so the Erlang recursion
        # covers the widest station the dynamic law can reach.
        self._policies = policies
        self._has_retries = any(
            lvl.att_child.shape[0] > 1 for lvl in compiled.levels
        )
        if policies is not None:
            self._k_max = max(self._k_max, policies.k_max)
        # -- reactive canary rollouts (sim/rollout.py) ------------------------
        self._rollouts = rollouts
        if rollouts is not None:
            if mtls is not None:
                raise ValueError(
                    "rollout runs do not support MtlsSchedule yet"
                )
            self._k_max = max(self._k_max, rollouts.k_max)
        self._mu = 1.0 / params.cpu_time_s
        if rollouts is not None:
            # canary-arm constants: per-service mu (cpu_time override),
            # per-hop cpu ratio and error rate (baseline-substituted)
            can_cpu = np.where(
                np.isfinite(rollouts.canary_cpu_s),
                rollouts.canary_cpu_s, params.cpu_time_s,
            )
            self._canary_mu = tensor(1.0 / can_cpu, F32)
            self._canary_cpu_varies = bool(
                (can_cpu != params.cpu_time_s).any()
            )
            hs_np = compiled.hop_service
            self._canary_cpu_ratio_h = tensor(
                (can_cpu / params.cpu_time_s)[hs_np], F32
            )
            self._canary_err_h = tensor(
                rollouts.canary_error_rate[hs_np], F32
            )
            self._canary_reps_np = rollouts.canary_replicas.astype(
                np.float64
            )

        # -- auto-mTLS switching --------------------------------------------
        # a time-phased extra one-way latency on every edge, indexed by
        # the request's nominal arrival time: pure wire tax, so the
        # queueing tables are untouched (config.MtlsSchedule)
        self._mtls = mtls
        if params.attribution and mtls is not None:
            # the phased tax is indexed by each request's NOMINAL
            # arrival, which SimResults does not carry: the blame sweep
            # could not reproduce the per-edge tax
            raise ValueError(
                "SimParams.attribution does not support MtlsSchedule "
                "runs yet (the per-request tax is not recoverable from "
                "the assembled results)"
            )
        self._attr_tables = None  # built on the first attributed run
        self._mtls_taxes = (
            tensor(mtls.taxes_s, F32) if mtls is not None else None
        )

        # -- traffic splits: per-hop schedule entries ------------------------
        name_to_idx = {n: i for i, n in enumerate(t.names)}
        self._churn = tuple(churn)
        hop_mult, mult_combo, own_combo = self._churn_tables(name_to_idx)
        self._visits = tensor(compiled.expected_visits(hop_mult), F32)

        # -- chaos phases: piecewise-constant effective replica counts -------
        self._chaos_events = tuple(chaos)
        for ev in chaos:
            if ev.service not in name_to_idx:
                raise ValueError(f"chaos for unknown service: {ev.service!r}")
        cuts = sorted(
            {0.0}
            | {ev.start_s for ev in chaos}
            | {ev.end_s for ev in chaos}
        )
        eff = np.tile(t.replicas.astype(np.int64), (len(cuts), 1))  # (P, S)
        for ev in chaos:
            s = name_to_idx[ev.service]
            for p, start in enumerate(cuts):
                if ev.start_s <= start < ev.end_s:
                    eff[p, s] -= (
                        int(t.replicas[s])
                        if ev.replicas_down is None
                        else ev.replicas_down
                    )
        eff = np.maximum(eff, 0)
        svc_down = eff == 0                                   # (P, S)
        if policies is not None:
            # chaos kills compose with the autoscaler's dynamic count:
            # the per-phase DOWN delta subtracts from whatever count the
            # policy state actuated (floored at one server)
            self._downed_p_np = t.replicas.astype(np.float64)[None, :] - eff
        if rollouts is not None:
            # canary-first kill attribution: a chaos phase's down delta
            # removes CANARY replicas before baseline ones; a fully-downed
            # canary arm transport-fails its hops like a down service
            downed_p = t.replicas.astype(np.float64)[None, :] - eff
            can_down_p = np.where(
                rollouts.has_rollout[None, :],
                np.minimum(downed_p, self._canary_reps_np[None, :]),
                0.0,
            )
            base_down_p = downed_p - can_down_p
            self._downed_base_p_np = base_down_p            # (P, S)
            self._base_eff_roll_p_np = (
                t.replicas.astype(np.float64)[None, :] - base_down_p
            )
            self._can_eff_roll_p_np = (
                self._canary_reps_np[None, :] - can_down_p
            )
        # the phase starts in float32, as the JAX engine holds them (its
        # drain windows and -qps max warp read them back in float64)
        self._phase_starts = np.asarray(cuts, np.float32)     # (P,)
        self.has_chaos = bool(chaos)

        # -- post-storm drain windows -----------------------------------------
        # An overloaded phase leaves a backlog that the next phase drains
        # at its freed capacity before waits return to that phase's
        # stationary law: a (2, W) (bounds, row) window table, passed per
        # run, keeps the congested row live past its cut
        # (_windows_arg).  W is static: P real windows + up to P-1
        # drains.
        P_static = len(cuts)
        self._num_windows = 2 * P_static - 1 if P_static > 1 else 1
        ident_b = list(cuts) + [cuts[-1]] * (self._num_windows - P_static)
        ident_r = list(range(P_static)) + [P_static - 1] * (
            self._num_windows - P_static
        )
        self._ident_windows = tensor(
            np.stack([np.asarray(ident_b), np.asarray(ident_r, np.float64)])
            .astype(np.float32),
            F32,
        )
        self._window_cache: Dict[tuple, torch.Tensor] = {}
        # a folded fleet's pilot curves by fleet kind
        # (analysis/costmodel.fleet_member_bytes)
        self._fleet_pilots: Dict[tuple, tuple] = {}

        # -- ungraceful kills (drain=False): resident-request resets ---------
        self._kill_tables(chaos, name_to_idx, cuts, eff)

        # -- per-(chaos x churn)-phase offered load --------------------------
        # A total outage changes where load flows, not just capacity: a
        # transport error truncates its caller's script, so services in
        # later steps (and the down subtree) see less traffic during the
        # window.
        mult_phase = self._phase_reach_multipliers(svc_down)  # (P, H)
        P = mult_phase.shape[0]
        Cc = self._num_combos
        visits_pc = np.empty((P * Cc, compiled.num_services), np.float64)
        mult_pc = np.empty((P * Cc, compiled.num_hops), np.float64)
        for p in range(P):
            for c in range(Cc):
                mult_pc[p * Cc + c] = mult_phase[p] * mult_combo[c]
                visits_pc[p * Cc + c] = compiled.expected_visits(
                    mult_pc[p * Cc + c]
                )
        self._visits_pc_np = visits_pc
        self._mult_pc = mult_pc
        self._visits_pc = tensor(visits_pc, F32)
        # (P*Cc, S) effective replicas (>= 1) and outage flags
        self._eff_pc_np = np.repeat(np.maximum(eff, 1), Cc, axis=0)
        self._down_pc_np = np.repeat(svc_down, Cc, axis=0)
        self._replicas_pc = tensor(self._eff_pc_np, torch.int32)
        self._svc_down_pc = tensor(self._down_pc_np, torch.bool)
        if policies is not None:
            self._downed_pc = tensor(
                np.repeat(self._downed_p_np, Cc, axis=0), F32
            )
        if rollouts is not None:
            # Cc-repeated canary/baseline phase tables of the chaos split;
            # without chaos the canary row is the static canary count
            def rep(a):
                return np.repeat(a, Cc, axis=0)

            S = compiled.num_services
            if self.has_chaos:
                self._eff_base_roll_pc = tensor(
                    rep(np.maximum(self._base_eff_roll_p_np, 1.0)),
                    torch.int32,
                )
                self._svc_down_base_roll_pc = tensor(
                    rep(self._base_eff_roll_p_np <= 0), torch.bool
                )
                self._can_reps_pc = tensor(
                    rep(np.maximum(self._can_eff_roll_p_np, 1.0)), F32
                )
                self._svc_down_can_pc = tensor(
                    rep(rollouts.has_rollout[None, :]
                        & (self._can_eff_roll_p_np <= 0)),
                    torch.bool,
                )
                if policies is not None:
                    self._downed_base_pc = tensor(
                        rep(self._downed_base_p_np), F32
                    )
            else:
                self._can_reps_pc = tensor(
                    np.broadcast_to(self._canary_reps_np, (Cc, S)), F32
                )

        # -- load-balancing laws (sim/lb.py) ----------------------------------
        # ``lb`` (compiler.compile_lb's tables) swaps the wait law per
        # service; None or an all-fifo table with no panic leaves every
        # wait on the M/M/k law.  Panic routing needs something that can
        # unhealth a pool: here, chaos.  Its inputs are the alive
        # replicas per phase row (unclamped: a fully-killed pool is 0
        # healthy, not 1) and the static pool size.
        self._lb = lb
        self._lb_dev = None
        self._lb_profile_np = None
        if lb is not None and lb.active:
            # the lb.degraded_backend chaos site: one profile serves the
            # device tables AND the host feedback mirror, so the static
            # fixed point sees the collapsed backend too
            degraded = faults.lb_degraded_backend()
            self._lb_profile_np = lb_mod.effective_profile(
                lb, self._k_max, degraded
            )
            self._lb_dev = lb_mod.device_tables(lb, self._k_max, dev,
                                                degraded=degraded)
        # panic routing needs something that can unhealth a pool: chaos,
        # or (in a protected run) the policy state's ejections
        self._lb_any_panic = self._lb_dev is not None and lb.any_panic
        if self._lb_any_panic:
            self._lb_alive_pc = tensor(np.repeat(eff, Cc, axis=0), F32)
            self._lb_total_row = tensor(t.replicas, F32)[None, :]

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
                self._eff_pc_np, self._down_pc_np, own_combo, visits_pc,
                mtls=mtls,
                # retry budgets (sim/policies.py) cap the attempt fan;
                # the static visit estimates respect the same cap
                retry_budget=(
                    (
                        policies.has_budget,
                        policies.budget_frac,
                        policies.budget_min,
                    )
                    if policies is not None and policies.any_budget
                    else None
                ),
                # the fixed point sees the same per-station wait laws
                # (sim/lb.np_wait_stats), or a hot ring-hash arc's retry
                # storm goes statically unseen
                lb=(
                    (lb, self._lb_profile_np)
                    if self._lb_profile_np is not None
                    else None
                ),
            )
            if not self._feedback.active:  # pragma: no cover - guard match
                self._feedback = None

        hs = compiled.hop_service
        self._hop_service = torch.tensor(hs, dtype=torch.int64, device=dev)
        # (P*Cc, H) outage flag of each hop's callee per phase row
        self._down_ph = self._svc_down_pc[:, self._hop_service]
        if rollouts is not None and self.has_chaos:
            # baseline- and canary-arm outage flags per hop and phase row
            self._down_base_roll_ph = self._svc_down_base_roll_pc[
                :, self._hop_service
            ]
            self._down_can_ph = self._svc_down_can_pc[:, self._hop_service]
        self._hop_err_rate = torch.tensor(
            t.error_rate[hs], dtype=F32, device=dev
        )
        net_out, net_back = hop_wire_times(compiled, net)
        self._root_net = float(net_out[0] + net_back[0])
        self._entry_one_way = net.entry_one_way(0.0)

        # -- static RNG elimination -----------------------------------------
        # Coins that cannot land both ways are not drawn: no sub-1 send
        # probability and no traffic split -> no send coins, no
        # errorRate -> no error coins.
        self._need_send = bool(churn) or bool(
            (compiled.hop_send_prob[1:] < 1.0).any()
        )
        self._need_err = bool((t.error_rate[hs] > 0.0).any()) or (
            # a canary arm that can 500 needs the error coins drawn even
            # when the baseline is error-free (sim/rollout.py)
            rollouts is not None and rollouts.any_error_override
        )

        levels: List[_Level] = []
        offset = 0
        for lvl in compiled.levels:
            cids = lvl.child_ids
            # per-level step width: the widest script among THIS level's
            # services, not the graph-wide max_steps stride
            pmax = max(int(lvl.step_is_real.sum(1).max(initial=0)), 1)
            parent_local = lvl.child_seg // compiled.max_steps
            child_step = lvl.child_seg % compiled.max_steps
            call_seg_p = (
                lvl.call_seg // compiled.max_steps * pmax
                + lvl.call_seg % compiled.max_steps
            )
            n_calls = len(lvl.call_seg)
            ident = (
                lvl.att_child.shape[0] == 1
                and n_calls == len(cids)
                and bool(lvl.att_valid.all())
                and np.array_equal(
                    lvl.att_child[0], np.arange(n_calls, dtype=np.int32)
                )
            )
            levels.append(
                _Level(
                    offset=offset,
                    size=lvl.num_hops,
                    pmax=pmax,
                    join=level_join(
                        lvl.step_is_real, lvl.step_base, pmax, call_seg_p,
                        parent_local, child_step, params, dev,
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
                    child_churn_entry=(
                        tensor(self._hop_churn_entry[cids], torch.int64)
                        if churn else None
                    ),
                )
            )
            offset += lvl.num_hops
        self._levels: Tuple[_Level, ...] = tuple(levels)

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

        # -- saturated closed loop (-qps max) -------------------------------
        # The finite-population tables (sim/closed.py) are built lazily
        # per connection count; squared coefficient of variation of the
        # service time, which scales the census-conditional wait
        self._closed_cache: Dict[int, tuple] = {}
        # each cached row's copula centre c (R,) on the device
        self._closed_center: Dict[int, torch.Tensor] = {}
        self._closed_in: Optional[tuple] = None
        if params.service_time == SERVICE_TIME_DETERMINISTIC:
            self._svc_scv = 0.0
        elif params.service_time == SERVICE_TIME_LOGNORMAL:
            self._svc_scv = float(np.expm1(params.service_time_param**2))
        elif params.service_time == SERVICE_TIME_PARETO:
            a = params.service_time_param
            self._svc_scv = 1.0 / (a * (a - 2.0)) if a > 2.01 else 25.0
        else:
            self._svc_scv = 1.0
        telemetry.counter_inc("simulators_built")
        telemetry.phase_add("engine.build", time.perf_counter() - t_build)

    # -- scenario tables (host, numpy) --------------------------------------

    def _churn_tables(self, name_to_idx):
        """Traffic-split tables: the per-hop schedule entry, the
        time-averaged hop multiplier (``None`` without churn), and per
        churn combo (the product of the schedules' cycle positions) the
        (Cc, H) reach multipliers and own weights.

        Each churned call's send probability is multiplied by its
        schedule's current weight; descendants inherit through the sent
        propagation.  Offered load uses the time-averaged weight
        propagated down the unroll, and the queues of each combo see
        that combo's own load.
        """
        compiled = self.compiled
        churn = self._churn
        self._num_combos = 1
        self._hop_churn_entry = None
        if not churn:
            ones = np.ones((1, compiled.num_hops), np.float64)
            return None, ones, ones
        entry_of_svc = np.full(compiled.num_services, -1, np.int64)
        for e_i, ts in enumerate(churn):
            if ts.service not in name_to_idx:
                raise ValueError(
                    f"traffic split for unknown service: {ts.service!r}"
                )
            if entry_of_svc[name_to_idx[ts.service]] >= 0:
                raise ValueError(
                    f"multiple traffic splits target {ts.service!r}"
                )
            entry_of_svc[name_to_idx[ts.service]] = e_i
        entry_of_hop = entry_of_svc[compiled.hop_service]
        entry_of_hop[0] = -1  # the client's edge is never churned
        for ts in churn:
            if not (entry_of_hop == entry_of_svc[
                    name_to_idx[ts.service]]).any():
                # only the root targets it (or nothing does): the split
                # would be a silent no-op
                raise ValueError(
                    f"traffic split for {ts.service!r} matches no "
                    "callable edge (the client -> entrypoint edge "
                    "cannot be churned)"
                )
        # sentinel column E holds weight 1.0 for unchurned calls
        self._hop_churn_entry = np.where(
            entry_of_hop >= 0, entry_of_hop, len(churn)
        ).astype(np.int32)
        self._churn_periods = tuple(float(ts.period_s) for ts in churn)
        self._churn_weights = tuple(
            torch.tensor(ts.weights, dtype=F32, device=self.device)
            for ts in churn
        )
        means = np.asarray([ts.mean_weight for ts in churn])
        own = np.where(
            entry_of_hop >= 0, means[np.clip(entry_of_hop, 0, None)], 1.0
        )
        hop_mult = _tree_product(compiled, own)
        ks = [len(ts.weights) for ts in churn]
        n_combos = int(np.prod(ks))
        if n_combos > 256:
            raise ValueError(
                f"traffic-split cycle product is {n_combos} "
                "combinations (> 256); shorten or align the "
                "weight schedules"
            )
        w_combo = np.asarray([
            [churn[e].weights[combo[e]] for e in range(len(churn))]
            for combo in itertools.product(*map(range, ks))
        ])  # (Cc, E)
        own_c = np.where(
            entry_of_hop >= 0,
            w_combo[:, np.clip(entry_of_hop, 0, None)],
            1.0,
        )  # (Cc, H)
        self._num_combos = n_combos
        return hop_mult, _tree_product(compiled, own_c), own_c

    def _kill_tables(self, chaos, name_to_idx, cuts, eff) -> None:
        """Ungraceful kills (``drain=False``): the canonical kill tables
        and each hop's payload-free return path to the client.

        A graceful kill only removes capacity; an ungraceful one also
        resets the requests resident on the killed replicas at the kill
        instant.  Applied after the sweeps to requests whose hop on the
        killed service straddles the kill time: each dies with
        probability down / alive-before and the client sees a transport
        failure at about the kill instant (retries of the killed call
        and truncation downstream are not re-simulated).  One row per
        ``drain=False`` event in kill-time order, surviving events first
        and fully-down targets as inert zero rows at the end; row ``e``
        draws its coins from fold-in ``9_990_000 + e``.
        """
        compiled = self.compiled
        t = compiled.services
        params = self.params
        back_cum = None
        if any(not ev.drain for ev in chaos):
            # payload-free return legs, one per ancestor edge; a
            # cross-cluster edge pays the gateway extra on its return
            leg = np.full(
                compiled.num_hops, params.network.base_latency_s,
                np.float64,
            )
            if t.num_clusters > 1:
                cl = t.cluster
                hs_all = compiled.hop_service
                par = compiled.hop_parent
                leg[1:] += np.where(
                    cl[hs_all[par[1:]]] != cl[hs_all[1:]],
                    float(params.network.cross_cluster_latency_s),
                    0.0,
                )
            leg[0] += params.network.entry_extra_latency_s
            back_cum = leg.copy()
            hi = 1  # level-by-level prefix over the BFS order
            for lvl in compiled.levels:
                nxt = hi + lvl.num_children
                if lvl.num_children:
                    back_cum[hi:nxt] += back_cum[compiled.hop_parent[hi:nxt]]
                hi = nxt
        kill_t: list = []
        kill_frac: list = []
        for ev in sorted(chaos, key=lambda e: e.start_s):
            if ev.drain:
                continue
            s = name_to_idx[ev.service]
            down = (
                int(t.replicas[s])
                if ev.replicas_down is None
                else ev.replicas_down
            )
            # the residents are spread over the replicas alive just
            # before this kill (the prior phase's effective count)
            p = cuts.index(ev.start_s)
            k_before = int(eff[p - 1, s]) if p > 0 else int(t.replicas[s])
            if k_before <= 0:
                continue  # already fully down: nothing resident to kill
            kill_t.append(float(ev.start_s))
            kill_frac.append(np.where(
                compiled.hop_service == s, min(down / k_before, 1.0), 0.0
            ))
        self._num_kill_events = sum(1 for ev in chaos if not ev.drain)
        while len(kill_t) < self._num_kill_events:
            kill_t.append(0.0)
            kill_frac.append(np.zeros(compiled.num_hops))
        self._kill_t = self._kill_frac = self._back_cum = None
        if self._num_kill_events:
            dev = self.device
            self._kill_t = torch.tensor(
                np.asarray(kill_t, np.float32), device=dev
            )
            self._kill_frac = torch.tensor(
                np.stack(kill_frac).astype(np.float32), device=dev
            )
            self._back_cum = torch.tensor(
                back_cum.astype(np.float32), device=dev
            )

    def _phase_reach_multipliers(self, svc_down: np.ndarray) -> np.ndarray:
        """(P, H) static reach multipliers from outage-driven script
        truncation: a call to a down service transport-fails, its caller
        stops after that step (concurrent siblings still run), and the
        down subtree serves nothing.  Level by level over the BFS order:
        the reference's loop over hops, with the same products."""
        compiled = self.compiled
        H = compiled.num_hops
        P = svc_down.shape[0]
        out = np.ones((P, H))
        parent = compiled.hop_parent
        step = compiled.hop_step
        send_prob = compiled.hop_send_prob.astype(np.float64)
        first_attempt = compiled.hop_attempt == 0
        for p in range(P):
            down = svc_down[p]
            if not down.any():
                continue
            tgt_down = down[compiled.hop_service]
            m = out[p]
            if tgt_down[0]:
                # a down entrypoint refuses every connection
                m[:] = 0.0
                continue
            # P(a step does NOT transport-fail): product over its
            # down-target calls' send coins (one coin per call; retry
            # attempts share it)
            no_fail: Dict[tuple, float] = {}
            for h in np.nonzero(tgt_down & first_attempt)[0]:
                key = (int(parent[h]), int(step[h]))
                no_fail[key] = no_fail.get(key, 1.0) * (
                    1.0 - float(send_prob[h])
                )
            per_parent: Dict[int, list] = {}
            for (q, j), pr in no_fail.items():
                per_parent.setdefault(q, []).append((j, pr))
            # surv[h]: the product, in step order, of the no-fail
            # probabilities of the parent's steps before h's step
            surv = np.ones(H)
            if per_parent:
                affected = np.zeros(H, bool)
                affected[list(per_parent)] = True
                kids = np.nonzero(affected[parent])[0]
                kids = kids[kids > 0]
                tables = {}
                for q, items in per_parent.items():
                    items.sort()
                    prods = [1.0]
                    for _, pj in items:
                        prods.append(prods[-1] * pj)
                    tables[q] = ([j for j, _ in items], prods)
                for h in kids:
                    js, prods = tables[int(parent[h])]
                    surv[h] = prods[bisect.bisect_left(js, int(step[h]))]
            for lvl in compiled.levels:
                cids = lvl.child_ids
                if len(cids):
                    m[cids] = np.where(
                        tgt_down[cids], 0.0, m[parent[cids]] * surv[cids]
                    )
        return out

    # -- draws ------------------------------------------------------------

    def draw_spec(self, n: int, kind: str, saturated: bool = False,
                  policy: bool = False, canary: bool = False) -> DrawSpec:
        """The random tensors one block of ``n`` requests consumes;
        ``saturated``: under the finite-population law of ``-qps max``,
        which takes the flat sibling normals (no hierarchical mix);
        ``policy`` / ``canary``: a block of a protected run, under policy
        effects (breaker-shed and retry-budget coins) / rollout effects
        (version coins)."""
        pol = self._policies if policy else None
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
                    if self._copula_mix is not None and not saturated
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
            saturated=saturated,
            kill_events=self._num_kill_events,
            panic=(
                self._lb_any_panic and not saturated
                and (self.has_chaos or pol is not None)
            ),
            policy=pol is not None,
            shed=pol is not None and pol.any_breaker,
            retry=(
                pol is not None and pol.any_budget and self._has_retries
            ),
            canary=canary,
        )

    def _draws(self, source, index, n: int, kind: str,
               saturated: bool = False, policy: bool = False,
               canary: bool = False) -> Draws:
        with telemetry.span("engine.draws"):
            spec = self.draw_spec(n, kind, saturated, policy, canary)
            draws = source.draws(index, spec).to(self.device)
            draws.check(spec)
        return draws

    # -- public entry points ----------------------------------------------

    def _vis_arg(self, offered: float) -> torch.Tensor:
        """The (P*Cc, S) visit table the queues see at ``offered``: the
        static table, or the retry-feedback fixed point at that rate."""
        if self._feedback is None:
            return self._visits_pc
        return torch.tensor(
            self._feedback.visits_pc(float(offered)), dtype=F32,
            device=self.device,
        )

    def _windows_arg(self, offered: float, sat: bool) -> torch.Tensor:
        """The (2, W) packed (bounds, row) phase-window table at
        ``offered``: identity unless an overloaded phase leaves a
        backlog, in which case drain windows keep the congested row
        active past its cut for backlog / freed-capacity seconds.

        Saturated (-qps max) runs skip drains: the closed population
        bounds the backlog at C, so queues drain within one cycle.
        """
        P = len(self._phase_starts)
        if P == 1 or sat or not self.has_chaos:
            return self._ident_windows
        key = (float(f"{float(offered):.4g}"),)
        if key not in self._window_cache:
            cuts = self._phase_starts.astype(np.float64)
            S = self.compiled.num_services
            Cc = self._num_combos
            visits = (
                self._feedback.visits_pc(offered)
                if self._feedback is not None
                else self._visits_pc_np
            )
            lam = offered * visits.reshape(P, Cc, S).mean(1)  # (P, S)
            eff = self._eff_pc_np[::Cc].astype(np.float64)  # clamped >= 1
            down = self._down_pc_np[::Cc]
            cap = np.where(down, 0.0, eff * self._mu)
            lam = np.where(down, 0.0, lam)

            seq = [(float(cuts[0]), 0)]
            backlog = np.zeros(S)
            for p in range(P - 1):
                dur = float(cuts[p + 1] - cuts[p])
                backlog += np.maximum(lam[p] - cap[p], 0.0) * dur
                free = cap[p + 1] - lam[p + 1]
                drainable = (backlog > 1e-9) & (free > 1e-9)
                nxt_end = float(cuts[p + 2]) if p + 2 < P else np.inf
                if drainable.any():
                    drain_t = float(
                        (backlog[drainable] / free[drainable]).max()
                    )
                    drain_end = min(cuts[p + 1] + drain_t, nxt_end)
                    if drain_end > cuts[p + 1] + 1e-9:
                        # the congested row stays live while draining
                        seq.append((float(cuts[p + 1]), p))
                        if drain_end < nxt_end:
                            seq.append((float(drain_end), p + 1))
                        drained = (
                            np.maximum(free, 0.0)
                            * (drain_end - cuts[p + 1])
                        )
                        backlog = np.maximum(backlog - drained, 0.0)
                        continue
                seq.append((float(cuts[p + 1]), p + 1))
            while len(seq) < self._num_windows:
                seq.append(seq[-1])
            self._window_cache[key] = _const(
                np.asarray(
                    [[b for b, _ in seq], [r for _, r in seq]], np.float32
                ),
                F32, self.device,
            )
        return self._window_cache[key]

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=F32, device=self.device)

    def _saturated(self, load: LoadModel) -> bool:
        """True when the run samples the finite-population (MVA) wait
        law: Fortio's ``-qps max`` closed loop, with per-phase tables
        under chaos and churn.  A phased mTLS tax falls back to the
        open-loop law (the MVA delay station is static)."""
        return (
            load.kind == CLOSED_LOOP
            and load.qps is None
            and self._mtls is None
        )

    def _check_lb_load(self, load: LoadModel) -> None:
        """An active lb law cannot run under the saturated ``-qps max``
        law, whose finite-population tables have no per-backend
        dispatch: refuse it rather than fall back to fifo.  Also the
        ``lb.degraded_backend`` site's classified-fault entry (the
        supervisor's retry path covers the lb layer)."""
        if self._lb_dev is None:
            return
        faults.check("lb.degraded_backend")
        if self._saturated(load):
            raise ValueError(
                "lb laws do not support saturated -qps max loads: the "
                "finite-population wait tables have no per-backend "
                "dispatch; use a paced closed loop or open loop"
            )

    def run(
        self,
        load: LoadModel,
        num_requests: int,
        source,
    ) -> SimResults:
        """Simulate ``num_requests`` under ``load`` with draws from
        ``source`` (its index ``None``).

        Open loop: the queues see exactly ``load.qps``.  Closed loop:
        the rate the queues see is latency-dependent, solved by
        :meth:`solve_closed_rate` before the run; ``-qps max``
        (``qps=None``) issues without pacing at the closed network's
        throughput and samples the finite-population wait law.
        """
        faults.check("engine.run")
        self._check_lb_load(load)
        if load.kind == OPEN_LOOP:
            res, _, _ = self._simulate_core(
                num_requests, OPEN_LOOP, 0,
                self._draws(source, None, num_requests, OPEN_LOOP),
                self._scalar(load.qps), self._scalar(0.0),
                self._scalar(load.qps), self._scalar(0.0),
                torch.zeros(1, dtype=F32, device=self.device),
                visits_pc=self._vis_arg(load.qps),
                phase_windows=self._windows_arg(load.qps, False),
            )
            return res
        lam = self.solve_closed_rate(load, num_requests, source)
        c = load.connections
        sat = self._saturated(load)
        res, _, _ = self._simulate_core(
            num_requests, CLOSED_LOOP, c,
            self._draws(source, None, num_requests, CLOSED_LOOP, sat),
            self._scalar(lam),
            self._scalar(0.0 if load.qps is None else c / load.qps),
            self._scalar(lam), self._scalar(0.0),
            torch.zeros(c, dtype=F32, device=self.device),
            visits_pc=self._vis_arg(lam),
            sat_conns=c if sat else 0,
            # chaos-phase placement always reflects the real rate: with
            # qps=None the workers still issue at the solved throughput
            nominal_gap=self._scalar(c / lam),
            phase_windows=self._windows_arg(lam, sat),
        )
        return res

    def solve_closed_rate(
        self,
        load: LoadModel,
        num_requests: int,
        source,
    ) -> float:
        """Equilibrium offered rate of Fortio's closed loop.

        ``-qps max``: the closed network's throughput, which the
        finite-population tables compute (:meth:`_closed_tables`; their
        fork-join refinement draws its pilots from
        ``source.with_seed(SAT_PILOT_SEED)``).  Paced:
        ``g(lam) = min(qps, C / E[latency(lam)]) - lam`` is strictly
        decreasing with one root, found by bisection over short pilot
        runs (pilot ``i`` draws from index ``i`` of ``source``).  The
        rate is memoized per load shape.
        """
        self._check_lb_load(load)
        if self._saturated(load):
            # phased runs time-weight the per-row rates over the chaos
            # windows the run spans
            thr = self._closed_tables(load.connections, source)[0]
            return self._sat_phased_rate(thr, num_requests)
        cache_key = (load.qps, load.connections, min(num_requests, 2048))
        if cache_key in self._rate_cache:
            return self._rate_cache[cache_key]
        cap = 0.999 * self.capacity_qps()
        hi = min(load.qps, cap) if load.qps is not None else cap
        pilot_n = min(num_requests, 2048)
        c = load.connections
        gap = self._scalar(0.0 if load.qps is None else c / load.qps)

        def implied(lam: float, i: int) -> float:
            res, _, _ = self._simulate_core(
                pilot_n, CLOSED_LOOP, c,
                self._draws(source, i, pilot_n, CLOSED_LOOP),
                self._scalar(lam), gap, self._scalar(lam),
                self._scalar(0.0),
                torch.zeros(c, dtype=F32, device=self.device),
                visits_pc=self._vis_arg(lam),
                nominal_gap=self._scalar(c / lam),
                phase_windows=self._windows_arg(lam, False),
            )
            mean_lat = float(res.client_latency.mean())
            out = c / max(mean_lat, 1e-9)
            return min(out, load.qps) if load.qps is not None else out

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

    def _sat_phased_rate(self, thr: np.ndarray, num_requests: int) -> float:
        """Average ``-qps max`` throughput over the chaos phases a run of
        ``num_requests`` spans: walk the phases accumulating requests at
        each phase's rate until the count is reached (churn combos cycle
        uniformly, so they average arithmetically within a phase)."""
        P = len(self._phase_starts)
        Cc = self._num_combos
        if P * Cc == 1:
            return float(thr[0])
        lam_p = np.asarray(thr, np.float64).reshape(P, Cc).mean(1)
        cuts = self._phase_starts.astype(np.float64)
        acc = 0.0
        for p in range(P):
            start = cuts[p]
            end = cuts[p + 1] if p + 1 < P else np.inf
            rate = max(float(lam_p[p]), 1e-9)
            seg = (end - start) * rate
            if p + 1 >= P or acc + seg >= num_requests:
                t_end = start + (num_requests - acc) / rate
                return num_requests / max(t_end, 1e-9)
            acc += seg
        return float(lam_p[-1])  # pragma: no cover - loop always returns

    # -- saturated closed loop: finite-population tables --------------------

    def _closed_inputs(self):
        """Closed-network model inputs (host, float64): fork-join cycle
        factors per hop, the factor-weighted reach, and each hop's delay
        weight (wire round trip plus own sleeps).

        Each member of an m-wide concurrent group overlaps its siblings,
        contributing ~H_m/m of its response to the request's cycle (H_m
        the harmonic number); factors multiply down the unroll.
        """
        if self._closed_in is None:
            compiled = self.compiled
            net_out, net_back = hop_wire_times(compiled, self.params.network)
            fj = np.ones(compiled.num_hops)
            for lvl in compiled.levels:
                if not len(lvl.child_ids):
                    continue
                seg_calls: Dict[int, int] = {}
                for seg in lvl.call_seg:
                    seg_calls[int(seg)] = seg_calls.get(int(seg), 0) + 1
                factor = {
                    seg: sum(1.0 / i for i in range(1, m + 1)) / m
                    for seg, m in seg_calls.items()
                }
                parent_global = lvl.hop_ids[
                    lvl.child_seg // compiled.max_steps
                ]
                fj[lvl.child_ids] = fj[parent_global] * np.asarray(
                    [factor[int(s)] for s in lvl.child_seg]
                )
            hop_sleep = np.zeros(compiled.num_hops)
            for lvl in compiled.levels:
                hop_sleep[lvl.hop_ids] = (
                    lvl.step_base * lvl.step_is_real
                ).sum(1)
            self._closed_in = (
                fj, compiled.hop_reach * fj, net_out + net_back + hop_sleep
            )
        return self._closed_in

    def _closed_tables(self, connections: int, source=None):
        """Saturated-closed-loop sampling tables at ``connections``,
        stacked per (chaos x churn) phase row: (throughput (R,) f64,
        p_zero (R, H), coef (R, D+1, H), e (R, H), center_c (R,) f32
        numpy, var_scale (R, H)), the tensors on the run's device; built
        on first use (an unphased fork-join run's pilots draw from
        ``source``) and cached per C.  Unphased runs have R == 1.

        ``center_c``/``var_scale`` realize the population copula:
        z' = scale * (z - c * e * (e . z)) has exact unit marginals and
        pairwise correlation rho (sim/closed.py) among the active hops.

        A build runs in the phase (and span) ``closed.tables``; it sets
        the gauges ``closed_population`` (C) and ``closed_stations`` (the
        stations with visits, summed over the rows) and counts
        ``closed_table_builds``.
        """
        if connections not in self._closed_cache:
            if source is None:
                raise ValueError(
                    "the saturated closed-loop tables are built by "
                    "solve_closed_rate (they need a draw source)"
                )
            R = len(self._phase_starts) * self._num_combos
            with telemetry.phase("closed.tables"):
                rows = [
                    self._closed_row(connections, r, R == 1, source)
                    for r in range(R)
                ]

                def t(i):
                    # row-major, as the wait kernel reads them
                    return _const(np.ascontiguousarray(
                        np.stack([r[i] for r in rows])), F32, self.device)

                self._closed_cache[connections] = (
                    np.asarray([r[0] for r in rows]), t(1), t(2), t(3),
                    np.asarray([r[4] for r in rows], np.float32), t(5),
                )
            telemetry.counter_inc("closed_table_builds")
            telemetry.gauge_set("closed_population", connections)
            telemetry.gauge_set("closed_stations", int(
                (self._visits_pc_np[:R] > 1e-12).sum()))
        return self._closed_cache[connections]

    def _closed_row(self, connections: int, row: int, refine: bool,
                    source):
        """One phase row's closed-network tables (numpy)."""
        compiled = self.compiled
        hs = compiled.hop_service
        H = compiled.num_hops
        visits = self._visits_pc_np[row]
        reps = np.maximum(self._eff_pc_np[row].astype(np.float64), 1.0)
        fj, reach_fj, delay_w = self._closed_inputs()
        reach_r = reach_fj * self._mult_pc[row]
        delay_r = float((reach_r * delay_w).sum())
        cycle_visits_r = np.bincount(
            hs, weights=reach_r, minlength=compiled.num_services
        )
        if visits.max(initial=0.0) <= 1e-12:
            # down entry: every connection spins on refused connects
            lam = connections / max(2.0 * self._entry_one_way, 1e-9)
            deg = closed.DEFAULT_QUANTILE_DEGREE
            return (lam, np.ones(H), np.zeros((deg + 1, H)),
                    np.zeros(H), 0.0, np.ones(H))
        if bool((fj < 1.0).any()):
            # fork-join: finite-source decomposition.  For unphased runs
            # the cycle is refined through the ENGINE's own composition
            # (max over siblings, copula) so Little's law closes:
            # E[sampled latency] = C / lambda.  Sample E at a spread of
            # cycles around the decomposition estimate, fit the
            # locally-linear map E(c) ~ a + b c by least squares, and
            # solve c* = a / (1 - b) (the map's contraction factor is
            # ~0.9, so a plain iteration would amplify pilot noise ~10x).
            # Phase rows keep the decomposition (the pilot measures one
            # stationary phase, which phased runs do not have).
            lam, pi, cycle = closed.fork_join_decomposition(
                visits, cycle_visits_r, reps, self._mu,
                delay_r, connections,
            )
            if refine:
                cycle, pi = self._refine_cycle(
                    connections, source, visits, reps, pi, cycle
                )
            p0, coef, _ = closed.tables_from_pi(
                pi, reps, self._mu, scv=self._svc_scv
            )
            throughput = connections / cycle
            # partial population centering for fork-join: the empirical
            # target 0.25 * sum(sigma^2) (var_d=None), fit against the
            # reference's DES oracle on tree13/star9
            sigma = closed.census_sigma(pi)
            var_d = None
        else:
            tabs = closed.closed_network_tables(
                visits, cycle_visits_r, reps, self._mu,
                delay_r, connections, scv=self._svc_scv,
            )
            p0, coef = tabs.p_zero, tabs.coef
            throughput = tabs.throughput
            sigma, var_d = tabs.sigma, tabs.var_delay
        e_h, c_center, scale_h = self._center_terms(sigma, var_d, hs)
        return (throughput, p0[hs], coef[:, hs], e_h, c_center, scale_h)

    def _refine_cycle(self, connections, source, visits, reps, pi, cycle):
        """Little-law closure of an unphased fork-join row: find the
        cycle c* with E(c*) = c*, where E(c) is the engine's own
        composed mean latency under tables built at cycle c.  Returns
        ``(cycle, pi)`` at the solved cycle."""
        hs = self.compiled.hop_service
        pilot = self._sat_pilot(connections, source)

        def t(x):
            # row-major, as the wait kernel reads them
            return _const(np.ascontiguousarray(x), F32, self.device)

        def census_at(c):
            # the repairman sweep is itself a per-station fixed
            # point in w; iterate it to convergence at cycle c
            pi_c = pi
            w_c = np.full(len(visits), 1.0 / self._mu)
            for _ in range(4):
                pi_c, w_c = closed.repairman_marginals(
                    visits, reps, self._mu, c, w_c, connections
                )
            return pi_c

        c0 = cycle
        cs, es = [], []
        for it, f in enumerate((0.85, 0.925, 1.0, 1.075, 1.15)):
            c = c0 * f
            pi_c = census_at(c)
            p0, coef, _ = closed.tables_from_pi(
                pi_c, reps, self._mu, scv=self._svc_scv
            )
            e_c, cc, sc = self._center_terms(
                closed.census_sigma(pi_c), None, hs
            )
            es.append(float(pilot(
                it, c / connections, t(p0[hs]), t(coef[:, hs]), t(e_c),
                t(cc), t(sc),
            )))
            cs.append(c)
        b, a = np.polyfit(np.asarray(cs), np.asarray(es), 1)
        if b < 0.98:  # sane slope: solve the linear map
            # clamped to the sampled neighbourhood: the model is local
            cycle = float(np.clip(a / (1.0 - b), 0.7 * c0, 1.6 * c0))
        else:  # degenerate fit: keep the decomposition value
            cycle = c0
        return cycle, census_at(cycle)

    @staticmethod
    def _center_terms(sigma, var_d, hs):
        """Population-copula centering terms from census sigmas.

        Linearize j_s ~ mean + sigma_s * z_s; the census constraint
        sum_s j_s + j_d = C-1 means the sigma-weighted z-combination
        must carry Var(j_delay), not the independent sum Sigma sigma^2
        — shrink its projection: z' = (z - c * e * (e . z)) / norm,
        c = 1 - sqrt(Vd / Ss^2).  ``var_d=None`` selects the fork-join
        empirical target 0.25 * Ss^2.
        """
        c_center = 0.0
        e_h = np.zeros(len(hs))
        scale_h = np.ones(len(hs))
        if sigma is not None:
            # a station's weight spreads over its hops (independent
            # draws): sigma/m per hop keeps multi-visit stations from
            # dominating the projection
            n_hops_s = np.bincount(hs, minlength=len(sigma))
            sig_h = sigma[hs] / np.maximum(n_hops_s[hs], 1)
            ss = float((sig_h**2).sum())
            if var_d is None:
                var_d = 0.25 * ss
            if ss > 1e-18 and var_d < ss:
                c_center = 1.0 - float(np.sqrt(max(var_d, 0.0) / ss))
                e_h = sig_h / np.sqrt(ss)
                shrink = (2 * c_center - c_center**2) * e_h**2
                scale_h = 1.0 / np.sqrt(1.0 - shrink)
        return e_h, c_center, scale_h

    def _sat_pilot(self, connections: int, source, n: int = 32_768):
        """Mean-latency probe of the fork-join fixed point: iteration
        ``it`` averages two pilot runs of ``n`` requests under the given
        quantile tables, drawn from index ``(it, i)`` of
        ``source.with_seed(SAT_PILOT_SEED)`` — a fixed stream, so the
        converged cycle does not depend on the run's seed (the fixed
        point amplifies probe noise: a ~0.3% shift of the mean moved
        the throughput by 5% in the reference's measurements)."""
        pilots = source.with_seed(SAT_PILOT_SEED)
        c = max(connections, 1)
        one, zero = self._scalar(1.0), self._scalar(0.0)

        def probe(it, nominal_gap, p0_h, coef_h, e_h, c_ctr, scale_h):
            means = []
            for i in range(2):
                res, _, _ = self._simulate_core(
                    n, CLOSED_LOOP, connections,
                    self._draws(pilots, (it, i), n, CLOSED_LOOP, True),
                    one, zero, one, zero,
                    torch.zeros(c, dtype=F32, device=self.device),
                    sat_conns=connections,
                    sat_override=(p0_h, coef_h, e_h, c_ctr, scale_h),
                    nominal_gap=self._scalar(nominal_gap),
                )
                means.append(res.client_latency.mean())
            return (means[0] + means[1]) / 2.0

        return probe

    def _block_plan(self, load: LoadModel, num_requests: int, source,
                    block_size: int = 65_536) -> Tuple[float, int, int]:
        """``(offered rate, block, number of blocks)`` of a blocked run:
        the closed loop's rate is solved (and cached) first, and its
        block is a whole number of requests per connection (it grows to
        the connection count when that exceeds ``block_size``)."""
        if load.kind == OPEN_LOOP:
            offered = float(load.qps)
        else:
            offered = self.solve_closed_rate(load, num_requests, source)
        block = block_rows(load, num_requests, block_size)
        return offered, block, max(1, -(-num_requests // block))

    def run_blocks(self, load: LoadModel, num_requests: int, source, *,
                   block_size: int = 65_536,
                   control: Optional["_BlockControl"] = None,
                   cpu_scale: Optional[torch.Tensor] = None,
                   err_scale: Optional[torch.Tensor] = None,
                   clock: Optional[_Clock] = None,
                   plan: Optional[Tuple[float, int, int]] = None,
                   shards: int = 1,
                   ) -> Iterator[SimResults]:
        """The :class:`SimResults` of each block of a run of >=
        ``num_requests`` (:meth:`_block_plan`).

        A Python loop over blocks carries the open-loop clock ``t0``, the
        per-connection clocks ``conn_t0`` and the closed loop's request
        offset (its nominal clock, which places requests into chaos,
        churn and mTLS phases) from one block to the next, so the blocks
        form one continuous timeline; block ``b`` draws from index
        ``1_000_000 + b`` of ``source``.

        ``control`` (a recorded or protected run, :meth:`run_timeline`,
        :meth:`run_policies`, :meth:`run_rollouts`) rides the same loop:
        each block runs under its current effects, and it observes each
        block before the next one starts.  ``cpu_scale`` / ``err_scale``
        (0-d tensors) are a fleet member's perturbations
        (:meth:`_simulate_core`).

        ``clock`` (a :class:`_Clock`, the fleets' carry export) starts
        the loop from its clocks at its block index and holds the
        loop's clocks after each block; ``plan`` gives ``(offered rate,
        block, number of blocks)`` instead of :meth:`_block_plan` (a
        fleet's members run its plan).

        ``shards = R > 1`` runs one shard of a mesh run
        (``parallel/sharded.py``): its arrivals are paced at ``offered /
        R`` and a closed loop's at ``connections / R`` connections,
        while the queueing law, the pacing gap, the nominal clock and
        the saturated law keep the whole run's rate and connections.
        """
        self._check_lb_load(load)
        offered, block, num_blocks = plan if plan is not None else (
            self._block_plan(load, num_requests, source, block_size)
        )
        sat = self._saturated(load)
        conns = 0 if load.kind == OPEN_LOOP else load.connections
        # -qps max: no pacing, the workers issue back to back; the
        # nominal clock follows the solved rate
        pace = conns / load.qps if conns and load.qps is not None else 0.0
        nominal = conns / offered
        visits_pc = self._vis_arg(offered)
        windows = self._windows_arg(offered, sat)
        offered_t = self._scalar(offered)
        pace_t = self._scalar(pace)
        nominal_t = self._scalar(nominal)
        # a shard's share of the arrival stream, in float32 as the
        # reference's ``offered_qps / n_shards``
        arrival_t = offered_t / shards if shards > 1 else offered_t
        local = conns // shards
        if clock is None:
            clock = _Clock.zero(self, local)
        per = block // max(local, 1)
        for _ in range(num_blocks):
            with telemetry.span("engine.block"):
                pfx, rfx = (
                    control.effects() if control is not None else (None, None)
                )
                res, t0, conn_t0 = self._simulate_core(
                    block, load.kind, local,
                    self._draws(source, BLOCK_INDEX_BASE + clock.block, block,
                                load.kind, sat, policy=pfx is not None,
                                canary=rfx is not None),
                    offered_t, pace_t, arrival_t, clock.t0, clock.conn_t0,
                    visits_pc=visits_pc,
                    sat_conns=conns if sat else 0,
                    nominal_gap=nominal_t,
                    req_offset=clock.req_off,
                    phase_windows=windows,
                    policy_fx=pfx,
                    rollout_fx=rfx,
                    cpu_scale=cpu_scale,
                    err_scale=err_scale,
                )
                clock.t0, clock.conn_t0 = t0, conn_t0
                clock.block += 1
                clock.req_off += per
                if control is not None:
                    # closed loop: a window is final only once the SLOWEST
                    # connection passed it
                    control.observe(
                        res, conn_t0.min() if load.kind == CLOSED_LOOP else t0
                    )
            # hand the block over without keeping it in this frame: the
            # lockstep twin (parallel/sharded.py) suspends every shard's
            # loop here, and each must hold its carries, not its block
            box = [res]
            del res
            yield box.pop()

    def run_summary(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        collector=None,
        trim: bool = False,
    ):
        """Simulate >= ``num_requests`` in memory-bounded blocks
        (:meth:`run_blocks`) and reduce them to one
        :class:`~isotope_tpu_torch.sim.summary.RunSummary`.
        ``collector`` (a ``metrics.prometheus.MetricsCollector``) adds
        each block's per-service Prometheus series to
        ``RunSummary.metrics``.  ``trim=True`` also accumulates the
        collector's steady-state window (skip 62s, cap 180s) into the
        ``win_*`` fields, placed from the run's expected duration.
        """
        faults.check("engine.run")
        return self._run_summary(load, num_requests, source, block_size,
                                 collector, trim)

    def _run_summary(self, load, num_requests, source, block_size,
                     collector, trim, control=None, attr=False,
                     tail_cut=None, cpu_scale=None, err_scale=None,
                     fleet=False, clock=None, plan=None, shards=1):
        """The block loop reduced to a RunSummary; with ``attr`` also to
        an AttributionSummary (its tail accumulators armed at
        ``tail_cut`` when given): ``(summary, attribution)``.  A solo
        loop reduces blame or the recorder's timeline, not both; a fleet
        member (``fleet``) may reduce both, as the reference's observed
        fleet members do.  ``shards``: one shard of a mesh run
        (:meth:`run_blocks`), whose trim window spans all of them."""
        return drain(self._summary_steps(
            load, num_requests, source, block_size, collector, trim,
            control, attr, tail_cut, cpu_scale, err_scale, fleet, clock,
            plan, shards,
        ))

    def _summary_steps(self, load, num_requests, source, block_size,
                       collector, trim, control=None, attr=False,
                       tail_cut=None, cpu_scale=None, err_scale=None,
                       fleet=False, clock=None, plan=None, shards=1):
        """:meth:`_run_summary` as a generator that yields after each
        block and returns the result: the emulated twin of a protected
        mesh run (``parallel/sharded.py``) steps every shard's loop
        block by block in lockstep, merging their observations between
        the steps."""
        from isotope_tpu_torch.metrics.fortio import trim_window_bounds
        from isotope_tpu_torch.sim import summary as summary_mod

        if (attr and control is not None and not fleet
                and control.pol is None and control.roll is None):
            raise ValueError(
                "one block loop reduces either blame or the timeline, "
                "not both"
            )
        self._check_lb_load(load)
        offered, block, num_blocks = plan if plan is not None else (
            self._block_plan(load, num_requests, source, block_size)
        )
        telemetry.gauge_set("engine_block_requests", block)
        telemetry.gauge_set("engine_num_blocks", num_blocks)
        win = None
        if trim:
            lo, hi = trim_window_bounds(num_blocks * block * shards,
                                        offered)
            win = (self._scalar(lo), self._scalar(hi))
        if attr:
            from isotope_tpu_torch.metrics import attribution

            tables = self._attribution_tables()
            top_k = self.params.attribution_top_k
            k0 = min(top_k, block)
            ex = (
                attribution.empty_exemplars(
                    k0, self.compiled.num_hops, self.device
                )
                if k0 > 0 else None
            )
            a_acc = None
        parts = []
        for res in self.run_blocks(load, num_requests, source,
                                   block_size=block_size, control=control,
                                   cpu_scale=cpu_scale,
                                   err_scale=err_scale, clock=clock,
                                   plan=plan, shards=shards):
            with telemetry.span("summary.block"):
                parts.append(
                    summary_mod.summarize(res, collector, window=win)
                )
            if attr:
                with telemetry.span("attribution.block"):
                    a_acc, ex = attribution.attribute_block(
                        res, tables, tail_cut=tail_cut, top_k=top_k,
                        ex_state=ex, acc=a_acc,
                    )
            del res
            yield
        summary = summary_mod.reduce_stacked(summary_mod.stack(parts))
        if not attr:
            return summary
        return summary, a_acc._replace(exemplars=ex)

    # -- critical-path attribution ----------------------------------------

    def _attribution_tables(self):
        """Blame-sweep index tables (``metrics/attribution.py``), built
        on first use: a Simulator that never runs attributed pays
        nothing."""
        if self._attr_tables is None:
            from isotope_tpu_torch.metrics import attribution

            self._attr_tables = attribution.build_tables(
                self.compiled, self.params.network, self.device
            )
        return self._attr_tables

    def estimate_tail_cut(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        quantile: Optional[float] = None,
    ) -> float:
        """Streaming-threshold tail cut: a pilot run of up to 8,192
        requests under ``source`` rooted at ``TAIL_PILOT_INDEX`` (the
        reference's ``fold_in(key, 777_000)``) recovers the requested
        quantile (``attribution_tail_quantile``, p99 by default) from its
        latency histogram, so an attributed run fills its tail
        accumulators in one pass."""
        from isotope_tpu_torch.metrics.histogram import (
            quantile_from_histogram,
        )
        from isotope_tpu_torch.sim.draws import (
            TAIL_PILOT_INDEX,
            RootedSource,
        )

        q = (
            quantile
            if quantile is not None
            else self.params.attribution_tail_quantile
        )
        pilot_n = max(1, min(num_requests, 8_192))
        with telemetry.span("attribution.tail_pilot"):
            pilot = self.run_summary(
                load, pilot_n, RootedSource(source, TAIL_PILOT_INDEX),
                block_size=(
                    min(block_size, pilot_n) if load.kind == OPEN_LOOP
                    else block_size
                ),
            )
            return float(
                quantile_from_histogram(pilot.latency_hist, [q])[0]
            )

    def run_attributed(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        collector=None,
        trim: bool = False,
        tail: bool = False,
        tail_cut: Optional[float] = None,
    ):
        """Like :meth:`run_summary`, but the block loop ALSO reduces an
        :class:`~isotope_tpu_torch.metrics.attribution.
        AttributionSummary`: per-hop critical-path blame, the
        wait-vs-service split, blame histograms and top-K tail
        exemplars, on the device.

        Same draws and blocking as :meth:`run_summary`, so the returned
        ``RunSummary`` equals an unattributed run's.  ``tail=True`` arms
        the conditional-tail accumulators at ``tail_cut`` (estimated by
        :meth:`estimate_tail_cut` when not given).  Returns
        ``(RunSummary, AttributionSummary)``.
        """
        if not self.params.attribution:
            raise ValueError(
                "attributed runs need SimParams(attribution=True)"
            )
        faults.check("engine.run")
        if tail and tail_cut is None:
            tail_cut = self.estimate_tail_cut(
                load, num_requests, source, block_size=block_size
            )
        return self._run_summary(
            load, num_requests, source, block_size, collector, trim,
            attr=True, tail_cut=tail_cut if tail else None,
        )

    # -- the flight recorder and the protected runs ------------------------

    def plan_timeline_windows(
        self, total_requests: int, offered: float,
        window_s: Optional[float] = None,
    ) -> Tuple[int, float]:
        """The static ``(num_windows, window_s)`` grid of a run: the
        expected sim duration (requests / offered rate) cut into
        ``timeline_window_s`` windows, clamped (with a warning) by
        ``timeline_max_windows`` and the recorder's element budget
        (``metrics/timeline.plan_windows``)."""
        from isotope_tpu_torch.metrics import timeline as timeline_mod

        dt = (
            float(window_s)
            if window_s is not None
            else self.params.timeline_window_s
        )
        expected = total_requests / max(float(offered), 1e-9)
        w, dt_eff, _ = timeline_mod.plan_windows(
            expected, dt, self.params.timeline_max_windows,
            self.compiled.num_services,
        )
        return w, dt_eff

    def _control(self, load, num_requests, source, block_size, window_s,
                 policies: bool, rollouts: bool,
                 tl_plan=None) -> "_BlockControl":
        """The carry of a recorded or protected loop, its window grid
        planned from the run's rate unless ``tl_plan`` gives it (a
        fleet's members share the grid of member 0's rate)."""
        if tl_plan is None:
            offered, block, num_blocks = self._block_plan(
                load, num_requests, source, block_size
            )
            tl_plan = self.plan_timeline_windows(
                num_blocks * block, offered, window_s
            )
        return _BlockControl(self, tl_plan, policies, rollouts)

    def run_timeline(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        collector=None,
        trim: bool = False,
        window_s: Optional[float] = None,
    ):
        """Like :meth:`run_summary`, but the block loop ALSO reduces a
        :class:`~isotope_tpu_torch.metrics.timeline.TimelineSummary`:
        the flight recorder's per-service x per-window series, binned on
        the device from each block's absolute sim-time clocks.

        Same draws and blocking as :meth:`run_summary`, so the returned
        ``RunSummary`` equals an unrecorded run's with the same
        arguments.  Returns ``(RunSummary, TimelineSummary)``.
        """
        if not self.params.timeline:
            raise ValueError(
                "timeline runs need SimParams(timeline=True)"
            )
        faults.check("engine.run")
        control = self._control(load, num_requests, source, block_size,
                                window_s, False, False)
        summary = self._run_summary(load, num_requests, source, block_size,
                                    collector, trim, control)
        return summary, control.tl_acc

    def run_policies(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        collector=None,
        trim: bool = False,
        window_s: Optional[float] = None,
        attribution: bool = False,
        tail: bool = False,
        tail_cut: Optional[float] = None,
    ):
        """Co-simulate the per-service resilience policies
        (``sim/policies.py``) in the block loop: the loop carries the
        policy state next to the flight recorder's accumulator, each
        block runs under the CURRENT policy effects (breaker sheds,
        budgeted retries, autoscaled capacity in the wait law), and the
        control law advances through every window the block completed —
        observation at window granularity, actuation at block
        granularity (one block of lag).

        Returns ``(RunSummary, TimelineSummary, PolicySummary)``; the
        summary and timeline reflect the PROTECTED physics.  Requires
        policy tables (``Simulator(..., policies=...)``) and
        ``SimParams.timeline=True`` (the recorder is the observation
        side of every control loop).  Saturated ``-qps max`` loads are
        refused: the finite-population tables are host-built from static
        replica counts the policy state cannot reach.

        ``attribution=True`` (needs ``SimParams.attribution``) ALSO
        reduces the critical-path blame over the protected physics in
        the same loop and appends an ``AttributionSummary``;
        ``tail=True`` arms its tail accumulators at ``tail_cut``
        (estimated from an UNPROTECTED pilot when not given).
        """
        if self._policies is None:
            raise ValueError(
                "policy runs need compiled policy tables "
                "(Simulator(..., policies=compile_policies(graph, "
                "compiled)))"
            )
        if not self.params.timeline:
            raise ValueError(
                "policy runs need SimParams(timeline=True) — the "
                "flight recorder is the control loop's observation side"
            )
        if self._saturated(load):
            raise ValueError(
                "policy runs do not support saturated -qps max loads: "
                "the finite-population wait tables are host-built from "
                "static replica counts the policy state cannot change; "
                "use a paced closed loop or open loop"
            )
        if attribution and not self.params.attribution:
            raise ValueError(
                "attributed policy runs need SimParams(attribution="
                "True) alongside the policy tables"
            )
        # the policy layer's own chaos sites: standard fault kinds raise
        # classified faults here so the supervisor's retry path covers
        # the policy runner too; the behavioral kinds (stuck/lag) alter
        # the control loop instead (_BlockControl)
        faults.check("policies.stuck_breaker")
        faults.check("policies.autoscaler_lag")
        faults.check("engine.run")
        return self._run_protected(load, num_requests, source, False,
                                   block_size, collector, trim, window_s,
                                   attribution, tail, tail_cut)

    def _run_protected(self, load, num_requests, source, roll: bool,
                       block_size: int, collector, trim: bool,
                       window_s: Optional[float], attribution: bool = False,
                       tail: bool = False,
                       tail_cut: Optional[float] = None,
                       cpu_scale=None, err_scale=None, tl_plan=None,
                       control=None, clock=None, plan=None):
        """The shared tail of :meth:`run_policies` and
        :meth:`run_rollouts`: one block loop whose carry holds the
        clocks, the recorder's accumulator, the (S, W) retry
        observations, the policy state and its series (with policy
        tables), and the rollout observations, state and series (``roll``).
        Block ``b+1`` runs under the effects taken after block ``b``.

        Returns ``(summary, timeline[, rollout summary][, policy
        summary][, attribution])``.  ``cpu_scale`` / ``err_scale`` and
        ``tl_plan`` are a fleet member's (:meth:`run_policies_ensemble`);
        ``control`` (resumed from a carry), ``clock`` and ``plan`` its
        carry export's (:meth:`run_blocks`)."""
        if attribution and tail and tail_cut is None:
            tail_cut = self.estimate_tail_cut(
                load, num_requests, source, block_size=block_size
            )
        if control is None:
            control = self._control(
                load, num_requests, source, block_size, window_s,
                self._policies is not None, roll, tl_plan=tl_plan,
            )
        summary = self._run_summary(
            load, num_requests, source, block_size, collector, trim,
            control, attr=attribution, tail_cut=tail_cut if tail else None,
            cpu_scale=cpu_scale, err_scale=err_scale, clock=clock,
            plan=plan,
        )
        if attribution:
            summary, attr = summary
        out = (summary,) + control.outputs()
        if attribution:
            out = out + (attr,)
        return out

    def _policy_downed_windows(self, spec, base_split: bool = False):
        """(S, W) chaos-downed replica counts per recorder window (the
        nominal phase covering each window's END), or None without
        chaos — the autoscaler's alive-capacity denominator must see the
        kill, or a dead service reads as idle and scales DOWN.
        ``base_split`` (rollout runs) reports the BASELINE arm's share of
        the delta only (the canary-first kill attribution)."""
        if self._policies is None or not self.has_chaos:
            return None
        cuts = self._phase_starts.astype(np.float64)
        w_end = (
            np.arange(spec.num_windows, dtype=np.float64) + 1.0
        ) * spec.window_s
        p_idx = np.clip(
            np.searchsorted(cuts, w_end, side="right") - 1,
            0, len(cuts) - 1,
        )
        downed = (
            self._downed_base_p_np if base_split else self._downed_p_np
        )
        return _const(downed[p_idx].T, F32, self.device)

    def run_rollouts(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        *,
        block_size: int = 65_536,
        collector=None,
        trim: bool = False,
        window_s: Optional[float] = None,
        attribution: bool = False,
        tail: bool = False,
        tail_cut: Optional[float] = None,
    ):
        """Co-simulate the progressive-delivery rollout controller
        (``sim/rollout.py``) in the block loop: each block's hops route
        to the canary arm with the CURRENT weight (its own station,
        error rate and cpu time), and the controller advances through
        every completed window — PROMOTE / HOLD / ROLL BACK.  A
        Simulator that ALSO has policy tables runs the policy loops in
        the same carry (a rolled-back canary's load surge flows into the
        breakers and the autoscaler).

        Returns ``(RunSummary, TimelineSummary, RolloutSummary[,
        PolicySummary][, AttributionSummary])`` (``attribution``, ``tail``
        and ``tail_cut`` as in :meth:`run_policies`).  Requires rollout
        tables (``Simulator(...,
        rollouts=...)``) and ``SimParams.timeline=True``; saturated
        ``-qps max`` loads are refused.
        """
        if self._rollouts is None:
            raise ValueError(
                "rollout runs need compiled rollout tables "
                "(Simulator(..., rollouts=compile_rollouts(graph, "
                "compiled)))"
            )
        if not self.params.timeline:
            raise ValueError(
                "rollout runs need SimParams(timeline=True) — the "
                "flight recorder is the control loop's observation side"
            )
        if self._saturated(load):
            raise ValueError(
                "rollout runs do not support saturated -qps max loads: "
                "the finite-population wait tables are host-built from "
                "static replica counts the rollout state cannot split; "
                "use a paced closed loop or open loop"
            )
        if attribution and not self.params.attribution:
            raise ValueError(
                "attributed rollout runs need SimParams(attribution="
                "True) alongside the rollout tables"
            )
        if self._policies is not None:
            # the policy layer's chaos sites cover composed runs too
            faults.check("policies.stuck_breaker")
            faults.check("policies.autoscaler_lag")
        faults.check("engine.run")
        return self._run_protected(load, num_requests, source, True,
                                   block_size, collector, trim, window_s,
                                   attribution, tail, tail_cut)

    # -- Monte Carlo fleets (sim/ensemble.py) -------------------------------

    def _member_planner(self, events) -> "Simulator":
        """A sibling Simulator carrying ONE fleet member's chaos
        schedule: its phase reach multipliers, retry-feedback fixed
        point, drain windows, closed-loop rate solves and device tables
        are exactly the solo run's under that schedule, so a ``"map"``
        member runs its block loop and equals that solo run.  A member
        on the base schedule gets this Simulator itself."""
        events = tuple(events)
        if events == self._chaos_events:
            return self
        return Simulator(
            self.compiled, self.params, chaos=events,
            churn=self._churn, mtls=self._mtls,
            policies=self._policies, rollouts=self._rollouts,
            lb=self._lb, device=self.device,
        )

    def _check_member_chaos(self) -> None:
        """Per-member chaos needs a base schedule to jitter."""
        if not self.has_chaos:
            raise ValueError(
                "per-member chaos needs a base chaos schedule to "
                "jitter (Simulator(..., chaos=[...]))"
            )

    def _resolve_member_chaos(self, member_chaos, seeds,
                              with_pol: bool = False, roll: bool = False,
                              sat_conns: int = 0, source=None):
        """Normalize a fleet's ``member_chaos``: a
        :class:`~isotope_tpu_torch.resilience.faults.ChaosJitterSpec`
        (each member's schedule jittered from its seed) or an explicit
        list of per-member ``ChaosEvent`` sequences.  Returns
        ``(member_events, planners, ChaosFx)``, or three ``None`` when
        off (``compiler.compile_chaos_members``)."""
        if member_chaos is None:
            return None, None, None
        from isotope_tpu_torch.compiler.compile import compile_chaos_members
        from isotope_tpu_torch.resilience import faults

        self._check_member_chaos()
        if isinstance(member_chaos, faults.ChaosJitterSpec):
            reps = self.compiled.services.replicas_by_name()
            E = len(self._chaos_events)
            member_events = [
                faults.jitter_chaos_events(
                    self._chaos_events, member_chaos,
                    faults.member_event_seeds(member_chaos, s, E),
                    reps,
                )
                for s in seeds
            ]
        else:
            member_events = [tuple(evts) for evts in member_chaos]
            if len(member_events) != len(seeds):
                raise ValueError(
                    f"member_chaos has {len(member_events)} schedules "
                    f"for {len(seeds)} members"
                )
        planners, fx = compile_chaos_members(
            self, member_events, with_pol=with_pol, roll=roll,
            sat_conns=sat_conns, source=source,
        )
        return member_events, planners, fx

    def _ensemble_args(self, load: LoadModel, num_requests: int, source,
                       spec, tables, member_keys=None,
                       block_size: int = 65_536, trim: bool = False,
                       member_qps=None, planners=None) -> dict:
        """Host planning of a fleet: each member's draw source, load,
        offered rate, pace, nominal gap, trim window, visit table and
        phase windows, on one shared ``(block, num_blocks)``.

        Member k draws from ``RootedSource(source, seeds[k])`` (the
        reference's ``fold_in(key, seed)``), or from ``member_keys[k]``
        (explicit draw sources).  Closed-loop members solve their rate
        from their own source (the solo solver's pilots), at the BASE
        cpu: a cpu jitter moves the wait law and the service draws
        exactly, the rate solve and the retry-feedback fixed point are
        base-cpu approximations, as in the reference.  ``member_qps``
        sets each member's target qps exactly; ``planners`` (chaos
        fleets) give each member its own host tables."""
        from isotope_tpu_torch.metrics.fortio import trim_window_bounds
        from isotope_tpu_torch.sim.draws import RootedSource

        sat = self._saturated(load)
        if sat and (spec.jittered or spec.qps_scale is not None):
            raise ValueError(
                "saturated -qps max ensembles support seed members "
                "only (the finite-population wait tables are host-side"
                " constants); pace the closed loop or jitter an "
                "open-loop run"
            )
        if spec.qps_scale is not None and load.qps is None:
            raise ValueError(
                "qps jitter needs a finite target qps (load.qps is "
                "None)"
            )
        n_mem = spec.members
        if member_qps is not None:
            member_qps = np.asarray(member_qps, np.float64)
            if member_qps.shape != (n_mem,):
                raise ValueError(
                    f"member_qps must have shape ({n_mem},); got "
                    f"{member_qps.shape}"
                )
            if sat:
                raise ValueError(
                    "member_qps cannot override a saturated -qps max "
                    "load"
                )
        if planners is not None and len(planners) != n_mem:
            raise ValueError(
                f"planners has {len(planners)} entries for {n_mem} "
                "members"
            )
        if member_keys is None:
            sources = [RootedSource(source, s) for s in spec.seeds]
        else:
            sources = list(member_keys)
            if len(sources) != n_mem:
                raise ValueError(
                    f"member_keys has {len(sources)} entries for "
                    f"{n_mem} members"
                )
        if load.kind == OPEN_LOOP:
            conns = 0
            block = max(1, min(block_size, num_requests))
        else:
            conns = load.connections
            per = max(1, min(block_size, num_requests) // conns)
            block = per * conns
        num_blocks = max(1, -(-num_requests // block))
        loads, offered, pace, nominal = [], [], [], []
        win_lo = np.zeros(n_mem, np.float64)
        win_hi = np.full(n_mem, np.inf, np.float64)
        visits, windows = [], []
        for m in range(n_mem):
            host = self if planners is None else planners[m]
            scale = float(tables.qps_scale[m])
            if member_qps is not None:
                qps_m = float(member_qps[m])
            elif load.qps is None:
                qps_m = None
            else:
                qps_m = (
                    float(load.qps) if scale == 1.0
                    else float(load.qps) * scale
                )
            load_m = (
                load if qps_m == load.qps
                else dataclasses.replace(load, qps=qps_m)
            )
            if load.kind == OPEN_LOOP:
                off, pc, nom = qps_m, 0.0, 0.0
            else:
                off = host.solve_closed_rate(load_m, num_requests,
                                             sources[m])
                pc = conns / load_m.qps if load_m.qps is not None else 0.0
                nom = conns / off
            loads.append(load_m)
            offered.append(off)
            pace.append(pc)
            nominal.append(nom)
            visits.append(host._vis_arg(off))
            windows.append(host._windows_arg(off, sat))
            if trim:
                win_lo[m], win_hi[m] = trim_window_bounds(
                    num_blocks * block, off
                )
        return dict(
            sat=sat, kind=load.kind, conns=conns, block=block,
            num_blocks=num_blocks, sources=sources, loads=loads,
            offered=np.asarray(offered, np.float64),
            pace=np.asarray(pace, np.float64),
            nominal=np.asarray(nominal, np.float64),
            win_lo=win_lo, win_hi=win_hi, visits=visits, windows=windows,
        )

    def ensemble_chunk_size(self, members: int, block: int,
                            attr: bool = False,
                            timeline_windows: Optional[int] = None,
                            chaos_fx=None, *, load=None, tl_plan=None,
                            tail_cut=None, jittered: bool = False) -> int:
        """The auto member chunk: how many members fold into one block
        (:meth:`_chunk_and_sizes`).  With the fleet's ``load``, from two
        pilot blocks of one member of its folded program (its
        ``chaos_fx`` rows, ``jittered`` scales, with ``attr`` its blame
        at ``tail_cut`` and with ``tl_plan`` its recorder).  Without
        one, the reference's law: the plan-only peak of the block plus,
        with ``attr`` / ``timeline_windows``, an observed fleet's
        reductions."""
        return self._chunk_and_sizes(
            members, block, attr, chaos_fx, load, tail_cut, jittered,
            tl_plan=tl_plan, timeline_windows=timeline_windows,
        )[0]

    def protected_ensemble_chunk(self, members: int, block: int,
                                 tl_plan: Tuple[int, float], roll: bool,
                                 attr: bool = False, chaos_fx=None, *,
                                 load=None, tail_cut=None,
                                 jittered: bool = False) -> int:
        """A protected fleet's auto chunk: as :meth:`ensemble_chunk_size`,
        the pilot under the fleet's control laws on ``tl_plan``'s
        window grid; without a load, the plain split with each member's
        control carry (and, ``attr``, its blame reductions)."""
        return self._chunk_and_sizes(
            members, block, attr, chaos_fx, load, tail_cut, jittered,
            tl_plan=tl_plan, roll=roll,
        )[0]

    def _chunk_and_sizes(self, members, block, attr, chaos_fx, load,
                         tail_cut, jittered, tl_plan=None,
                         timeline_windows=None, roll=None):
        """``(members per chunk, sizes)`` of a fleet against the device's
        memory (the CPU reports none: one chunk).  ``roll`` None: an
        unprotected fleet, observed by the recorder on ``tl_plan`` when
        given; else a protected one.  With ``load`` the sizes are the
        ``(fixed, per member)`` bytes of
        ``analysis/costmodel.fleet_member_bytes``; without one (or
        without a capacity) the reference's plan-only law, and None."""
        from isotope_tpu_torch.analysis import costmodel

        cap = costmodel.device_capacity_bytes(device=self.device)
        if load is None or cap is None:
            if roll is None:
                carry = costmodel.observability_carry_bytes(
                    self, attr=attr, timeline_windows=timeline_windows,
                )
            else:
                carry = costmodel.protected_carry_bytes(
                    self, tl_plan[0], roll=roll,
                )
                if attr:
                    carry += costmodel.observability_carry_bytes(
                        self, attr=True,
                    )
            return costmodel.ensemble_chunk(
                members, costmodel.peak_bytes_at_block(self, block), cap,
                carry_bytes_per_member=carry,
            ), None
        control = None
        if roll is not None:
            control = (tuple(tl_plan), self._policies is not None,
                       bool(roll))
        elif tl_plan is not None:
            control = (tuple(tl_plan), False, False)
        sizes = costmodel.fleet_member_bytes(
            self, load, block, control=control,
            blame=tail_cut if attr else False, chaos_fx=chaos_fx,
            jittered=jittered,
        )
        return costmodel.fleet_chunk(members, sizes, cap), sizes

    def zero_ensemble_carry(self, n_mem: int, connections: int) -> FleetCarry:
        """The fresh-start member-stacked ``(t0, conn_t0, req_off)``
        carry a plain fleet resumes from at t=0 (the zeros the block
        loop starts from)."""
        c = max(connections, 1)
        z = torch.zeros(n_mem, dtype=F32, device=self.device)
        return FleetCarry(
            z, torch.zeros((n_mem, c), dtype=F32, device=self.device),
            z.clone(),
        )

    def zero_protected_carry(self, n_mem: int, connections: int,
                             tl_plan: Tuple[int, float],
                             roll: bool = False) -> ProtectedCarry:
        """The fresh-start member-stacked carry of a protected fleet
        (:class:`ProtectedCarry`): zero clocks and the initial control
        state of ``tl_plan``'s window grid, one row a member.  A
        protected fleet resuming from exactly these at
        ``block_offset=0`` equals the unbroken protected fleet."""
        from isotope_tpu_torch.sim import ensemble as ens_mod

        control = _BlockControl(self, tl_plan, self._policies is not None,
                                roll)
        row = control.export(_Clock.zero(self, connections).export())
        return ens_mod.tree_stack([row] * n_mem)

    def _member_scales(self, tables, m: int):
        """Member ``m``'s ``(cpu_scale, err_scale)`` 0-d tensors, or
        ``(None, None)`` for a fleet without physics jitter."""
        if not tables.jittered:
            return None, None
        return (tables.cpu_scale[m].to(self.device),
                tables.err_scale[m].to(self.device))

    def run_ensemble(
        self,
        load: LoadModel,
        num_requests: int,
        source,
        spec=None,
        *,
        block_size: int = 65_536,
        trim: bool = False,
        chunk: Optional[int] = None,
        member_keys=None,
        member_qps=None,
        member_chaos=None,
        carry_in=None,
        return_carry: bool = False,
        block_offset: int = 0,
        attribution: bool = False,
        tail: bool = False,
        tail_cut: Optional[float] = None,
        timeline: bool = False,
        window_s: Optional[float] = None,
    ):
        """Simulate a Monte Carlo fleet (``sim/ensemble.py``).

        Each member is a full ``run_summary``-shaped run of
        ``num_requests`` under its own draws (``RootedSource(source,
        seed)``, or ``member_keys[k]``), its own offered rate
        (``qps_scale``, or ``member_qps``), cpu and error perturbations
        and, under ``member_chaos`` (a ``ChaosJitterSpec`` or explicit
        per-member schedules), its own chaos schedule.  ``spec``
        defaults to a seeds-only fleet of ``SimParams.ensemble``
        members.

        The member axis runs in the spec's mode.  ``"map"`` runs the
        members one after another through the solo block loop, so
        member k is bit-equal to its solo run on the same source.
        ``"vmap"`` (the default on CUDA) folds a chunk of M members into
        one block of M x N rows: one census call of (M*N, B, P) a level,
        each member's scalars broadcast to its rows; integers equal the
        ``"map"`` fleet's, float sums agree within float32 summation
        order.  ``chunk`` (or ``spec.chunk``) caps M; None sizes it
        from the cost model against the device's memory
        (:meth:`ensemble_chunk_size`).  Every fleet folds: seeds and
        qps / cpu / error jitter on open, paced and saturated loads
        under the Simulator's own chaos, churn, mTLS and lb laws; chaos
        fleets (each row reads its member's ``ChaosFx`` tables); and
        observed fleets (the recorder and the blame sweep reduce each
        member's rows, binned by member).

        ``attribution`` (needs ``SimParams.attribution``) reduces each
        member's critical-path blame and ``timeline`` (needs
        ``SimParams.timeline``) its recorder series, over the member's
        own rows: the result stacks them under
        ``attributions`` / ``timelines``.  ``tail=True`` arms the tail
        accumulators at ``tail_cut``, estimated once on the FLEET's
        source when not given.  The timeline grid is planned from
        member 0's rate (``window_s`` overrides the width).

        The carry export (the search brackets, ``sim/search.py``):
        ``block_offset`` starts every member's block loop at that block
        index (block b draws from index ``1_000_000 + block_offset + b``
        of the member's source), ``carry_in`` seeds the member-stacked
        ``(t0, conn_t0, req_off)`` clocks (:class:`FleetCarry`; None =
        :meth:`zero_ensemble_carry`), and ``return_carry`` returns
        ``(summary, carry_out)`` so the next segment continues where
        this one stopped.  Segments carried so equal the unbroken run
        on every exact field; a zero carry at offset 0 is the plain
        fleet bit for bit.  They need ``trim=False``, no
        ``member_chaos`` and no attribution or timeline, as in the
        reference.  Returns an
        :class:`~isotope_tpu_torch.sim.ensemble.EnsembleSummary`.
        """
        fp = self._plan_fleet(
            load, num_requests, source, spec, block_size=block_size,
            trim=trim, member_keys=member_keys, member_qps=member_qps,
            member_chaos=member_chaos, attribution=attribution, tail=tail,
            tail_cut=tail_cut, timeline=timeline, window_s=window_s,
        )
        carry_run = (
            carry_in is not None or return_carry or block_offset != 0
        )
        if carry_run and (trim or fp.planners is not None):
            raise ValueError(
                "the ensemble carry export (carry_in/return_carry/"
                "block_offset) requires trim=False and no member_chaos"
            )
        if carry_run and (attribution or timeline):
            raise ValueError(
                "the ensemble carry export does not compose with the "
                "attribution/timeline reductions (screen first, then "
                "explain with an observed fleet)"
            )
        n_mem = fp.spec.members
        chunk_sz, sizes = self._fleet_chunk(fp, n_mem, chunk)
        if carry_run and carry_in is None:
            carry_in = self.zero_ensemble_carry(n_mem, fp.args["conns"])
        cols = self._fleet_members(fp, range(n_mem), chunk_sz,
                                   carry=carry_in,
                                   start_block=int(block_offset))
        ens = self._fleet_result(fp, cols, chunk_sz, sizes)
        if return_carry:
            return ens, cols[-1]
        return ens

    def _plan_fleet(self, load, num_requests: int, source, spec, *,
                    block_size: int = 65_536, trim: bool = False,
                    member_keys=None, member_qps=None, member_chaos=None,
                    attribution: bool = False, tail: bool = False,
                    tail_cut: Optional[float] = None, timeline: bool = False,
                    window_s: Optional[float] = None) -> "_FleetPlan":
        """The host plan of an unprotected fleet (:meth:`run_ensemble`):
        the spec, its compiled tables, every member's
        :meth:`_ensemble_args`, the members' chaos, the tail cut (one
        pilot on the fleet's source) and the recorder's grid (member
        0's rate).  Shared by the solo fleet and the mesh's
        (``parallel/sharded.py``), so both run the same members."""
        from isotope_tpu_torch.compiler.compile import compile_ensemble
        from isotope_tpu_torch.sim import ensemble as ens_mod

        if spec is None:
            if self.params.ensemble <= 0:
                raise ValueError(
                    "run_ensemble needs an EnsembleSpec (or "
                    "SimParams.ensemble > 0 for the seeds-only "
                    "default fleet)"
                )
            spec = ens_mod.EnsembleSpec.of(self.params.ensemble)
        spec.check(allow_duplicate_seeds=member_keys is not None)
        self._check_lb_load(load)
        if attribution and not self.params.attribution:
            raise ValueError(
                "attributed fleets need SimParams(attribution=True)"
            )
        if timeline and not self.params.timeline:
            raise ValueError(
                "timeline fleets need SimParams(timeline=True)"
            )
        faults.check("engine.run")
        if attribution and tail and tail_cut is None:
            # ONE pilot, on the fleet's source, serves every member
            tail_cut = self.estimate_tail_cut(
                load, num_requests, source, block_size=block_size
            )
        tables = compile_ensemble(spec, self.device)
        sat = self._saturated(load)
        member_events, planners, fx = self._resolve_member_chaos(
            member_chaos, spec.seeds,
            sat_conns=load.connections if sat else 0, source=source,
        )
        args = self._ensemble_args(
            load, num_requests, source, spec, tables,
            member_keys=member_keys, block_size=block_size, trim=trim,
            member_qps=member_qps, planners=planners,
        )
        tl_plan = None
        if timeline:
            tl_plan = self.plan_timeline_windows(
                args["num_blocks"] * args["block"],
                float(args["offered"][0]), window_s,
            )
        return _FleetPlan(
            spec=spec, tables=tables, args=args, load=load,
            num_requests=num_requests, block_size=block_size, trim=trim,
            member_events=member_events, planners=planners, fx=fx,
            attribution=bool(attribution),
            tail_cut=tail_cut if tail else None, timeline=bool(timeline),
            tl_plan=tl_plan, roll=None, window_s=window_s,
        )

    def _fleet_chunk(self, fp: "_FleetPlan", members: int, chunk=None):
        """``(members per folded chunk, sizes)`` of a planned fleet
        running ``members`` members on this device: ``chunk`` (or the
        spec's) when given, else the cost model's
        (:meth:`_chunk_and_sizes`)."""
        chunk_sz = chunk if chunk is not None else fp.spec.chunk
        sizes = None
        if chunk_sz is None:
            chunk_sz, sizes = self._chunk_and_sizes(
                members, fp.args["block"], fp.attribution, fp.fx, fp.load,
                fp.tail_cut, fp.tables.jittered, tl_plan=fp.tl_plan,
                timeline_windows=fp.tl_plan[0] if fp.tl_plan else None,
                roll=fp.roll,
            )
        return max(1, min(int(chunk_sz), max(members, 1))), sizes

    def _fleet_members(self, fp: "_FleetPlan", ids, chunk_sz: int,
                       carry=None, start_block: int = 0) -> list:
        """Members ``ids`` (indices into the plan) of a planned fleet,
        in the spec's mode: ``"vmap"`` folding ``chunk_sz`` consecutive
        ids a chunk, ``"map"`` each through its own block loop.
        ``carry`` (member-stacked, one row an id) resumes their clocks
        (and a protected fleet's control state) at ``start_block``.
        Returns ``[summary, timelines, rollouts, policies,
        attributions, carry out]``, each member-stacked in ``ids``
        order, None where not run."""
        from isotope_tpu_torch.compiler.compile import ensemble_take
        from isotope_tpu_torch.sim import ensemble as ens_mod

        ids = list(ids)
        args, tables = fp.args, fp.tables
        idx = torch.tensor(ids, dtype=torch.int64)
        fx = ensemble_take(fp.fx, idx) if fp.fx is not None else None
        if fp.roll is not None:
            return self._protected_members(fp, ids, chunk_sz, carry,
                                           start_block, fx)
        timeline, attribution = fp.timeline, fp.attribution
        tl_stack = attr_stack = carry_out = None
        if tables.mode == "vmap":
            control = None
            if timeline:
                def control(rows):
                    return _BlockControl(self, fp.tl_plan, False, False,
                                         members=rows)
            summaries, carry_out, ctl, attr_stack = self._fleet_chunks(
                args, ids, ensemble_take(
                    self._ensemble_stacked_args(args, tables), idx
                ), chunk_sz, fp.trim, start_block=start_block,
                carry=carry, fx=fx, control=control,
                attr=fp.tail_cut if attribution else False,
            )
            if timeline:
                tl_stack = ctl[0]
        elif fp.planners is None and not (attribution or timeline):
            summaries, carry_out = self._plain_fleet(
                args, tables, ids, fp.trim, start_block=start_block,
                carry=carry,
            )
        else:
            outs = []
            for m in ids:
                host = self if fp.planners is None else fp.planners[m]
                cpu, err = self._member_scales(tables, m)
                control = (
                    _BlockControl(host, fp.tl_plan, False, False)
                    if timeline else None
                )
                out = host._run_summary(
                    args["loads"][m], fp.num_requests, args["sources"][m],
                    fp.block_size, None, fp.trim, control,
                    attr=attribution, tail_cut=fp.tail_cut, cpu_scale=cpu,
                    err_scale=err, fleet=True,
                )
                summary, attr = out if attribution else (out, None)
                outs.append((
                    summary,
                    control.tl_acc if timeline else None,
                    attr,
                ))
            summaries = ens_mod.tree_stack([o[0] for o in outs])
            if timeline:
                tl_stack = ens_mod.tree_stack([o[1] for o in outs])
            if attribution:
                attr_stack = ens_mod.tree_stack([o[2] for o in outs])
        return [summaries, tl_stack, None, None, attr_stack, carry_out]

    def _fleet_result(self, fp: "_FleetPlan", cols: list, chunk_sz: int,
                      sizes=None):
        """The :class:`~isotope_tpu_torch.sim.ensemble.EnsembleSummary`
        of a planned fleet from its members' columns
        (:meth:`_fleet_members`, every member in order)."""
        from isotope_tpu_torch.sim import ensemble as ens_mod

        summary, tl, roll, pol, attr, _ = cols
        return ens_mod.EnsembleSummary(
            spec=fp.spec,
            summaries=summary,
            offered_qps=fp.args["offered"],
            chunk=chunk_sz,
            member_chaos=fp.member_events,
            timelines=tl,
            policies=pol,
            rollouts=roll,
            attributions=attr,
            member_bytes=sizes,
        )

    def _ensemble_stacked_args(self, args: dict, tables) -> dict:
        """A planned fleet's per-member inputs (``args`` of
        :meth:`_ensemble_args`) as member-stacked tensors on the device:
        the folded block's arguments, and what a search bracket gathers
        its survivors' rows from (``compiler/compile.ensemble_take``)."""
        dev = self.device

        def col(key):
            return torch.as_tensor(
                np.asarray(args[key]), dtype=F32
            ).to(dev)

        jit = tables.jittered
        return dict(
            offered=col("offered"), pace=col("pace"),
            nominal=col("nominal"), win_lo=col("win_lo"),
            win_hi=col("win_hi"),
            visits=torch.stack(args["visits"]),
            windows=torch.stack(args["windows"]),
            cpu_scale=tables.cpu_scale.to(dev) if jit else None,
            err_scale=tables.err_scale.to(dev) if jit else None,
        )

    def _plain_fleet(self, args: dict, tables, ids, trim: bool,
                     start_block: int = 0,
                     num_blocks: Optional[int] = None, carry=None):
        """Members ``ids`` (indices into the plan ``args``) of a plain
        ``"map"`` fleet, each through its solo block loop on the fleet's
        plan, ``carry`` (a :class:`FleetCarry`, or None) their clocks in
        ``ids`` order (the ``"vmap"`` fleets fold through
        :meth:`_fleet_chunks`).  Each runs ``num_blocks`` blocks
        (default: the plan's) from block ``start_block``.  Returns
        ``(member-stacked RunSummary, FleetCarry)``, the carry None when
        none was given."""
        from isotope_tpu_torch.sim import ensemble as ens_mod

        ids = list(ids)
        block = args["block"]
        nb = args["num_blocks"] if num_blocks is None else int(num_blocks)
        outs, clocks = [], []
        for row, g in enumerate(ids):
            cpu, err = self._member_scales(tables, g)
            clock = (
                None if carry is None
                else _Clock.resume(carry, row, start_block)
            )
            outs.append(self._run_summary(
                args["loads"][g], nb * block, args["sources"][g], block,
                None, trim, cpu_scale=cpu, err_scale=err, fleet=True,
                clock=clock, plan=(float(args["offered"][g]), block, nb),
            ))
            clocks.append(clock)
        if carry is None:
            return ens_mod.tree_stack(outs), None
        return ens_mod.tree_stack(outs), FleetCarry(*(
            torch.stack(x) for x in zip(*(c.export() for c in clocks))
        ))

    def _fleet_chunks(self, args: dict, ids, stacked: dict, chunk_sz: int,
                      trim: bool, start_block: int = 0,
                      num_blocks: Optional[int] = None, carry=None,
                      fx=None, control=None, attr=False):
        """Members ``ids`` (indices into the plan ``args``) folded in
        chunks of ``chunk_sz`` (:meth:`_folded_fleet`); ``stacked``,
        ``carry`` (a :class:`FleetCarry` or :class:`ProtectedCarry`)
        and ``fx`` (a member-stacked ``ChaosFx``) are the members' rows
        in ``ids`` order.  ``control(M)`` builds a chunk's folded
        :class:`_BlockControl` (resumed from the chunk's carry rows when
        ``carry`` is a ProtectedCarry); ``attr`` (not False) is the tail
        cut of each member's blame reduction (None: mean blame only).
        Returns ``(summary, carry out, the controls' outputs,
        attribution)``, member-stacked; None where not run."""
        from isotope_tpu_torch.sim import ensemble as ens_mod

        ids = list(ids)
        parts = []
        for lo in range(0, len(ids), chunk_sz):
            hi = min(lo + chunk_sz, len(ids))

            def rows(tree):
                return ens_mod.tree_map(lambda x: x[lo:hi], tree)

            ctl = control(hi - lo) if control is not None else None
            c_rows = rows(carry)
            if isinstance(c_rows, ProtectedCarry):
                ctl.resume(c_rows)
                c_rows = FleetCarry(c_rows.t0, c_rows.conn_t0,
                                    c_rows.req_off)
            summary, clocks, attr_out = self._folded_fleet(
                args, rows(stacked),
                [args["sources"][g] for g in ids[lo:hi]], trim,
                start_block, num_blocks, c_rows, chaos_fx=rows(fx),
                control=ctl, attr=attr,
            )
            if ctl is not None and clocks is not None:
                clocks = ctl.export(clocks)
            parts.append((summary, clocks,
                          ctl.outputs() if ctl is not None else None,
                          attr_out))
        cols = list(zip(*parts))
        outs = None
        if control is not None:
            outs = [ens_mod.tree_cat(list(c)) for c in zip(*cols[2])]
        return (ens_mod.tree_cat(list(cols[0])),
                ens_mod.tree_cat(list(cols[1])), outs,
                ens_mod.tree_cat(list(cols[3])))

    def _folded_fleet(self, args: dict, stacked: dict, sources,
                      trim: bool, start_block: int = 0,
                      num_blocks: Optional[int] = None, carry=None,
                      chaos_fx=None, control=None, attr=False):
        """M members of a planned fleet folded into one block loop
        (``stacked``: their rows of :meth:`_ensemble_stacked_args`,
        ``sources`` their draw sources): each block draws every member's
        block (member k's index ``1_000_000 + b`` of its own source),
        runs ONE :meth:`_simulate_core` over the M x N rows, and reduces
        each member's rows to its own summary.  ``carry`` (a
        :class:`FleetCarry`) starts the members' clocks and
        ``start_block`` the block index; the members must share the
        carry's request offset.  ``chaos_fx`` holds the members'
        ``ChaosFx`` rows (chaos fleets); ``control`` (a folded
        :class:`_BlockControl`) runs each block under its (M, S)
        effects and observes it, each member's laws on its own clock;
        ``attr`` (not False: the tail cut, or None) reduces each
        member's blame.  Returns ``(member-stacked RunSummary,
        FleetCarry or None, member-stacked AttributionSummary or
        None)``."""
        from isotope_tpu_torch.sim import summary as summary_mod

        dev = self.device
        M = len(sources)
        kind, conns, block = args["kind"], args["conns"], args["block"]
        sat = args["sat"]
        nb = args["num_blocks"] if num_blocks is None else num_blocks
        win = (stacked["win_lo"], stacked["win_hi"]) if trim else None
        if carry is None:
            t0 = torch.zeros(M, dtype=F32, device=dev)
            conn_t0 = torch.zeros((M, max(conns, 1)), dtype=F32, device=dev)
            req_off = 0
        else:
            t0, conn_t0 = carry.t0, carry.conn_t0
            offs = {int(x) for x in carry.req_off.tolist()}
            if len(offs) != 1:
                raise ValueError(
                    "folded fleet members must share the carry's request "
                    f"offset (got {sorted(offs)}); run mode=\"map\""
                )
            req_off = offs.pop()
        if attr is not False:
            from isotope_tpu_torch.metrics import attribution
            from isotope_tpu_torch.sim.ensemble import tree_stack

            a_tables = self._attribution_tables()
            top_k = self.params.attribution_top_k
            k0 = min(top_k, block)
            ex = (
                tree_stack([attribution.empty_exemplars(
                    k0, self.compiled.num_hops, dev
                )] * M) if k0 > 0 else None
            )
            a_acc = None
        per = block // max(conns, 1)
        parts = []
        for b in range(nb):
            pfx, rfx = (
                control.effects() if control is not None else (None, None)
            )
            draws = _cat_draws([
                self._draws(src, BLOCK_INDEX_BASE + start_block + b, block,
                            kind, sat, policy=pfx is not None,
                            canary=rfx is not None)
                for src in sources
            ])
            res, t0, conn_t0 = self._simulate_core(
                M * block, kind, conns, draws, stacked["offered"],
                stacked["pace"], stacked["offered"], t0, conn_t0,
                visits_pc=stacked["visits"],
                sat_conns=conns if sat else 0,
                nominal_gap=stacked["nominal"],
                req_offset=req_off + b * per,
                phase_windows=stacked["windows"],
                policy_fx=pfx, rollout_fx=rfx,
                cpu_scale=stacked["cpu_scale"],
                err_scale=stacked["err_scale"], members=M,
                chaos_fx=chaos_fx,
            )
            if control is not None:
                # closed loop: a member's window is final only once its
                # SLOWEST connection passed it
                control.observe(
                    res, conn_t0.amin(-1) if kind == CLOSED_LOOP else t0
                )
            parts.append(summary_mod.summarize_members(res, M, window=win))
            if attr is not False:
                a_acc, ex = attribution.attribute_block(
                    res, a_tables, tail_cut=attr, top_k=top_k,
                    ex_state=ex, members=M, acc=a_acc,
                )
        summary = summary_mod.reduce_stacked(summary_mod.stack(parts))
        attr_out = a_acc._replace(exemplars=ex) if attr is not False else None
        if carry is None:
            return summary, None, attr_out
        return summary, FleetCarry(
            t0, conn_t0,
            torch.full((M,), float(req_off + nb * per), dtype=F32,
                       device=dev),
        ), attr_out

    def run_policies_ensemble(self, load: LoadModel, num_requests: int,
                              source, spec=None, **kw):
        """A fleet of :meth:`run_policies` runs: each member's policy
        control loops (breakers, retry budgets, HPA) ride its own block
        loop and react to its own draws (and, under ``member_chaos``,
        its own schedule).  Member k with the fleet's source
        (``member_keys``) or ``RootedSource(source, seed)`` equals the
        solo ``run_policies`` on that source.  Keywords as in
        :meth:`run_ensemble` (plus ``window_s``, ``attribution``,
        ``tail``, ``tail_cut``; no ``timeline``: the recorder always
        rides; ``carry_in`` / ``return_carry`` / ``block_offset`` carry
        the FULL control state, a :class:`ProtectedCarry`:
        :meth:`zero_protected_carry`).  The members fold in the spec's
        mode as :meth:`run_ensemble`'s do: a ``"vmap"`` chunk runs one
        block loop of M x N rows whose :class:`_BlockControl` carries
        the members' control laws over an (M, S) state, each member
        stepping through its own completed windows.  Returns an
        :class:`~isotope_tpu_torch.sim.ensemble.EnsembleSummary` with
        the stacked ``timelines`` and ``policies``."""
        if self._policies is None:
            raise ValueError(
                "policy fleets need compiled policy tables "
                "(Simulator(..., policies=...))"
            )
        if not self.params.timeline:
            raise ValueError(
                "policy fleets need SimParams(timeline=True) — the "
                "flight recorder is the control loop's observation side"
            )
        faults.check("policies.stuck_breaker")
        faults.check("policies.autoscaler_lag")
        return self._run_protected_ensemble(load, num_requests, source,
                                            spec, roll=False, **kw)

    def run_rollouts_ensemble(self, load: LoadModel, num_requests: int,
                              source, spec=None, **kw):
        """A fleet of :meth:`run_rollouts` runs (with the policy loops
        in the same carry when policy tables are compiled): as
        :meth:`run_policies_ensemble`, with the stacked ``rollouts``."""
        if self._rollouts is None:
            raise ValueError(
                "rollout fleets need compiled rollout tables "
                "(Simulator(..., rollouts=...))"
            )
        if not self.params.timeline:
            raise ValueError(
                "rollout fleets need SimParams(timeline=True) — the "
                "flight recorder is the control loop's observation side"
            )
        if self._policies is not None:
            faults.check("policies.stuck_breaker")
            faults.check("policies.autoscaler_lag")
        return self._run_protected_ensemble(load, num_requests, source,
                                            spec, roll=True, **kw)

    def _run_protected_ensemble(self, load, num_requests, source, spec,
                                *, roll: bool, block_size: int = 65_536,
                                trim: bool = False,
                                window_s: Optional[float] = None,
                                chunk: Optional[int] = None,
                                member_keys=None, member_qps=None,
                                member_chaos=None,
                                attribution: bool = False,
                                tail: bool = False,
                                tail_cut: Optional[float] = None,
                                carry_in=None, return_carry: bool = False,
                                block_offset: int = 0):
        """The shared tail of the protected fleets: the fleet planning
        of :meth:`run_ensemble` over :meth:`_run_protected` members."""
        fp = self._plan_protected_fleet(
            load, num_requests, source, spec, roll=roll,
            block_size=block_size, trim=trim, window_s=window_s,
            member_keys=member_keys, member_qps=member_qps,
            member_chaos=member_chaos, attribution=attribution, tail=tail,
            tail_cut=tail_cut,
        )
        carry_run = (
            carry_in is not None or return_carry or block_offset != 0
        )
        if carry_run and (trim or fp.planners is not None or attribution):
            raise ValueError(
                "the protected carry export (carry_in/return_carry/"
                "block_offset) requires trim=False, no member_chaos, "
                "and no attribution"
            )
        n_mem = fp.spec.members
        chunk_sz, sizes = self._fleet_chunk(fp, n_mem, chunk)
        if carry_run and carry_in is None:
            carry_in = self.zero_protected_carry(
                n_mem, fp.args["conns"], fp.tl_plan, roll=roll,
            )
        cols = self._fleet_members(fp, range(n_mem), chunk_sz,
                                   carry=carry_in,
                                   start_block=int(block_offset))
        ens = self._fleet_result(fp, cols, chunk_sz, sizes)
        if return_carry:
            return ens, cols[-1]
        return ens

    def _plan_protected_fleet(self, load, num_requests, source, spec, *,
                              roll: bool, block_size: int = 65_536,
                              trim: bool = False,
                              window_s: Optional[float] = None,
                              member_keys=None, member_qps=None,
                              member_chaos=None, attribution: bool = False,
                              tail: bool = False,
                              tail_cut: Optional[float] = None
                              ) -> "_FleetPlan":
        """The host plan of a protected fleet
        (:meth:`run_policies_ensemble`, :meth:`run_rollouts_ensemble`):
        :meth:`_plan_fleet`'s, with the control layers (``roll``) and
        the recorder's grid every member's laws share."""
        from isotope_tpu_torch.compiler.compile import compile_ensemble
        from isotope_tpu_torch.sim import ensemble as ens_mod

        if attribution and not self.params.attribution:
            raise ValueError(
                "attributed fleets need SimParams(attribution=True)"
            )
        if attribution and tail and tail_cut is None:
            tail_cut = self.estimate_tail_cut(
                load, num_requests, source, block_size=block_size
            )
        if spec is None:
            if self.params.ensemble <= 0:
                raise ValueError(
                    "protected fleets need an EnsembleSpec (or "
                    "SimParams.ensemble > 0 for the seeds-only "
                    "default fleet)"
                )
            spec = ens_mod.EnsembleSpec.of(self.params.ensemble)
        spec.check(allow_duplicate_seeds=member_keys is not None)
        if self._saturated(load):
            raise ValueError(
                "protected fleets do not support saturated -qps max "
                "loads (static finite-population tables; see "
                "run_policies)"
            )
        self._check_lb_load(load)
        faults.check("engine.run")
        tables = compile_ensemble(spec, self.device)
        member_events, planners, fx = self._resolve_member_chaos(
            member_chaos, spec.seeds, with_pol=True, roll=roll,
        )
        args = self._ensemble_args(
            load, num_requests, source, spec, tables,
            member_keys=member_keys, block_size=block_size, trim=trim,
            member_qps=member_qps, planners=planners,
        )
        tl_plan = self.plan_timeline_windows(
            args["num_blocks"] * args["block"],
            float(args["offered"][0]), window_s,
        )
        return _FleetPlan(
            spec=spec, tables=tables, args=args, load=load,
            num_requests=num_requests, block_size=block_size, trim=trim,
            member_events=member_events, planners=planners, fx=fx,
            attribution=bool(attribution),
            tail_cut=tail_cut if tail else None, timeline=True,
            tl_plan=tl_plan, roll=bool(roll), window_s=window_s,
        )

    def _protected_members(self, fp: "_FleetPlan", ids, chunk_sz: int,
                           carry, start_block: int, fx) -> list:
        """:meth:`_fleet_members` of a protected fleet (``fx`` the ids'
        ``ChaosFx`` rows)."""
        from isotope_tpu_torch.sim import ensemble as ens_mod

        roll, args, tables = fp.roll, fp.args, fp.tables
        carry_out = None
        if tables.mode == "vmap":
            cols, carry_out = self._protected_chunks(
                args, tables, ids, roll, fp.tl_plan, chunk_sz, carry,
                start_block=start_block, trim=fp.trim, fx=fx,
                planners=fp.planners, attribution=fp.attribution,
                tail_cut=fp.tail_cut,
            )
        elif carry is not None:
            cols, carry_out = self._protected_fleet(
                args, tables, ids, roll, fp.window_s, fp.tl_plan, carry,
                start_block=start_block,
            )
        else:
            outs = []
            for m in ids:
                host = self if fp.planners is None else fp.planners[m]
                cpu, err = self._member_scales(tables, m)
                outs.append(host._run_protected(
                    args["loads"][m], fp.num_requests, args["sources"][m],
                    roll, fp.block_size, None, fp.trim, fp.window_s,
                    fp.attribution, fp.tail_cut is not None, fp.tail_cut,
                    cpu_scale=cpu, err_scale=err, tl_plan=fp.tl_plan,
                ))
            # (summary, tl[, roll][, pol][, attr]) per member
            cols = [ens_mod.tree_stack(list(c)) for c in zip(*outs)]
        summary, tl = cols[0], cols[1]
        rest = cols[2:]
        roll_stack = rest.pop(0) if roll else None
        pol_stack = rest.pop(0) if self._policies is not None else None
        attr_stack = rest.pop(0) if fp.attribution else None
        return [summary, tl, roll_stack, pol_stack, attr_stack, carry_out]

    def _protected_chunks(self, args: dict, tables, ids, roll: bool,
                          tl_plan: Tuple[int, float], chunk_sz: int,
                          carry=None, start_block: int = 0,
                          num_blocks: Optional[int] = None,
                          trim: bool = False, fx=None, planners=None,
                          attribution: bool = False, tail_cut=None,
                          stacked: Optional[dict] = None):
        """Members ``ids`` of a protected fleet folded in chunks of
        ``chunk_sz`` (:meth:`_fleet_chunks`): each chunk one block loop
        of M x N rows whose folded :class:`_BlockControl` carries its
        members' control laws, resumed from ``carry`` (a member-stacked
        :class:`ProtectedCarry`, rows in ``ids`` order, or None) at
        ``start_block``.  ``fx`` (the members' ``ChaosFx`` rows, in
        ``ids`` order) and ``planners`` are a chaos fleet's (the
        planners' chaos-downed windows feed the autoscalers);
        ``stacked`` the members' rows of :meth:`_ensemble_stacked_args`
        (default: the plan's, in ``ids`` order).  Returns ``([summary,
        timeline[, rollout][, policy][, attribution]] member-stacked,
        ProtectedCarry or None)``."""
        from isotope_tpu_torch.metrics import timeline as timeline_mod

        ids = list(ids)
        pol = self._policies is not None
        downed = None
        if planners is not None and pol:
            spec = timeline_mod.build_spec(self.compiled, tl_plan[0],
                                           tl_plan[1], self.device)
            downed = torch.stack([
                planners[g]._policy_downed_windows(spec, base_split=roll)
                for g in ids
            ])
        if stacked is None:
            from isotope_tpu_torch.compiler.compile import ensemble_take

            stacked = ensemble_take(
                self._ensemble_stacked_args(args, tables), torch.tensor(ids)
            )
        offset = [0]

        def control(m):
            lo = offset[0]
            offset[0] += m
            return _BlockControl(
                self, tl_plan, pol, roll, members=m,
                downed_w=downed[lo:lo + m] if downed is not None else None,
            )

        summary, carry_out, outs, attr = self._fleet_chunks(
            args, ids, stacked, chunk_sz, trim, start_block, num_blocks,
            carry, fx=fx, control=control,
            attr=tail_cut if attribution else False,
        )
        cols = [summary] + outs + ([attr] if attribution else [])
        return cols, carry_out

    def _protected_fleet(self, args: dict, tables, ids, roll: bool,
                         window_s: Optional[float],
                         tl_plan: Tuple[int, float], carry,
                         start_block: int = 0,
                         num_blocks: Optional[int] = None,
                         chunk_sz: Optional[int] = None,
                         stacked: Optional[dict] = None):
        """Members ``ids`` (indices into the plan ``args``) of a
        protected fleet resumed from ``carry`` (a member-stacked
        :class:`ProtectedCarry`, rows in ``ids`` order) at block
        ``start_block``, for ``num_blocks`` blocks (default: the plan's)
        on the window grid ``tl_plan``: in the fleet's mode, ``"vmap"``
        folding chunks of ``chunk_sz`` (:meth:`_protected_chunks`, from
        ``stacked`` rows when given), ``"map"`` each member through its
        own protected block loop.  Returns ``([summary, timeline[,
        rollout][, policy]] member-stacked, member-stacked
        ProtectedCarry)``."""
        from isotope_tpu_torch.sim import ensemble as ens_mod

        ids = list(ids)
        if tables.mode == "vmap":
            return self._protected_chunks(
                args, tables, ids, roll, tl_plan, chunk_sz or len(ids),
                carry, start_block, num_blocks, stacked=stacked,
            )
        block = args["block"]
        nb = args["num_blocks"] if num_blocks is None else int(num_blocks)
        outs, rows = [], []
        for row, g in enumerate(ids):
            cpu, err = self._member_scales(tables, g)
            control = _BlockControl(self, tl_plan,
                                    self._policies is not None, roll)
            control.resume(ens_mod.member_summary(carry, row))
            clock = _Clock.resume(carry, row, start_block)
            outs.append(self._run_protected(
                args["loads"][g], nb * block, args["sources"][g], roll,
                block, None, False, window_s, cpu_scale=cpu,
                err_scale=err, tl_plan=tl_plan, control=control,
                clock=clock, plan=(float(args["offered"][g]), block, nb),
            ))
            rows.append(control.export(clock.export()))
        return ([ens_mod.tree_stack(list(c)) for c in zip(*outs)],
                ens_mod.tree_stack(rows))

    # -- config search (sim/search.py) --------------------------------------

    def run_search(self, load: LoadModel, num_requests: int, source, spec,
                   *, block_size: int = 65_536,
                   chunk: Optional[int] = None):
        """Screen a config population by successive halving
        (``sim/search.py`` :func:`~isotope_tpu_torch.sim.search.
        run_search`): each rung a plain fleet continuing its survivors'
        carries."""
        from isotope_tpu_torch.sim import search as search_mod

        return search_mod.run_search(
            self, load, num_requests, source, spec,
            block_size=block_size, chunk=chunk,
        )

    def run_search_protected(self, load: LoadModel, num_requests: int,
                             source, spec, *, roll: bool = False,
                             block_size: int = 65_536,
                             chunk: Optional[int] = None,
                             window_s: Optional[float] = None):
        """Successive halving over a PROTECTED population: each
        candidate a full policies / rollouts member whose breakers,
        budgets, HPA and rollout controller carry between rungs
        (``sim/search.py`` :func:`~isotope_tpu_torch.sim.search.
        run_search_protected`)."""
        from isotope_tpu_torch.sim import search as search_mod

        return search_mod.run_search_protected(
            self, load, num_requests, source, spec, roll=roll,
            block_size=block_size, chunk=chunk, window_s=window_s,
        )

    def default_block_size(self, budget_elems: int = 33_554_432) -> int:
        """A block size keeping each (block, H) event tensor near
        ``budget_elems`` elements (~128 MiB at f32)."""
        h = max(self.compiled.num_hops, 1)
        return int(max(256, min(524_288, budget_elems // h)))

    def census_shapes(self, n: int, policy: bool = False,
                      members: int = 1
                      ) -> List[Tuple[int, int, int, bool, bool]]:
        """``(N, B, P, fail, err)`` of each census call one block of ``n``
        requests makes, in call order: each level's join's
        ``census_calls``, deepest level first (``sim/joins.py``), with a
        fail step where a call has a finite timeout or under chaos, and
        error coins where a hop has a nonzero error rate, panic routing
        can fast-fail it or (``policy``) a breaker can shed it.
        ``members``: a folded fleet block of that many members, whose
        calls take ``members * n`` rows."""
        spec = self.draw_spec(n, OPEN_LOOP, policy=policy)
        n = n * members
        err = spec.need_err or spec.panic or spec.shed
        return [call for lvl in reversed(self._levels)
                for call in lvl.join.census_calls(
                    n, lvl.finite_timeout or self.has_chaos, err)]

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

    def _saturated_wait(self, z, sat_conns: int, sat_override, phase_idx,
                        tables=None):
        """(N, H) waits under the finite-population law
        (``native/satwait.py``: the population copula ``z' = scale * (z -
        c * e * (e . z))`` centres the normals across hops (the in-flight
        census is fixed at C), then a per-hop quantile polynomial in ``v =
        -log1p(-u')`` of the conditional uniform ``u'`` above the
        zero-wait mass ``p0``), one kernel launch on the card.
        ``phase_idx`` (N,) selects each request's (chaos x churn) row of
        phased tables (``None``: one row, centred only where its ``c`` is
        positive); ``tables`` = ``(p0, coef, e, c, scale)`` replaces the
        cached phased tables (a chaos fleet's members' rows,
        ``phase_idx`` indexing them); ``sat_override`` = ``(p0 (H,), coef
        (D, H), e (H,), c (), scale (H,))``, one row, always centred (the
        fork-join pilots)."""
        copula = True
        if sat_override is not None:
            p0_h, coef_h, e_o, c_o, scale_o = sat_override
            tables = (p0_h[None], coef_h[None], e_o[None], c_o.reshape(1),
                      scale_o[None])
        elif tables is None:
            _, p0_r, coef_r, e_r, c_r, scale_r = self._closed_tables(
                sat_conns
            )
            if sat_conns not in self._closed_center:
                self._closed_center[sat_conns] = _const(c_r, F32, self.device)
            tables = (p0_r, coef_r, e_r, self._closed_center[sat_conns],
                      scale_r)
            copula = phase_idx is not None or float(c_r[0]) > 0.0
        return saturated_wait(z.contiguous(), phase_idx, *tables,
                              copula=copula)

    def _nominal_arrivals(self, n, connections, sat_conns, nominal_gap,
                          req_offset, members: int = 0, chaos_fx=None):
        """(n,) nominal closed-loop arrival times, used only to place
        requests into chaos, churn and mTLS phases: request ``k`` of each
        connection's stream at ``(req_offset + k) * nominal_gap``, the
        remainder requests one step later.  Phased ``-qps max`` warps
        nominal time piecewise from each phase's throughput instead: the
        q-th request (globally) fires at R^-1(q), R(t) the cumulative
        requests under the per-phase rates.  ``members = M > 0``: ``n``
        requests of each of M folded members, ``nominal_gap`` (M,), the
        (M * n,) clocks member-major; a chaos fleet's members warp by
        their own phases (``chaos_fx``'s ``sat_cuts`` / ``sat_lam`` /
        ``sat_breaks``, (M, P))."""
        dev = self.device
        c = max(connections, 1)
        per = n // c
        idx = req_offset + torch.arange(per, dtype=F32, device=dev)
        rem_idx = torch.full((n - c * per,), float(req_offset + per),
                             dtype=F32, device=dev)
        P_n = len(self._phase_starts)
        if (sat_conns and members and chaos_fx is not None
                and chaos_fx.sat_lam is not None):
            cuts_f = chaos_fx.sat_cuts
            lam_f = chaos_fx.sat_lam
            breaks_f = chaos_fx.sat_breaks

            def warp_rows(i):
                q = (i * float(sat_conns))[None, :].expand(
                    members, -1
                ).contiguous()
                k_ph = torch.clamp(
                    torch.searchsorted(breaks_f, q, right=True) - 1,
                    0, P_n - 1,
                )
                return cuts_f.gather(1, k_ph) + (
                    q - breaks_f.gather(1, k_ph)
                ) / lam_f.gather(1, k_ph)

            nominal = warp_rows(idx)[:, None, :].expand(
                members, c, per
            ).reshape(members, -1)
            return torch.cat([nominal, warp_rows(rem_idx)], 1).reshape(-1)
        if sat_conns and P_n * self._num_combos > 1:
            thr = self._closed_tables(sat_conns)[0]
            lam_p = np.maximum(
                thr.reshape(P_n, self._num_combos).mean(1), 1e-9
            )
            cuts_np = self._phase_starts.astype(np.float64)
            r_breaks = np.concatenate(
                [[0.0], np.cumsum(lam_p[:-1] * np.diff(cuts_np))]
            )
            cuts_f = _const(cuts_np, F32, dev)
            lam_f = _const(lam_p, F32, dev)
            breaks_f = _const(r_breaks, F32, dev)

            def warp(i):
                q = i * float(sat_conns)
                k_ph = torch.clamp(
                    torch.searchsorted(breaks_f, q, right=True) - 1,
                    0, P_n - 1,
                )
                return cuts_f[k_ph] + (q - breaks_f[k_ph]) / lam_f[k_ph]

            nominal, rem_nominal = warp(idx), warp(rem_idx)
        elif members:
            # each member's clock at its own nominal gap
            gap = nominal_gap[:, None]
            nominal = (idx[None, :] * gap)[:, None, :].expand(
                members, c, per
            ).reshape(members, -1)
            return torch.cat(
                [nominal, rem_idx[None, :] * gap], 1
            ).reshape(-1)
        else:
            nominal = idx * nominal_gap
            rem_nominal = rem_idx * nominal_gap
        out = torch.cat([nominal.expand(c, per).reshape(-1), rem_nominal])
        # a saturated warp is the same for every member (seeds only)
        return out.repeat(members) if members else out

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
        sat_conns: int = 0,
        sat_override: Optional[Tuple[torch.Tensor, ...]] = None,
        nominal_gap: Optional[torch.Tensor] = None,
        req_offset: int = 0,
        phase_windows: Optional[torch.Tensor] = None,
        policy_fx=None,
        rollout_fx=None,
        cpu_scale: Optional[torch.Tensor] = None,
        err_scale: Optional[torch.Tensor] = None,
        members: int = 0,
        chaos_fx=None,
    ) -> Tuple[SimResults, torch.Tensor, torch.Tensor]:
        """One block of ``n`` requests; returns ``(results, t_end,
        conn_end)`` for the next block's clocks.

        ``offered_qps`` drives the queueing model, ``arrival_qps`` paces
        the open-loop arrival stream; ``t0`` / ``conn_t0`` are the
        block's starting clocks.  ``sat_conns > 0`` switches the wait
        law to the finite-population closed network of ``sim/closed.py``
        with that connection count (``-qps max``); ``sat_override`` =
        ``(p0, coef, e, c, scale)`` replaces its cached tables and
        centering (the fork-join fixed point's pilots).

        ``nominal_gap`` (default ``pace_gap``) and ``req_offset`` (the
        requests each connection issued in earlier blocks) are the
        closed loop's nominal clock, which places requests into phases;
        ``phase_windows`` is the (2, W) table of :meth:`_windows_arg`
        (default: the identity windows).

        ``policy_fx`` (a ``sim/policies.PolicyFx``) and ``rollout_fx``
        (a ``sim/rollout.RolloutFx``) are the protected runs' control
        effects on this block: breaker sheds, budgeted retries and
        autoscaled or ejected capacity; the canary weight that routes
        each hop to the canary arm's own station.  ``None`` leaves the
        block's ops unchanged.

        ``cpu_scale`` / ``err_scale`` are a fleet member's perturbations
        (``sim/ensemble.py``): the sampled service times scale by
        ``cpu_scale`` and every station's mu by its inverse in the wait
        law; the per-hop error rates scale by ``err_scale``, clipped to
        [0, 1].  ``None`` leaves the block's ops unchanged.

        ``members = M > 0`` folds M fleet members into one block of ``n
        = M * N`` request rows, member-major (``Simulator.run_ensemble``
        in ``"vmap"`` mode): ``offered_qps``, ``pace_gap``,
        ``arrival_qps``, ``nominal_gap`` and ``t0`` are then (M,)
        tensors, ``conn_t0`` is (M, C), ``visits_pc`` is (M, P*Cc, S),
        ``phase_windows`` is (M, 2, W), ``cpu_scale`` / ``err_scale``
        are (M,), and ``t_end`` / ``conn_end`` come back per member.
        Each member's queue tables are its own rows of one (M*P*Cc, S)
        table (the Erlang-B recursion runs once over all of them), and
        each level makes one census call over all M*N rows.  A folded
        block's ``policy_fx`` / ``rollout_fx`` hold (M, S) rows, one a
        member, and ``chaos_fx`` (a member-stacked
        ``compiler/compile.ChaosFx``, chaos fleets) swaps every planner
        table it arms for its member's rows: each row reads its own
        member's tables, so a member's rows are its solo block's.
        """
        dev = self.device
        zero = torch.zeros((), dtype=F32, device=dev)
        u_send, u_err = draws.u_send, draws.u_err
        H = self.compiled.num_hops
        if nominal_gap is None:
            nominal_gap = pace_gap
        hop_svc = self._hop_service
        M = members
        cfx = chaos_fx
        if M:
            N = n // M
            member_row = torch.arange(
                M, device=dev
            ).repeat_interleave(N)
        elif cfx is not None:
            raise ValueError("chaos_fx rows need a folded block (members)")

        def coin(u, per_svc):
            """(n, H) coins of ``u`` against each hop's service
            threshold: (S,), or (M, S) a member in a folded block."""
            if M:
                return (
                    u.view(M, N, -1) < per_svc[:, hop_svc][:, None, :]
                ).view(n, -1)
            return u < per_svc[hop_svc][None, :]

        def fold(table, field=None):
            """A (P*Cc, X) planner table as the folded block's (M*P*Cc,
            X): its members' ``chaos_fx`` rows where armed, else the
            table once a member."""
            rows = getattr(cfx, field) if cfx is not None and field else None
            if rows is not None:
                return rows.reshape(-1, *rows.shape[2:])
            return table.repeat(M, *([1] * (table.dim() - 1)))

        # -- policy coins (sim/policies.py), from a folded index so every
        # other stream is the unprotected twin's
        shed_coin = retry_coin = None
        if policy_fx is not None:
            pol = self._policies
            if pol.any_breaker:
                shed_coin = coin(draws.u_shed, policy_fx.shed)
            if pol.any_budget and self._has_retries:
                retry_coin = coin(draws.u_retry, policy_fx.retry_allow)
        # -- rollout version coin (sim/rollout.py): each hop routes to the
        # CANARY arm with its service's current weight
        can_coin = None
        if rollout_fx is not None:
            can_coin = coin(draws.u_canary, rollout_fx.weight)

        # ---- wait draws: copulas in normal space, then U(0,1) marginals
        # (the saturated law keeps the normals, and takes the flat
        # sibling copula: its composition was calibrated without the
        # hierarchical mix)
        z_wait = u_wait = None
        if self._copula_active or self._retry_active:
            z_wait = zero
            if self._copula_active:
                z_small = draws.z_small
                if self._copula_mix is not None and not sat_conns:
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
            if not sat_conns:
                u_wait = ndtr(z_wait)
        elif sat_conns:
            z_wait = draws.z_h
        else:
            u_wait = draws.u_wait

        # ---- arrival times (open loop exact; closed loop nominal, used
        # only to place requests into phases) -----------------------------
        P = len(self._phase_starts)
        Cc = self._num_combos
        num_phases = P * Cc
        phased_clock = num_phases > 1 or self._mtls is not None
        nominal_arrivals = None
        if kind == OPEN_LOOP:
            if M:
                # each member's Poisson clock runs along its own rows
                gaps = draws.arr.view(M, N) / arrival_qps[:, None]
                arrivals = (
                    t0[:, None] + _clock_cumsum(gaps, 1)
                ).reshape(-1)
            else:
                gaps = draws.arr / arrival_qps
                arrivals = t0 + _clock_cumsum(gaps, 0)
            nominal_arrivals = arrivals
        else:
            arrivals = None  # closed-loop arrivals derive from latencies
            if phased_clock:
                nominal_arrivals = self._nominal_arrivals(
                    n // max(M, 1), connections, sat_conns, nominal_gap,
                    req_offset, members=M, chaos_fx=cfx,
                )

        # ---- phased mTLS tax at each request's arrival time --------------
        # (n,) extra one-way latency added to every edge leg
        tax = None
        if self._mtls is not None:
            t_idx = torch.floor(
                nominal_arrivals / self._mtls.period_s
            ).to(torch.int64) % len(self._mtls.taxes_s)
            tax = self._mtls_taxes[t_idx]

        # ---- traffic-split weights at each request's arrival time --------
        # (N, E+1): one column per schedule and a sentinel 1.0 column for
        # unchurned calls; ``combo_idx`` linearizes the schedules' cycle
        # positions for the phase tables
        combo_idx = None
        churn_w = None
        if self._churn:
            cols = []
            combo_idx = torch.zeros(n, dtype=torch.int64, device=dev)
            for period, wts in zip(self._churn_periods, self._churn_weights):
                idx = torch.floor(nominal_arrivals / period).to(
                    torch.int64
                ) % len(wts)
                cols.append(wts[idx])
                combo_idx = combo_idx * len(wts) + idx
            churn_w = torch.stack(
                cols + [torch.ones_like(nominal_arrivals)], dim=1
            )

        # ---- queueing parameters, per (chaos x churn) phase -------------
        if visits_pc is None:
            visits_pc = self._visits_pc
        eff_replicas_pc = self._replicas_pc
        svc_down_pc = self._svc_down_pc
        down_ph = self._down_ph
        if M:
            # member m's queue tables are rows m*P*Cc .. (m+1)*P*Cc - 1
            lam_pc = (offered_qps[:, None, None] * visits_pc).reshape(
                M * num_phases, -1
            )
            eff_replicas_pc = fold(eff_replicas_pc, "eff_replicas_pc")
            if self.has_chaos:
                svc_down_pc = fold(svc_down_pc, "svc_down_pc")

            def per_member(x):
                # (M, S) member rows onto their members' phase rows
                return x.repeat_interleave(num_phases, 0)
        else:
            lam_pc = offered_qps * visits_pc

            def per_member(x):
                return x[None, :]

        def downed_pc():
            # the policy layer's chaos-downed replicas (under a rollout
            # the kill takes CANARY replicas first)
            if rollout_fx is not None and self.has_chaos:
                return (fold(self._downed_base_pc, "downed_base_pc") if M
                        else self._downed_base_pc)
            return fold(self._downed_pc, "downed_pc") if M else self._downed_pc

        pol_capacity = False
        if policy_fx is not None:
            pol = self._policies
            if pol.any_breaker:
                # shed requests never enter the queue: the wait law sees
                # the ADMITTED load
                lam_pc = lam_pc * per_member(1.0 - policy_fx.shed)
            if pol.any_hpa or pol.any_ejection:
                # autoscaled/ejected capacity composes with the chaos
                # phases' down deltas; every station keeps >= 1 server
                pol_capacity = True
                eff_replicas_pc = torch.clamp(
                    per_member(policy_fx.replicas) - downed_pc(), min=1.0
                ).to(torch.int32)
        lam_can = None
        if rollout_fx is not None:
            # two-version split: the canary arm is its OWN M/M/k station
            # fed the split-off admitted load; the baseline keeps the rest
            w_row = per_member(rollout_fx.weight)
            lam_can = lam_pc * w_row
            lam_pc = lam_pc * (1.0 - w_row)
            if self.has_chaos:
                if not pol_capacity:
                    eff_replicas_pc = (
                        fold(self._eff_base_roll_pc, "eff_base_roll_pc")
                        if M else self._eff_base_roll_pc
                    )
                svc_down_pc = (
                    fold(self._svc_down_base_roll_pc,
                         "svc_down_base_roll_pc")
                    if M else self._svc_down_base_roll_pc
                )
                down_ph = self._down_base_roll_ph
        if M and self.has_chaos:
            # each member's outage flags per hop and phase row
            down_ph = svc_down_pc[:, hop_svc]
        # panic routing (sim/lb.py): below a pool's panic threshold the
        # dead-backend share fast-fails through the panic coin below and
        # the wait law's load scales by the healthy fraction
        panic_ph = None
        if self._lb_any_panic and not sat_conns and (
            self.has_chaos or policy_fx is not None
        ):
            if policy_fx is not None:
                # the policy state's actuated pool and its healthy part
                total = per_member(policy_fx.total)
                alive = per_member(policy_fx.alive)
                if self.has_chaos:
                    alive = alive - downed_pc()
                alive = torch.clamp(alive, min=0.0)
            else:
                total, alive = self._lb_total_row, self._lb_alive_pc
                if M:
                    alive = fold(alive, "lb_alive_pc")
            lam_pc, panic_pc = lb_mod.panic_split(
                self._lb_dev, lam_pc, alive, total
            )
            panic_ph = panic_pc[:, hop_svc]
        # per-station wait law: the lb laws where declared (fifo rows
        # pass through mmk_params untouched); the saturated -qps max
        # law keeps its own tables (lb runs refuse it at the entries).
        # A canary arm hashes its own ring / weight cycle over its own
        # replicas.
        qp_can = None
        # a member's cpu perturbation: demand scales by s, so every
        # station's service rate scales by 1/s
        mu, can_mu = self._mu, getattr(self, "_canary_mu", None)
        if cpu_scale is not None:
            mu = self._scalar(self._mu) / cpu_scale
            if M:
                mu = mu.repeat_interleave(num_phases)[:, None]
            if rollout_fx is not None:
                can_mu = (
                    per_member(self._canary_mu[None, :]
                               / cpu_scale[:, None]) if M
                    else self._canary_mu / cpu_scale
                )
        can_reps_pc = None
        if rollout_fx is not None:
            can_reps_pc = (
                fold(self._can_reps_pc, "can_reps_pc") if M
                else self._can_reps_pc
            )
        if self._lb_dev is not None and not sat_conns:
            qp = lb_mod.wait_params(
                self._lb, self._lb_dev, lam_pc, mu,
                eff_replicas_pc, self._k_max,
            )
            if rollout_fx is not None:
                qp_can = lb_mod.wait_params(
                    self._lb, self._lb_dev, lam_can, can_mu,
                    can_reps_pc, self._k_max,
                )
        else:
            qp = queueing.mmk_params(
                lam_pc, mu, eff_replicas_pc, self._k_max
            )
            if rollout_fx is not None:
                qp_can = queueing.mmk_params(
                    lam_can, can_mu, can_reps_pc, self._k_max,
                )
        down = None
        phase_idx = None
        if num_phases > 1:
            # each request's row, gathered (exact, where the JAX engine
            # expands the tables with a one-hot matmul)
            if P > 1 and M:
                # each member's own window table over its own rows
                win_idx = torch.searchsorted(
                    phase_windows[:, 0].contiguous(),
                    nominal_arrivals.view(M, N).contiguous(), right=True,
                ) - 1
                chaos_idx = torch.gather(
                    phase_windows[:, 1].to(torch.int64), 1,
                    torch.clamp(win_idx, 0, self._num_windows - 1),
                ).reshape(-1)
            elif P > 1:
                # phase WINDOWS, not raw cuts: drain windows keep an
                # overloaded row live past its cut (_windows_arg)
                if phase_windows is None:
                    phase_windows = self._ident_windows
                win_idx = torch.searchsorted(
                    phase_windows[0].contiguous(), nominal_arrivals,
                    right=True,
                ) - 1
                chaos_idx = phase_windows[1].to(torch.int64)[
                    torch.clamp(win_idx, 0, self._num_windows - 1)
                ]
            else:
                chaos_idx = torch.zeros(n, dtype=torch.int64, device=dev)
            phase_idx = (
                chaos_idx * Cc + combo_idx
                if combo_idx is not None
                else chaos_idx
            )
        if M:
            # a row's phase-table row: its member's block of phases
            q_idx = member_row * num_phases
            if phase_idx is not None:
                q_idx = q_idx + phase_idx
        if self.has_chaos:
            if M:
                down = down_ph[q_idx]
            elif phase_idx is not None:
                down = down_ph[phase_idx]
            else:
                down = down_ph[0].expand(n, H)
        if can_coin is not None and self.has_chaos:
            # a canary hop's callee is down when its canary arm is
            if M:
                down_can = fold(self._svc_down_can_pc,
                                "svc_down_can_pc")[:, hop_svc][q_idx]
            elif phase_idx is None:
                down_can = self._down_can_ph[0][None, :]
            else:
                down_can = self._down_can_ph[phase_idx]
            down = torch.where(can_coin, down_can, down)
        if sat_conns:
            with telemetry.span("engine.sat_wait"):
                if cfx is not None and cfx.sat_p0 is not None:
                    # each member's own finite-population tables
                    wait = self._saturated_wait(
                        z_wait, sat_conns, None, q_idx,
                        tables=(cfx.sat_p0.flatten(0, 1),
                                cfx.sat_coef.flatten(0, 1),
                                cfx.sat_e.flatten(0, 1),
                                cfx.sat_c.reshape(-1),
                                cfx.sat_scale.flatten(0, 1)),
                    )
                else:
                    wait = self._saturated_wait(
                        z_wait, sat_conns, sat_override,
                        phase_idx if sat_override is None else None,
                    )
        else:
            def per_hop(table):
                if M:
                    return table[:, hop_svc][q_idx]
                if phase_idx is None:
                    return table[0][hop_svc][None, :]
                return table[:, hop_svc][phase_idx]

            p_wait_nh = per_hop(qp.p_wait)
            wait_rate_nh = per_hop(qp.wait_rate)
            if can_coin is not None:
                # the canary station's tables, merged per hop by the
                # version coin
                p_wait_nh = torch.where(
                    can_coin, per_hop(qp_can.p_wait), p_wait_nh
                )
                wait_rate_nh = torch.where(
                    can_coin, per_hop(qp_can.wait_rate), wait_rate_nh
                )
            wait = queueing.sample_wait_conditional(
                p_wait_nh, wait_rate_nh, u_wait
            )  # (N, H)
        if panic_ph is not None:
            # the dead-backend share fast-fails at admission like a
            # breaker shed; a canary-routed hop is exempt (its arm's kill
            # physics transport-fail it)
            panic = draws.u_panic < (
                panic_ph[q_idx] if M
                else panic_ph[0][None, :] if phase_idx is None
                else panic_ph[phase_idx]
            )
            if can_coin is not None:
                panic = panic & ~can_coin
            shed_coin = panic if shed_coin is None else shed_coin | panic
        if shed_coin is not None:
            # a shed request fast-fails at admission: the error path
            # below, NOT the queue
            wait = torch.where(shed_coin, zero, wait)
        utilization, unstable = qp.utilization, qp.unstable
        if self.has_chaos:
            # a fully-down service does no work: zero utilization for
            # those phases instead of the clamped-to-1-replica saturation
            utilization = torch.where(svc_down_pc, 0.0, utilization)
            unstable = unstable & ~svc_down_pc
        svc_time = self._sample_service_time(draws.svc, n)
        if cpu_scale is not None:
            # a multiplicative rescale keeps the service-time SHAPE and
            # moves the member's mean CPU demand
            if M:
                svc_time = (
                    svc_time.view(M, N, -1) * cpu_scale[:, None, None]
                ).view(n, -1)
            else:
                svc_time = svc_time * cpu_scale
        if can_coin is not None and self._canary_cpu_varies:
            # canary cpu_time override: a multiplicative rescale keeps
            # the service-time SHAPE and moves its mean
            svc_time = torch.where(
                can_coin, svc_time * self._canary_cpu_ratio_h[None, :],
                svc_time,
            )
        # a member's err_scale multiplies the per-hop error rates; it
        # preserves zeros, so the static coin elimination stays sound
        err_rate_h = self._hop_err_rate
        can_err_h = getattr(self, "_canary_err_h", None)
        if err_scale is not None and M:
            # (M, H) rates, each member's own
            err_rate_h = torch.clamp(
                err_rate_h[None, :] * err_scale[:, None], 0.0, 1.0
            )
            if can_coin is not None:
                can_err_h = torch.clamp(
                    can_err_h[None, :] * err_scale[:, None], 0.0, 1.0
                )
        elif err_scale is not None:
            err_rate_h = torch.clamp(err_rate_h * err_scale, 0.0, 1.0)
            if can_coin is not None:
                can_err_h = torch.clamp(can_err_h * err_scale, 0.0, 1.0)
        if u_err is None:
            err_coin = None
        elif err_scale is not None and M:
            rate = err_rate_h[:, None, :]
            if can_coin is not None:
                # per-arm error rates: a canary hop draws against its own
                rate = torch.where(can_coin.view(M, N, -1),
                                   can_err_h[:, None, :], rate)
            err_coin = (u_err.view(M, N, -1) < rate).view(n, -1)
        elif can_coin is not None:
            # per-arm error rates: a canary hop draws against its own
            err_coin = u_err < torch.where(
                can_coin, can_err_h[None, :], err_rate_h[None, :],
            )
        else:
            err_coin = u_err < err_rate_h
        if shed_coin is not None:
            # a shed or panicking hop rides the errorRate path exactly:
            # fast 500, script skipped, nothing sent downstream, and the
            # caller does not fail
            err_coin = (
                shed_coin if err_coin is None else err_coin | shed_coin
            )

        # ---- upward pass: outcomes + server-side durations ---------------
        # Deepest level first, so every call site sees its callees'
        # (hypothetical) latency and status.  ``None`` sentinels carry
        # static knowledge: err_lvls[d] is None when no hop can 500,
        # fail_lvls[d] when no call can transport-fail (no finite
        # timeout and no chaos), used_lvls[d] when every call is
        # deterministically sent.
        L = len(self._levels)
        lat_lvls: List[Optional[torch.Tensor]] = [None] * L
        err_lvls: List[Optional[torch.Tensor]] = [None] * L
        fail_lvls: List[Optional[torch.Tensor]] = [None] * L
        used_lvls: List[Optional[torch.Tensor]] = [None] * L
        off_lvls: List[Optional[torch.Tensor]] = [None] * L
        # engine-level chaos: ISOTOPE_FAULT_INJECT nan:segment:<i> poisons
        # segment i's output (the port sweeps every level on its own:
        # segment i is level i) so the numeric sentinels are testable
        nan_seg = faults.nan_segment()
        with telemetry.span("engine.sweep"):
            telemetry.fence_reset()
            for d in reversed(range(L)):
                lvl = self._levels[d]
                sl = slice(lvl.offset, lvl.offset + lvl.size)
                err_lvl = (
                    err_coin[:, sl].contiguous()
                    if err_coin is not None else None
                )
                P = lvl.pmax
                dur_call = final_transport = att_off = None
                if lvl.num_children > 0:
                    nxt = self._levels[d + 1]
                    csl = slice(nxt.offset, nxt.offset + nxt.size)
                    C = lvl.num_children
                    timeout = lvl.call_timeout if lvl.finite_timeout else None
                    down_child = down[:, csl] if down is not None else None
                    if lvl.ident_attempts:
                        # single attempt, call k <-> child k: elementwise
                        tt = lvl.child_rtt + lat_lvls[d + 1]  # (N, C)
                        if tax is not None:
                            tt = tt + 2.0 * tax[:, None]
                        transport_a, dur_a = _call_outcome(
                            tt, timeout, down_child
                        )
                        if self._need_send:
                            prob = lvl.child_send_prob
                            if churn_w is not None:
                                prob = prob * churn_w[:, lvl.child_churn_entry]
                            coin = u_send[:, csl] < prob
                            used_lvls[d] = coin
                            dur_call = torch.where(coin, dur_a, zero)
                            # an unsent call cannot fail anything
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
                        down_pad = (
                            F.pad(down_child, (0, 1))
                            if down_child is not None
                            else None
                        )
                        rtt_child = F.pad(lvl.child_rtt, (0, 1))
                        a0 = lvl.att_child[0]
                        if self._need_send:
                            prob = lvl.child_send_prob[a0]
                            if churn_w is not None:
                                # the current schedule weight scales the send
                                # probability
                                prob = prob * churn_w[
                                    :, lvl.child_churn_entry[a0]
                                ]
                            coin = u_send[:, csl][:, a0] < prob
                        else:
                            coin = torch.ones(
                                (n, lvl.num_calls), dtype=torch.bool,
                                device=dev,
                            )
                        dur_call = torch.zeros((n, lvl.num_calls), dtype=F32,
                                               device=dev)
                        final_transport = (
                            torch.zeros((n, lvl.num_calls), dtype=torch.bool,
                                        device=dev)
                            if lvl.finite_timeout or down_pad is not None
                            else None
                        )
                        used = torch.zeros((n, C + 1), dtype=torch.bool,
                                           device=dev)
                        att_off = torch.zeros((n, C + 1), dtype=F32,
                                              device=dev)
                        # retry-budget gate (sim/policies.py): attempt >= 1
                        # runs only when its budget coin admits it; a
                        # suppressed retry surfaces the previous attempt's
                        # failure to the caller
                        retry_gate = None
                        if retry_coin is not None and len(lvl.att_child) > 1:
                            retry_gate = F.pad(retry_coin[:, csl], (0, 1))
                        used_a = coin
                        for a, (idx, valid) in enumerate(
                            zip(lvl.att_child, lvl.att_valid)
                        ):
                            use = used_a & valid
                            if retry_gate is not None and a > 0:
                                use = use & retry_gate[:, idx]
                            t = rtt_child[idx] + lat_child[:, idx]
                            if tax is not None:
                                t = t + 2.0 * tax[:, None]
                            transport_a, dur_a = _call_outcome(
                                t, timeout,
                                down_pad[:, idx] if down_pad is not None
                                else None,
                            )
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

                # -- the level's join (sim/joins.py): busy (500-masked),
                # fail step and the children's offsets within the script
                busy, fail_step, off = lvl.join.sweep(
                    n, dur_call, final_transport, err_lvl
                )
                if att_off is not None:
                    off = off + used_lvls[d] * att_off[:, :C]
                off_lvls[d] = off
                fail_lvls[d] = fail_step
                lat_lvls[d] = wait[:, sl] + svc_time[:, sl] + busy
                if nan_seg == d:
                    lat_lvls[d][:, 0] = float("nan")
                if telemetry.detail_enabled():
                    telemetry.segment_fence(f"up.lvl[{d}]", lat_lvls[d])
                # this hop's own response status: 500 iff errorRate coin or a
                # transport-failed step
                if err_lvl is not None and fail_step is not None:
                    err_lvls[d] = err_lvl | (fail_step < P)
                elif err_lvl is not None:
                    err_lvls[d] = err_lvl
                elif fail_step is not None:
                    err_lvls[d] = fail_step < P

        # ---- downward pass: which hops actually execute ------------------
        # a down ENTRY service refuses the client's connection itself
        # rollout runs also track REFUSED hops (would-send, target down):
        # the canary gates charge a killed arm's transport failures to it
        track_refused = rollout_fx is not None
        root_down = None
        if down is not None:
            root_down = down[:, 0]
            sent_cur = ~root_down[:, None]
        else:
            sent_cur = torch.ones((n, 1), dtype=torch.bool, device=dev)
        if track_refused:
            refused_cur = (
                root_down[:, None] if root_down is not None
                else torch.zeros((n, 1), dtype=torch.bool, device=dev)
            )
        sent_chunks: List[torch.Tensor] = []
        refused_chunks: List[torch.Tensor] = []
        for d, lvl in enumerate(self._levels):
            sent_chunks.append(sent_cur)
            if track_refused:
                refused_chunks.append(refused_cur)
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
            if down is not None:
                nxt = self._levels[d + 1]
                down_nxt = down[:, nxt.offset:nxt.offset + nxt.size]
                if track_refused:
                    refused_cur = sent & down_nxt
                sent = sent & ~down_nxt
            elif track_refused:
                refused_cur = torch.zeros_like(sent)
            sent_cur = sent

        # ---- closed-loop arrivals (need latencies) -----------------------
        root_wire = self._root_net
        if tax is not None:
            # the client -> entry edge pays the tax on both legs too
            root_wire = root_wire + 2.0 * tax
        root_lat = root_wire + lat_lvls[0][:, 0]
        if root_down is not None:
            # a refused connection to the entry costs one wire round trip
            root_lat = torch.where(
                root_down, 2 * self._entry_one_way, root_lat
            )
        if kind == CLOSED_LOOP:
            arrivals, conn_end = self._closed_clock(
                root_lat.view(M, N) if M else root_lat, connections,
                pace_gap, conn_t0,
            )
        else:
            conn_end = conn_t0

        # ---- downward pass 2: absolute start times -----------------------
        entry_wire = self._entry_one_way
        if tax is not None:
            entry_wire = entry_wire + tax
        start_cur = (arrivals + entry_wire)[:, None]
        start_chunks: List[torch.Tensor] = []
        telemetry.fence_reset()
        for d, lvl in enumerate(self._levels):
            start_chunks.append(start_cur)
            if telemetry.detail_enabled():
                telemetry.segment_fence(f"start.lvl[{d}]", start_cur)
            if d == L - 1:
                break
            sl = slice(lvl.offset, lvl.offset + lvl.size)
            base = (start_cur + wait[:, sl])[:, lvl.child_parent_local]
            out_wire = lvl.child_net_out
            if tax is not None:
                out_wire = out_wire + tax[:, None]
            start_cur = base + off_lvls[d] + out_wire

        # ---- assembly into BFS hop order ---------------------------------
        hop_sent = torch.cat(sent_chunks, dim=1)
        hop_lat = torch.cat(lat_lvls, dim=1)
        hop_start = torch.cat(start_chunks, dim=1)
        err_hop = torch.cat(
            [
                e if e is not None
                else torch.zeros((n, lvl.size), dtype=torch.bool, device=dev)
                for e, lvl in zip(err_lvls, self._levels)
            ],
            dim=1,
        )
        client_error = err_hop[:, 0]
        if root_down is not None:
            client_error = client_error | root_down
        if self._num_kill_events:
            root_lat, client_error = self._kill_resets(
                draws.u_kill, hop_sent, hop_start, hop_lat, arrivals,
                root_lat, client_error,
                rows=(cfx.kill_t, cfx.kill_frac)
                if cfx is not None and cfx.kill_t is not None else None,
            )
        res = SimResults(
            client_start=arrivals,
            client_latency=root_lat,
            client_error=client_error,
            hop_sent=hop_sent,
            hop_error=err_hop & hop_sent,
            hop_latency=hop_lat,
            hop_start=hop_start,
            utilization=(
                utilization.view(M, num_phases, -1).amax(1) if M
                else utilization.amax(0)
            ),
            unstable=(
                unstable.view(M, num_phases, -1).any(1) if M
                else unstable.any(0)
            ),
            offered_qps=offered_qps,
            hop_wait=(
                wait
                if self.params.attribution or self.params.timeline
                else None
            ),
            hop_canary=can_coin,
            hop_refused=(
                torch.cat(refused_chunks, dim=1) if track_refused else None
            ),
        )
        if M:
            t_end = (
                conn_end.amax(-1) if kind == CLOSED_LOOP
                else arrivals.view(M, N)[:, -1]
            )
        else:
            t_end = (
                conn_end.max() if kind == CLOSED_LOOP else arrivals[-1]
            )
        return res, t_end, conn_end

    @staticmethod
    def _closed_clock(root_lat, connections, pace_gap, conn_t0):
        """The closed loop's arrivals, flat, and connection clocks of a
        solo block (``root_lat`` (N,), ``pace_gap`` 0-d, ``conn_t0``
        (C,)) or of M folded members ((M, N), (M,), (M, C)): each latency
        takes the longer of itself and its gap on its connection from
        ``conn_t0``; remainder requests (N % C) start as their connection
        frees up.  The member axis's broadcasts and flatten apply only
        where there is one: a solo block dispatches no extra view op."""
        lead = root_lat.shape[:-1]
        c = max(connections, 1)
        per = root_lat.shape[-1] // c
        rem = root_lat.shape[-1] - c * per
        lat_conn = root_lat.narrow(-1, 0, c * per).reshape(*lead, c, per)
        spent = torch.maximum(
            lat_conn, pace_gap[:, None, None] if lead else pace_gap
        )
        starts = conn_t0[..., None] + _clock_cumsum(spent, -1) - spent
        conn_end = conn_t0 + spent.sum(-1)
        arrivals = starts.reshape(*lead, -1)
        if rem:
            arrivals = torch.cat([arrivals, conn_end[..., :rem]], -1)
            spent_rem = torch.maximum(
                root_lat[..., c * per:],
                pace_gap[:, None] if lead else pace_gap,
            )
            conn_end = torch.cat(
                [conn_end[..., :rem] + spent_rem, conn_end[..., rem:]], -1
            )
        return (arrivals.reshape(-1) if lead else arrivals), conn_end

    def _kill_resets(self, u_kill, hop_sent, hop_start, hop_lat, arrivals,
                     root_lat, client_error, rows=None):
        """Ungraceful kills: a request whose hop on the killed service
        is in flight at the kill instant dies (transport) with the
        event's probability; the client sees the reset at about the
        kill time, after the shortest payload-free return path among
        its killed hops.  The earliest event wins.  ``rows`` =
        ``(kill_t, kill_frac)``, (M, E) and (M, E, H): a folded chaos
        fleet's members' own events over their own rows."""
        died_any = torch.zeros_like(client_error)
        if rows is not None:
            M = rows[0].shape[0]
            N = arrivals.shape[0] // M
        for i in range(self._num_kill_events):
            if rows is None:
                t_k = self._kill_t[i]
                t_h = t_k
                frac = self._kill_frac[i][None, :]
            else:
                # each member's kill instant over its own rows
                t_k = rows[0][:, i].repeat_interleave(N)
                t_h = t_k[:, None]
                frac = rows[1][:, i].repeat_interleave(N, 0)
            strad = (
                hop_sent & (hop_start < t_h) & (hop_start + hop_lat > t_h)
            )
            died_h = strad & (u_kill[i] < frac)
            died = died_h.any(1) & ~died_any
            ret = torch.where(
                died_h, self._back_cum[None, :], float("inf")
            ).amin(1)
            reset_lat = torch.clamp(t_k - arrivals, min=0.0) + torch.where(
                torch.isfinite(ret), ret, 0.0
            )
            root_lat = torch.where(died, reset_lat, root_lat)
            client_error = client_error | died
            died_any = died_any | died
        return root_lat, client_error
