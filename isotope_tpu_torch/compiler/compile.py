"""Lower a validated ServiceGraph into a CompiledGraph.

The reference executes the topology by recursion at request time
(isotope/service/pkg/srv/handler.go:66-76 calling executable.go:43-179,
which issues real HTTP requests downstream).  Over a fixed topology that
recursion traces a statically known call tree, so we unroll it once at
compile time: every service invocation a root request can cause becomes a
*hop* with a parent pointer, and the engine evaluates all requests × all
hops as one tensor program.

Unrolling terminates iff the call graph reachable from the entrypoint is
acyclic — the reference has no cycle guard at all (a cyclic topology would
recurse until sockets run out), so rejecting cycles at compile time is
strictly safer.

This is a copy of ``isotope_tpu.compiler.compile``'s graph lowering
(``compile_graph`` and its helpers), of ``compile_lb``,
``compile_policies`` and ``compile_rollouts``, and of the fleet tables
(``compile_ensemble``, ``rung_bucket``, ``ensemble_take``, ``ChaosFx``,
``chaos_fx_layout``, ``compile_chaos_members``), without the telemetry
calls.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from isotope_tpu_torch.compiler.program import CompiledGraph, HopLevel, ServiceTable
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.models.script import (
    ConcurrentCommand,
    RequestCommand,
    SleepCommand,
)


class NoEntrypointError(ValueError):
    def __init__(self):
        super().__init__(
            "service graph has no entrypoint (set isEntrypoint: true)"
        )


class CycleError(ValueError):
    def __init__(self, path: Sequence[str]):
        self.path = list(path)
        super().__init__(
            "call graph contains a cycle reachable from the entrypoint: "
            + " -> ".join(self.path)
        )


class HopBudgetExceededError(ValueError):
    def __init__(self, budget: int):
        self.budget = budget
        super().__init__(
            f"unrolled call tree exceeds {budget} hops; raise max_hops or "
            "simplify the topology"
        )


@dataclasses.dataclass(frozen=True)
class _Call:
    target: int
    size: float
    send_prob: float
    timeout: float = float("inf")
    attempts: int = 1  # retries + 1


@dataclasses.dataclass(frozen=True)
class _Step:
    base: float               # sleep seconds (max over a concurrent group's
    calls: Tuple[_Call, ...]  # sleeps — they run in parallel with its calls)


def _lower_script(script, name_to_idx) -> Tuple[_Step, ...]:
    """One _Step per script command (handler.go:66-76 runs them in order)."""
    steps: List[_Step] = []
    for cmd in script:
        if isinstance(cmd, SleepCommand):
            steps.append(_Step(base=cmd.seconds, calls=()))
        elif isinstance(cmd, RequestCommand):
            steps.append(_Step(base=0.0, calls=(_lower_call(cmd, name_to_idx),)))
        elif isinstance(cmd, ConcurrentCommand):
            sleeps = [c.seconds for c in cmd if isinstance(c, SleepCommand)]
            calls = tuple(
                _lower_call(c, name_to_idx)
                for c in cmd
                if isinstance(c, RequestCommand)
            )
            steps.append(_Step(base=max(sleeps, default=0.0), calls=calls))
        else:  # pragma: no cover - grammar is closed
            raise TypeError(f"unknown command: {cmd!r}")
    return tuple(steps)


def _lower_call(cmd: RequestCommand, name_to_idx) -> _Call:
    return _Call(
        target=name_to_idx[cmd.service_name],
        size=float(int(cmd.size)),
        send_prob=cmd.send_probability,
        timeout=float("inf") if cmd.timeout is None else cmd.timeout,
        attempts=cmd.retries + 1,
    )


def _check_acyclic(entry: int, programs, names) -> None:
    """DFS over the static call graph; raise CycleError on a back edge."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = [WHITE] * len(programs)
    stack_names: List[str] = []

    def visit(s: int) -> None:
        color[s] = GRAY
        stack_names.append(names[s])
        for step in programs[s]:
            for call in step.calls:
                t = call.target
                if color[t] == GRAY:
                    raise CycleError(stack_names + [names[t]])
                if color[t] == WHITE:
                    visit(t)
        stack_names.pop()
        color[s] = BLACK

    visit(entry)


def compile_graph(
    graph: ServiceGraph,
    entry: Optional[str] = None,
    max_hops: int = 2_000_000,
) -> CompiledGraph:
    """Compile ``graph`` for simulation, unrolling from ``entry``.

    ``entry`` defaults to the graph's first entrypoint service — the service
    the reference's Fortio client is pointed at
    (isotope/convert/pkg/kubernetes/fortio_client.go:28-78).
    """
    return _compile_graph(graph, entry, max_hops)


def _compile_graph(
    graph: ServiceGraph,
    entry: Optional[str],
    max_hops: int,
) -> CompiledGraph:
    if not graph.services:
        raise NoEntrypointError()
    names = tuple(s.name for s in graph.services)
    name_to_idx = {n: i for i, n in enumerate(names)}

    if entry is None:
        entrypoints = graph.entrypoints()
        if not entrypoints:
            raise NoEntrypointError()
        entry_idx = name_to_idx[entrypoints[0].name]
    else:
        if entry not in name_to_idx:
            raise ValueError(f"unknown entry service: {entry!r}")
        entry_idx = name_to_idx[entry]

    cluster_names = tuple(
        sorted({getattr(s, "cluster", "") for s in graph.services})
    )
    cluster_idx = {c: i for i, c in enumerate(cluster_names)}
    table = ServiceTable(
        names=names,
        replicas=np.asarray(
            [max(1, s.num_replicas) for s in graph.services], np.int32
        ),
        error_rate=np.asarray(
            [float(s.error_rate) for s in graph.services], np.float32
        ),
        response_size=np.asarray(
            [float(int(s.response_size)) for s in graph.services], np.float32
        ),
        is_entrypoint=np.asarray(
            [s.is_entrypoint for s in graph.services], bool
        ),
        cluster=np.asarray(
            [cluster_idx[getattr(s, "cluster", "")] for s in graph.services],
            np.int32,
        ),
        cluster_names=cluster_names,
    )

    programs = [_lower_script(s.script, name_to_idx) for s in graph.services]
    _check_acyclic(entry_idx, programs, names)
    max_steps = max([len(p) for p in programs] + [1])

    # -- BFS unroll --------------------------------------------------------
    hop_service: List[int] = [entry_idx]
    hop_parent: List[int] = [-1]
    hop_depth: List[int] = [0]
    hop_step: List[int] = [-1]
    hop_attempt: List[int] = [0]
    hop_send_prob: List[float] = [1.0]
    hop_request_size: List[float] = [0.0]
    hop_reach: List[float] = [1.0]

    levels: List[HopLevel] = []
    frontier = [0]  # global hop ids at the current depth
    while frontier:
        level_services = [hop_service[h] for h in frontier]
        step_is_real = np.zeros((len(frontier), max_steps), bool)
        step_base = np.zeros((len(frontier), max_steps), np.float32)
        child_ids: List[int] = []
        child_seg: List[int] = []
        call_seg: List[int] = []
        call_step: List[int] = []
        call_timeout: List[float] = []
        call_attempt_children: List[List[int]] = []  # local child indices
        next_frontier: List[int] = []
        for local, h in enumerate(frontier):
            prog = programs[hop_service[h]]
            parent_err = float(table.error_rate[hop_service[h]])
            for step_idx, step in enumerate(prog):
                step_is_real[local, step_idx] = True
                step_base[local, step_idx] = step.base
                for call in step.calls:
                    # Each retry attempt is its own hop (with its own
                    # subtree); its static reach discounts by the target's
                    # error rate — the statically-known part of "previous
                    # attempt failed" — for offered-load estimation.
                    target_err = float(table.error_rate[call.target])
                    call_seg.append(local * max_steps + step_idx)
                    call_step.append(step_idx)
                    call_timeout.append(call.timeout)
                    att_locals: List[int] = []
                    for a in range(call.attempts):
                        child = len(hop_service)
                        if child >= max_hops:
                            raise HopBudgetExceededError(max_hops)
                        hop_service.append(call.target)
                        hop_parent.append(h)
                        hop_depth.append(hop_depth[h] + 1)
                        hop_step.append(step_idx)
                        hop_attempt.append(a)
                        hop_send_prob.append(call.send_prob)
                        hop_request_size.append(call.size)
                        hop_reach.append(
                            hop_reach[h]
                            * call.send_prob
                            * (1.0 - parent_err)
                            * target_err**a
                        )
                        att_locals.append(len(child_ids))
                        child_ids.append(child)
                        child_seg.append(local * max_steps + step_idx)
                        next_frontier.append(child)
                    call_attempt_children.append(att_locals)
        max_a = max((len(c) for c in call_attempt_children), default=1)
        n_calls = len(call_seg)
        att_child = np.full((max_a, n_calls), len(child_ids), np.int32)
        att_valid = np.zeros((max_a, n_calls), bool)
        for k, att_locals in enumerate(call_attempt_children):
            for a, local_idx in enumerate(att_locals):
                att_child[a, k] = local_idx
                att_valid[a, k] = True
        levels.append(
            HopLevel(
                hop_ids=np.asarray(frontier, np.int32),
                service=np.asarray(level_services, np.int32),
                step_is_real=step_is_real,
                step_base=step_base,
                child_ids=np.asarray(child_ids, np.int32),
                child_seg=np.asarray(child_seg, np.int32),
                call_seg=np.asarray(call_seg, np.int32),
                call_step=np.asarray(call_step, np.int32),
                call_timeout=np.asarray(call_timeout, np.float32),
                att_child=att_child,
                att_valid=att_valid,
            )
        )
        frontier = next_frontier

    return CompiledGraph(
        services=table,
        entry_service=entry_idx,
        hop_service=np.asarray(hop_service, np.int32),
        hop_parent=np.asarray(hop_parent, np.int32),
        hop_depth=np.asarray(hop_depth, np.int32),
        hop_step=np.asarray(hop_step, np.int32),
        hop_attempt=np.asarray(hop_attempt, np.int32),
        hop_send_prob=np.asarray(hop_send_prob, np.float32),
        hop_request_size=np.asarray(hop_request_size, np.float32),
        hop_reach=np.asarray(hop_reach, np.float64),
        levels=tuple(levels),
        max_steps=max_steps,
    )


def compile_policies(graph: ServiceGraph, compiled: CompiledGraph):
    """Lower a topology's ``policies:`` block to dense per-service
    tables in COMPILED service order (``sim/policies.PolicyTables``),
    which the engine's protected block loop consumes.

    Returns ``None`` when the graph declares no policies (the engine's
    unchanged default path).  Decode errors carry key paths
    (``policies.worker.breaker.max_pending: ...``).
    """
    if not graph.policies:
        return None
    from isotope_tpu_torch.sim import policies as policies_mod

    pols = policies_mod.PolicySet.decode(
        graph.policies, compiled.services.names
    )
    if pols.empty:
        return None
    return policies_mod.build_tables(pols, compiled.services)


def compile_lb(graph: ServiceGraph, compiled: CompiledGraph):
    """Lower a topology's per-service ``lb:`` entries (inside the
    ``policies:`` block) to dense per-service tables in COMPILED
    service order (``sim/lb.LbTables``), which the engine's
    per-station wait-law selection consumes.

    Returns ``None`` when no service declares an ``lb:`` law (the
    engine's unchanged default path).  Decode errors carry key paths
    (``policies.worker.lb.choices_d: ...``).
    """
    if not graph.policies:
        return None
    from isotope_tpu_torch.sim import lb as lb_mod

    lbs = lb_mod.LbSet.decode(graph.policies, compiled.services.names)
    if lbs.empty:
        return None
    return lb_mod.build_tables(lbs, compiled.services)


def compile_rollouts(graph: ServiceGraph, compiled: CompiledGraph):
    """Lower a topology's ``rollouts:`` block to dense per-service
    tables in COMPILED service order (``sim/rollout.RolloutTables``),
    which the engine's protected block loop consumes.

    Returns ``None`` when the graph declares no active rollout (the
    engine's unchanged default path).  Decode errors carry key paths
    (``rollouts.worker.steps[2]: ...``).
    """
    if not getattr(graph, "rollouts", None):
        return None
    from isotope_tpu_torch.sim import rollout as rollout_mod

    rset = rollout_mod.RolloutSet.decode(
        graph.rollouts, compiled.services.names
    )
    if rset.empty:
        return None
    return rollout_mod.build_tables(rset, compiled.services)


# -- Monte Carlo fleets (sim/ensemble.py) -----------------------------------


class EnsembleTables(NamedTuple):
    """Per-member tables of one Monte Carlo fleet (``sim/ensemble.py``).

    ``qps_scale`` stays on the host (it sets each member's offered rate,
    visit tables and trim window before the run); ``cpu_scale`` and
    ``err_scale`` are the members' physics arguments, float32 tensors
    (all ones when the spec leaves that axis off; ``jittered`` says
    whether the engine applies them).  ``mode`` is the resolved member
    axis mode (``"vmap"`` or ``"map"``)."""

    members: int
    seeds: Tuple[int, ...]
    qps_scale: np.ndarray        # (N,) float64, all ones when off
    cpu_scale: "torch.Tensor"    # (N,) float32
    err_scale: "torch.Tensor"    # (N,) float32
    jittered: bool
    mode: str


def compile_ensemble(spec, device=None) -> EnsembleTables:
    """Lower an :class:`~isotope_tpu_torch.sim.ensemble.EnsembleSpec` to
    the per-member tables the engine's fleets consume; ``device`` (the
    Simulator's) resolves the automatic mode."""
    import torch

    n = spec.members
    ones = np.ones(max(n, 1), np.float64)
    qps = ones if spec.qps_scale is None else spec.qps_scale
    cpu = ones if spec.cpu_scale is None else spec.cpu_scale
    err = ones if spec.error_scale is None else spec.error_scale
    return EnsembleTables(
        members=n,
        seeds=tuple(spec.seeds),
        qps_scale=np.asarray(qps, np.float64),
        cpu_scale=torch.as_tensor(np.asarray(cpu, np.float32)),
        err_scale=torch.as_tensor(np.asarray(err, np.float32)),
        jittered=spec.jittered,
        mode=spec.resolved_mode(device),
    )


def rung_bucket(width: int) -> int:
    """A rung's member width padded up to the next power of two (the
    search brackets' shape family)."""
    return 1 << max(int(width) - 1, 0).bit_length()


def ensemble_take(stacked, idx):
    """Gather member rows (a tensor of member indices) from every leaf
    of member-stacked fleet inputs or outputs: the rung-advancement
    primitive of the search brackets; the gathered rows are the source
    rows bit for bit."""
    from isotope_tpu_torch.sim.ensemble import tree_map

    return tree_map(lambda x: x.index_select(0, idx.to(x.device)), stacked)


class ChaosFx(NamedTuple):
    """Per-member stacked chaos tables of a chaos fleet.

    A Simulator's chaos tables (effective replicas, outage flags, the
    policy layer's chaos-downed deltas, the rollout canary-first
    kill-split tables, the lb panic healthy pools, the ungraceful-kill
    reset rows and the saturated finite-population tables) are
    constants of one schedule; a fleet whose members survive different
    bad days has them per member, stacked along a leading member axis.
    Every field past the first two is optional: ``None`` where the
    composition arms no such layer (:func:`chaos_fx_layout`).  Shapes
    align across members because ``resilience/faults.
    jitter_chaos_events`` keeps the base schedule's cut structure
    (checked at build time)."""

    eff_replicas_pc: "torch.Tensor"   # (N, P*Cc, S) int32
    svc_down_pc: "torch.Tensor"       # (N, P*Cc, S) bool
    downed_pc: "torch.Tensor" = None  # (N, P*Cc, S) f32 (policies)
    eff_base_roll_pc: "torch.Tensor" = None       # (N, P*Cc, S) int32
    svc_down_base_roll_pc: "torch.Tensor" = None  # (N, P*Cc, S) bool
    can_reps_pc: "torch.Tensor" = None            # (N, P*Cc, S) f32
    svc_down_can_pc: "torch.Tensor" = None        # (N, P*Cc, S) bool
    downed_base_pc: "torch.Tensor" = None         # (N, P*Cc, S) f32
    lb_alive_pc: "torch.Tensor" = None            # (N, P*Cc, S) f32
    kill_t: "torch.Tensor" = None                 # (N, E) f32
    kill_frac: "torch.Tensor" = None              # (N, E, H) f32
    sat_p0: "torch.Tensor" = None                 # (N, R, H) f32
    sat_coef: "torch.Tensor" = None               # (N, R, D+1, H) f32
    sat_e: "torch.Tensor" = None                  # (N, R, H) f32
    sat_c: "torch.Tensor" = None                  # (N, R) f32
    sat_scale: "torch.Tensor" = None              # (N, R, H) f32
    sat_cuts: "torch.Tensor" = None               # (N, P) f32
    sat_lam: "torch.Tensor" = None                # (N, P) f32
    sat_breaks: "torch.Tensor" = None             # (N, P) f32


def chaos_fx_layout(sim, with_pol: bool, roll: bool,
                    sat: bool) -> Tuple[str, ...]:
    """The armed :class:`ChaosFx` fields of one fleet composition."""
    fields = ["eff_replicas_pc", "svc_down_pc"]
    pol = with_pol and sim._policies is not None
    if pol:
        fields.append("downed_pc")
    if roll and sim._rollouts is not None:
        fields += [
            "eff_base_roll_pc", "svc_down_base_roll_pc",
            "can_reps_pc", "svc_down_can_pc",
        ]
        if pol:
            fields.append("downed_base_pc")
    if sim._lb is not None and sim._lb.any_panic and not sat:
        fields.append("lb_alive_pc")
    if sim._num_kill_events:
        fields += ["kill_t", "kill_frac"]
    if sat:
        fields += [
            "sat_p0", "sat_coef", "sat_e", "sat_c", "sat_scale",
            "sat_cuts", "sat_lam", "sat_breaks",
        ]
    return tuple(fields)


def compile_chaos_members(sim, member_events, with_pol: bool = False,
                          roll: bool = False, sat_conns: int = 0,
                          source=None):
    """Each member's planner Simulator (``sim._member_planner``: its own
    phase reach multipliers, retry-feedback fixed point, drain windows
    and device tables) plus the stacked :class:`ChaosFx` tables of the
    composition's layout.  Raises when a member's schedule breaks the
    shape-aligned contract (another cut count than the base schedule).
    ``source`` is the draw source whose fixed-seed pilots build the
    saturated tables (``Simulator._closed_tables``).  Returns
    ``(planners, ChaosFx)``."""
    import torch

    planners = [sim._member_planner(evts) for evts in member_events]
    P = int(np.asarray(sim._phase_starts).shape[0])
    W = sim._num_windows
    for m, pl in enumerate(planners):
        if (int(np.asarray(pl._phase_starts).shape[0]) != P
                or pl._num_windows != W
                or pl._num_combos != sim._num_combos):
            raise ValueError(
                f"member {m}'s jittered chaos schedule has a "
                "different phase-cut structure than the base schedule "
                f"({np.asarray(pl._phase_starts).shape[0]} cuts vs "
                f"{P}); per-member chaos requires shape-aligned "
                "schedules (same event count, distinct solo cuts)"
            )
    dev = sim.device

    def stack(attr):
        return torch.stack([getattr(pl, attr) for pl in planners])

    kw: dict = {}
    pol = with_pol and sim._policies is not None
    if pol:
        kw["downed_pc"] = stack("_downed_pc")
    if roll and sim._rollouts is not None:
        kw["eff_base_roll_pc"] = stack("_eff_base_roll_pc")
        kw["svc_down_base_roll_pc"] = stack("_svc_down_base_roll_pc")
        kw["can_reps_pc"] = stack("_can_reps_pc")
        kw["svc_down_can_pc"] = stack("_svc_down_can_pc")
        if pol:
            kw["downed_base_pc"] = stack("_downed_base_pc")
    if sim._lb is not None and sim._lb.any_panic and not sat_conns:
        kw["lb_alive_pc"] = stack("_lb_alive_pc")
    if sim._num_kill_events:
        kw["kill_t"] = stack("_kill_t")
        kw["kill_frac"] = stack("_kill_frac")
    if sat_conns:
        rows = [pl._closed_tables(int(sat_conns), source)
                for pl in planners]
        kw["sat_p0"] = torch.stack([r[1] for r in rows])
        kw["sat_coef"] = torch.stack([r[2] for r in rows])
        kw["sat_e"] = torch.stack([r[3] for r in rows])
        kw["sat_c"] = torch.as_tensor(
            np.stack([np.asarray(r[4]) for r in rows]), dtype=torch.float32
        ).to(dev)
        kw["sat_scale"] = torch.stack([r[5] for r in rows])
        # the phased nominal-time warp constants, float64 host math
        # as in the solo branch, rounded once to float32
        cuts_l, lam_l, breaks_l = [], [], []
        for pl, r in zip(planners, rows):
            lam_p = np.maximum(
                np.asarray(r[0]).reshape(P, pl._num_combos).mean(1), 1e-9
            )
            cuts_np = np.asarray(pl._phase_starts, np.float64)
            breaks = np.concatenate(
                [[0.0], np.cumsum(lam_p[:-1] * np.diff(cuts_np))]
            )
            cuts_l.append(cuts_np)
            lam_l.append(lam_p)
            breaks_l.append(breaks)
        for name, arr in (("sat_cuts", cuts_l), ("sat_lam", lam_l),
                          ("sat_breaks", breaks_l)):
            kw[name] = torch.as_tensor(
                np.stack(arr), dtype=torch.float32
            ).to(dev)
    fx = ChaosFx(
        eff_replicas_pc=stack("_replicas_pc"),
        svc_down_pc=stack("_svc_down_pc"),
        **kw,
    )
    return planners, fx
