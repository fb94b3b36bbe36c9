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
(``compile_graph`` and its helpers) and of ``compile_lb``, without the
telemetry calls and without the policy, rollout, ensemble and chaos
table builders, which later slices of the port bring.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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
