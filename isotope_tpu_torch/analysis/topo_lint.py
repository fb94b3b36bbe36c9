"""Topology & experiment-config linter (host-side: it runs nothing on a
device).

The port of ``isotope_tpu.analysis.topo_lint``.

Structured diagnostics over the L0 topology IR (models/graph.py) and
the sweep config (runner/config.py): every rule reports a stable id, a
severity, and the config path of the offending node, so defects that
today surface as engine crashes minutes into compile — or never surface
at all (a service nobody calls silently idles) — become pre-flight
findings.  The GSPMD discipline applied to configuration: analyze the
graph before anything executes.
"""
from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Tuple

from isotope_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    Finding,
)
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.models.script import ConcurrentCommand, RequestCommand

#: payloads past this are flagged (VET-T006): at the default 10 Gbit/s
#: model a 256 MiB body is >200 ms of pure wire time per direction —
#: beyond any plausible call timeout in these workloads
PAYLOAD_BOUND_BYTES = 256 * 1024 * 1024

#: the engine's default HBM element budget and block floor
#: (sim/engine.py default_block_size) — VET-T007 mirrors them
BLOCK_ELEM_BUDGET = 33_554_432
BLOCK_FLOOR = 256

#: appended to VET-T008's message: the padding it reports is the JAX
#: package's scan-bucket plan, which this package does not execute
T008_NOTE = (
    " (the padding is the JAX reference executor's scan-bucket plan; "
    "this package sweeps every level one by one, pads nothing and "
    "ignores level_bucket_waste)"
)


def _call_targets(script) -> List[str]:
    out: List[str] = []
    for cmd in script:
        if isinstance(cmd, RequestCommand):
            out.append(cmd.service_name)
        elif isinstance(cmd, ConcurrentCommand):
            for sub in cmd:
                if isinstance(sub, RequestCommand):
                    out.append(sub.service_name)
    return out


def _adjacency(graph: ServiceGraph) -> Dict[str, List[str]]:
    return {s.name: _call_targets(s.script) for s in graph.services}


def _find_cycle(entry: str, adj: Dict[str, List[str]]
                ) -> Optional[List[str]]:
    """First cycle reachable from ``entry`` (as a name path), or None.

    Iterative DFS with an explicit stack: the svc10k/svc100k-scale
    topologies this pass targets are deeper than Python's recursion
    limit (a 2000-service chain already blows it)."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    path: List[str] = []
    # (node, iterator-over-targets) frames
    stack = [(entry, iter(adj.get(entry, ())))]
    color[entry] = GRAY
    path.append(entry)
    while stack:
        node, targets = stack[-1]
        for t in targets:
            if t not in color:
                continue  # undefined target: decode already failed
            if color[t] == GRAY:
                return path[path.index(t):] + [t]
            if color[t] == WHITE:
                color[t] = GRAY
                path.append(t)
                stack.append((t, iter(adj.get(t, ()))))
                break
        else:
            color[node] = BLACK
            path.pop()
            stack.pop()
    return None


def lint_graph(
    graph: ServiceGraph,
    entry: Optional[str] = None,
    params=None,
) -> List[Finding]:
    """Lint one service graph.  ``params`` (a SimParams) refines the
    shape-dependent rules (block budget, bucket waste); None uses the
    engine defaults."""
    findings: List[Finding] = []
    adj = _adjacency(graph)
    names = [s.name for s in graph.services]
    idx = {n: i for i, n in enumerate(names)}

    # -- entrypoint (VET-T003) --------------------------------------------
    if entry is not None and entry not in idx:
        findings.append(Finding(
            "VET-T003", SEV_ERROR,
            f"--entry names unknown service {entry!r}",
        ))
        entry = None
    if entry is None:
        entries = [s.name for s in graph.services if s.is_entrypoint]
        if not entries:
            findings.append(Finding(
                "VET-T003", SEV_ERROR,
                "no service sets isEntrypoint: true",
            ))
            return findings  # reachability/cycle need a root
        entry = entries[0]

    # -- cycles (VET-T002) -------------------------------------------------
    cycle = _find_cycle(entry, adj)
    if cycle is not None:
        findings.append(Finding(
            "VET-T002", SEV_ERROR,
            "cycle: " + " -> ".join(cycle) + " (the reproducible-cycle "
            "solve covers closed-loop rate cycles, not call-graph "
            "recursion; break the call loop)",
            path=f"services[{idx[cycle[0]]}]",
        ))

    # -- reachability (VET-T001) ------------------------------------------
    seen = set()
    stack = [entry]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        stack.extend(t for t in adj.get(n, ()) if t in idx)
    for i, name in enumerate(names):
        if name not in seen:
            findings.append(Finding(
                "VET-T001", SEV_ERROR,
                f"service {name!r} is never called from entrypoint "
                f"{entry!r} (dead capacity, or a mistyped call target)",
                path=f"services[{i}]",
            ))

    # -- per-service bounds (VET-T004/T005/T006) ---------------------------
    for i, svc in enumerate(graph.services):
        if svc.num_replicas < 1:
            findings.append(Finding(
                "VET-T004", SEV_ERROR,
                f"numReplicas={svc.num_replicas}: the M/M/k station has "
                "no servers (the compiler would silently clamp to 1)",
                path=f"services[{i}].numReplicas",
            ))
        if float(svc.error_rate) >= 1.0 and svc.name in seen:
            findings.append(Finding(
                "VET-T005", SEV_WARN,
                f"errorRate={svc.error_rate}: every request to "
                f"{svc.name!r} fails"
                + (" — the entrypoint 500s the whole run"
                   if svc.name == entry else ""),
                path=f"services[{i}].errorRate",
            ))
        if int(svc.response_size) > PAYLOAD_BOUND_BYTES:
            findings.append(Finding(
                "VET-T006", SEV_WARN,
                f"responseSize={svc.response_size} exceeds "
                f"{PAYLOAD_BOUND_BYTES} bytes",
                path=f"services[{i}].responseSize",
            ))
        for j, cmd in enumerate(svc.script):
            calls = (
                [c for c in cmd if isinstance(c, RequestCommand)]
                if isinstance(cmd, ConcurrentCommand)
                else [cmd] if isinstance(cmd, RequestCommand) else []
            )
            for call in calls:
                if int(call.size) > PAYLOAD_BOUND_BYTES:
                    findings.append(Finding(
                        "VET-T006", SEV_WARN,
                        f"call to {call.service_name!r} sends "
                        f"{call.size} (> {PAYLOAD_BOUND_BYTES} bytes)",
                        path=f"services[{i}].script[{j}]",
                    ))

    findings.extend(_lint_policies(graph, params))
    findings.extend(_lint_rollouts(graph, params))
    findings.extend(_lint_lb(graph, params))
    return findings


def _lint_policies(graph: ServiceGraph, params) -> List[Finding]:
    """Resilience-policy misconfiguration rules (VET-T010..T013) over
    the topology's ``policies:`` block (sim/policies.py).

    VET-T010 (the steady-state breaker-capacity rule) needs an offered
    rate, so it lives in :func:`lint_config`; the load-free rules here
    are: VET-T011 autoscaler ``min_replicas > max_replicas``,
    VET-T012 a zero retry budget on a retried call target,
    VET-T013 an autoscaler sync period shorter than the timeline
    window (the control loop cannot observe faster than the recorder
    samples), and VET-T014 a policies block that does not decode at
    all (typo'd keys, malformed values).
    """
    if not getattr(graph, "policies", None):
        return []
    # lazy: imported only when the graph declares policies
    from isotope_tpu_torch.sim import policies as policies_mod

    findings: List[Finding] = []
    names = [s.name for s in graph.services]
    pset, problems = policies_mod.lint_policies(graph.policies, names)
    for _, msg in problems:
        findings.append(Finding(
            "VET-T014", SEV_ERROR,
            f"policies block does not decode: {msg}",
            path="policies",
        ))
    if pset is None:
        return findings
    if params is None:
        from isotope_tpu_torch.sim.config import SimParams

        params = SimParams()
    # which services are the target of a call with retries > 0
    retried = set()
    for svc in graph.services:
        for cmd in svc.script:
            calls = (
                [c for c in cmd if isinstance(c, RequestCommand)]
                if isinstance(cmd, ConcurrentCommand)
                else [cmd] if isinstance(cmd, RequestCommand) else []
            )
            for call in calls:
                if call.retries > 0:
                    retried.add(call.service_name)
    for name in names:
        p = pset.for_service(name)
        if p.autoscaler is not None:
            a = p.autoscaler
            if a.min_replicas > a.max_replicas:
                findings.append(Finding(
                    "VET-T011", SEV_ERROR,
                    f"autoscaler min_replicas={a.min_replicas} > "
                    f"max_replicas={a.max_replicas}: the desired-count "
                    "clamp is empty (the controller could never "
                    "actuate a legal count)",
                    path=f"policies.{name}.autoscaler",
                ))
            if a.sync_period_s < params.timeline_window_s:
                findings.append(Finding(
                    "VET-T013", SEV_WARN,
                    f"autoscaler sync_period {a.sync_period_s:g}s is "
                    "shorter than the timeline window "
                    f"{params.timeline_window_s:g}s: the control loop "
                    "cannot observe faster than the flight recorder "
                    "samples, so syncs between window boundaries see "
                    "stale signals (widen sync_period or narrow "
                    "--timeline)",
                    path=f"policies.{name}.autoscaler.sync_period",
                ))
        if (
            p.retry_budget is not None
            and p.retry_budget.budget_percent <= 0.0
            and p.retry_budget.min_retries_concurrent <= 0.0
            and name in retried
        ):
            findings.append(Finding(
                "VET-T012", SEV_WARN,
                f"retry_budget of 0 on {name!r}, but calls to it set "
                "retries > 0: every retry will be suppressed once any "
                "are observed (drop the retries or raise the budget)",
                path=f"policies.{name}.retry_budget",
            ))
    return findings


def _lint_rollouts(graph: ServiceGraph, params) -> List[Finding]:
    """Progressive-delivery misconfiguration rules (VET-T015..T018)
    over the topology's ``rollouts:`` block (sim/rollout.py).

    VET-T017 (min-samples reachability) needs an offered rate, so it
    lives in :func:`lint_config`; the load-free rules here are:
    VET-T015 a step schedule that is not strictly increasing or does
    not end at 100% (the rollout can thrash between equal weights, or
    "finishes" while still splitting traffic) — and, as an error, a
    rollouts block that does not decode at all; VET-T016 a bake time
    shorter than the recorder window (a step can promote before the
    controller ever observes a completed window of it); VET-T018
    canary overrides on a service with no step schedule (the canary
    physics never actuate).
    """
    if not getattr(graph, "rollouts", None):
        return []
    # lazy: imported only when the graph declares rollouts
    from isotope_tpu_torch.sim import rollout as rollout_mod

    findings: List[Finding] = []
    names = [s.name for s in graph.services]
    rset, problems = rollout_mod.lint_rollouts(graph.rollouts, names)
    for _, msg in problems:
        findings.append(Finding(
            "VET-T015", SEV_ERROR,
            f"rollouts block does not decode: {msg}",
            path="rollouts",
        ))
    if rset is None:
        return findings
    if params is None:
        from isotope_tpu_torch.sim.config import SimParams

        params = SimParams()
    for name in names:
        r = rset.for_service(name)
        raw = (
            graph.rollouts.get(name)
            if isinstance(graph.rollouts, dict) else None
        )
        if not r.active:
            if isinstance(raw, dict) and raw.get("canary"):
                findings.append(Finding(
                    "VET-T018", SEV_WARN,
                    f"canary overrides on {name!r} but no step "
                    "schedule: the rollout never actuates (declare "
                    "`steps:` or drop the `canary:` block)",
                    path=f"rollouts.{name}.canary",
                ))
            continue
        steps = r.steps
        if any(b <= a for a, b in zip(steps, steps[1:])):
            findings.append(Finding(
                "VET-T015", SEV_WARN,
                f"step schedule {[f'{w:.0%}' for w in steps]} on "
                f"{name!r} is not strictly increasing: a promotion "
                "that does not raise the canary weight re-bakes the "
                "same split and gains nothing",
                path=f"rollouts.{name}.steps",
            ))
        if steps[-1] < 1.0:
            findings.append(Finding(
                "VET-T015", SEV_WARN,
                f"step schedule on {name!r} ends at {steps[-1]:.0%}, "
                "not 100%: the rollout finishes DONE while still "
                "splitting traffic between two deployments forever",
                path=f"rollouts.{name}.steps",
            ))
        if r.bake_s < params.timeline_window_s:
            findings.append(Finding(
                "VET-T016", SEV_WARN,
                f"bake {r.bake_s:g}s on {name!r} is shorter than the "
                f"recorder window {params.timeline_window_s:g}s: a "
                "step can promote before the controller observes a "
                "single completed window of it (widen bake or narrow "
                "--timeline)",
                path=f"rollouts.{name}.bake",
            ))
    return findings


def _lint_lb(graph: ServiceGraph, params) -> List[Finding]:
    """Load-balancing misconfiguration rules (VET-T019..T022) over the
    topology's per-service ``lb:`` entries (sim/lb.py).

    VET-T019: ``choices_d`` exceeds the replica count — power-of-d
    sampling cannot draw more distinct backends than exist, so the law
    silently degenerates to full-pool least-request (JSQ); VET-T020:
    ring-hash on a single-replica service — every key maps to the one
    backend, stickiness is a no-op (info); VET-T021: a panic threshold
    of 1.0 or above (every run starts panicked — error), or one the
    breaker's ``max_ejection_fraction`` can never reach (ejection
    leaves ``1 - max_ejection_fraction`` healthy, so panic is dead
    code under ejection-only unhealth — warn); VET-T022: lb entries
    that do not decode at all.
    """
    if not getattr(graph, "policies", None):
        return []
    # lazy: imported only when the graph declares lb
    from isotope_tpu_torch.sim import lb as lb_mod
    from isotope_tpu_torch.sim import policies as policies_mod

    findings: List[Finding] = []
    names = [s.name for s in graph.services]
    lbs, problems = lb_mod.lint_lb(graph.policies, names)
    for _, msg in problems:
        findings.append(Finding(
            "VET-T022", SEV_ERROR,
            f"lb entries do not decode: {msg}",
            path="policies",
        ))
    if lbs is None or lbs.empty:
        return findings
    pset, _ = policies_mod.lint_policies(graph.policies, names)
    replicas = {s.name: max(1, s.num_replicas) for s in graph.services}
    for name in names:
        p = lbs.for_service(name)
        if p is None or not p.active:
            continue
        k = replicas[name]
        if p.policy == "least_request" and p.choices_d > k:
            findings.append(Finding(
                "VET-T019", SEV_WARN,
                f"lb choices_d={p.choices_d} on {name!r} exceeds its "
                f"{k} replica(s): power-of-d cannot sample more "
                "distinct backends than exist — the law degenerates "
                "to full-pool least-request (lower choices_d or add "
                "replicas)",
                path=f"policies.{name}.lb.choices_d",
            ))
        if p.policy == "ring_hash" and k <= 1:
            findings.append(Finding(
                "VET-T020", SEV_INFO,
                f"ring_hash on {name!r} with replicas: 1 — every key "
                "maps to the single backend, so hash stickiness (and "
                "hash_skew) is a no-op",
                path=f"policies.{name}.lb",
            ))
        if p.panic_threshold >= 1.0:
            findings.append(Finding(
                "VET-T021", SEV_ERROR,
                f"panic_threshold={p.panic_threshold:g} on {name!r}: "
                "the healthy fraction is always < 1.0 under any "
                "unhealth, so the pool PANICS from the first ejection "
                "or kill (thresholds are fractions in [0, 1))",
                path=f"policies.{name}.lb.panic_threshold",
            ))
        elif p.panic_threshold > 0.0 and pset is not None:
            b = pset.for_service(name).breaker
            if (
                b is not None
                and b.consecutive_errors > 0
                and 1.0 - b.max_ejection_fraction >= p.panic_threshold
            ):
                findings.append(Finding(
                    "VET-T021", SEV_WARN,
                    f"panic_threshold={p.panic_threshold:g} on "
                    f"{name!r} is unreachable via outlier ejection: "
                    f"max_ejection_fraction={b.max_ejection_fraction:g}"
                    f" leaves {1.0 - b.max_ejection_fraction:g} of the"
                    " pool healthy, above the threshold — panic only "
                    "fires under chaos kills (raise the threshold or "
                    "the ejection cap)",
                    path=f"policies.{name}.lb.panic_threshold",
                ))
    return findings


def lint_ensemble(spec) -> List[Finding]:
    """Ensemble-spec misconfiguration rules (VET-T023) over an
    :class:`~isotope_tpu_torch.sim.ensemble.EnsembleSpec`.

    VET-T023 errors on a fleet with zero members (nothing to
    simulate) or duplicate member seeds: duplicated seeds make two
    members bit-identical copies of one trajectory, silently
    narrowing every confidence interval the ensemble exists to
    produce.  ``run_ensemble`` raises the same defects loudly at run
    entry (sim/ensemble.py ``EnsembleSpec.check``)."""
    findings: List[Finding] = []
    if spec is None:
        return findings
    if spec.members == 0:
        findings.append(Finding(
            "VET-T023", SEV_ERROR,
            "ensemble spec has zero members: the fleet would simulate "
            "nothing (set members >= 1 or drop the ensemble)",
            path="sim.ensemble",
        ))
        return findings
    seeds = tuple(spec.seeds)
    dupes = sorted({s for s in seeds if seeds.count(s) > 1})
    if dupes:
        findings.append(Finding(
            "VET-T023", SEV_ERROR,
            f"ensemble spec has duplicate member seeds {dupes}: "
            "duplicated members replay one trajectory bit-for-bit — "
            "they are not extra Monte Carlo samples and silently "
            "narrow every confidence interval",
            path="sim.ensemble",
        ))
    return findings


def lint_split(spec) -> List[Finding]:
    """Importance-splitting misconfiguration rules (VET-T024) over a
    :class:`~isotope_tpu_torch.sim.splitting.SplitSpec` (or its raw
    ``--ensemble-split`` string).

    Errors on an undecodable spec, a survivor fraction outside
    (0, 1) (``keep >= 1`` keeps every member — the levels never climb
    toward the rare event; ``keep <= 0`` keeps none), and a budget of
    fewer than one survivor per level (``keep * members < 1``: the
    level quantile falls on an empty survivor set).  The estimator
    raises the same defects loudly at run entry
    (sim/splitting.py ``SplitSpec``)."""
    findings: List[Finding] = []
    if spec is None:
        return findings
    if isinstance(spec, str):
        from isotope_tpu_torch.sim.splitting import parse_split_spec

        try:
            spec = parse_split_spec(spec)
        except (ValueError, TypeError) as e:
            findings.append(Finding(
                "VET-T024", SEV_ERROR,
                f"undecodable importance-splitting spec: {e}",
                path="sim.ensemble_split",
            ))
            return findings
        if spec is None:
            return findings
    if spec.keep * spec.members < 1.0:
        findings.append(Finding(
            "VET-T024", SEV_ERROR,
            f"splitting budget has fewer than one survivor per level "
            f"(keep {spec.keep:g} x members {spec.members} < 1): the "
            "level quantile falls on an empty survivor set — raise "
            "members or keep",
            path="sim.ensemble_split",
        ))
    if spec.levels <= 1:
        findings.append(Finding(
            "VET-T024", SEV_WARN,
            "a single splitting level degenerates to plain Monte "
            f"Carlo at the first threshold (resolving floor ~1/"
            f"{spec.members}); raise levels for rarer events",
            path="sim.ensemble_split",
        ))
    return findings


def lint_search(spec, num_requests=None,
                block: int = 65_536) -> List[Finding]:
    """Search-bracket misconfiguration rules (VET-T026) over a
    :class:`~isotope_tpu_torch.sim.search.SearchSpec` (or its raw
    ``[search]`` table dict).

    Errors on an undecodable spec, a population too small for the
    bracket (rung widths ``ceil(N / eta^r)`` must strictly shrink —
    population < eta degenerates at the first halving), and — when
    ``num_requests`` is known — a horizon schedule that fails to
    increase between rungs (the continuation segments would be
    empty).  Warns when the population is not a power of ``eta``
    (non-integer survivor counts: ceil rounds rungs up, so padded
    slots re-run candidates the severity rank already rejected) and
    when the rank channel needs a recorder no search fleet carries
    (``err_peak`` falls back to ``err_share``).  ``run_search``
    raises the ERROR-grade defects loudly at run entry
    (sim/search.py ``SearchSpec.check`` / ``plan_bracket``)."""
    findings: List[Finding] = []
    if spec is None:
        return findings
    from isotope_tpu_torch.sim.search import SearchSpec

    if isinstance(spec, dict):
        try:
            spec = SearchSpec.from_dict(spec)
        except (ValueError, TypeError, KeyError) as e:
            findings.append(Finding(
                "VET-T026", SEV_ERROR,
                f"undecodable search spec: {e}",
                path="search",
            ))
            return findings
    widths = spec.rung_widths()
    if any(b >= a for a, b in zip(widths, widths[1:])):
        findings.append(Finding(
            "VET-T026", SEV_ERROR,
            f"population of {spec.members} cannot support "
            f"{spec.rungs} rungs at eta={spec.eta}: rung widths "
            f"{widths} stop shrinking — the bracket degenerates at "
            "the first halving (grow the population or drop rungs)",
            path="search",
        ))
    else:
        n = spec.members
        if any(n % spec.eta ** r for r in range(spec.rungs)):
            findings.append(Finding(
                "VET-T026", SEV_WARN,
                f"population {n} is not a power-of-eta multiple "
                f"(eta={spec.eta}, widths {widths}): ceil rounds "
                "survivor counts up and pow2 buckets pad the rungs — "
                "some dispatch slots re-run already-rejected "
                "candidates (harmless, but a power of eta wastes "
                "none)",
                path="search",
            ))
    if spec.rank == "err_peak":
        findings.append(Finding(
            "VET-T026", SEV_WARN,
            "rank='err_peak' needs the recorder-window timelines no "
            "search fleet carries — the bracket ranks by the run-long "
            "'err_share' fallback (use rank='err_share' to say what "
            "runs, or rank='p99' with slo= for tail risk)",
            path="search.rank",
        ))
    if num_requests is not None and not any(
        f.severity == SEV_ERROR for f in findings
    ):
        from isotope_tpu_torch.sim.search import plan_bracket

        try:
            plan_bracket(spec, int(num_requests), int(block))
        except ValueError as e:
            findings.append(Finding(
                "VET-T026", SEV_ERROR, str(e), path="search",
            ))
    return findings


def lint_compiled(compiled, params=None) -> List[Finding]:
    """Shape rules needing the unrolled hop tree (VET-T007/T008).

    Pure NumPy over the CompiledGraph — compiling is host-side, so
    these rules still run without a device."""
    from isotope_tpu_torch.compiler import buckets
    from isotope_tpu_torch.sim.config import SimParams

    if params is None:
        params = SimParams()
    findings: List[Finding] = []
    h = max(compiled.num_hops, 1)

    # VET-T007: the default block floors at BLOCK_FLOOR requests; when
    # hops alone exceed budget/floor every block busts the element
    # budget the block size exists to respect (default_block_size)
    if h * BLOCK_FLOOR > BLOCK_ELEM_BUDGET:
        findings.append(Finding(
            "VET-T007", SEV_WARN,
            f"{h} hops x the {BLOCK_FLOOR}-request block floor = "
            f"{h * BLOCK_FLOOR} elements per event tensor "
            f"(budget {BLOCK_ELEM_BUDGET}); expect the OOM ladder "
            "or shard over a mesh",
        ))

    # VET-T008: plan the buckets exactly as the reference's scan
    # executor does and check the realized padding against the
    # configured budget (reference_plan)
    shapes, plan = reference_plan(compiled, params, findings)
    stats = buckets.plan_stats(shapes, plan)
    waste_budget = params.level_bucket_waste - 1.0
    if stats["padded_elems"] and stats["padding_waste_fraction"] > max(
        waste_budget / (1.0 + waste_budget), 0.0
    ) + 1e-9:
        findings.append(Finding(
            "VET-T008", SEV_WARN,
            f"bucket plan pads {stats['padding_waste_fraction']:.1%} of "
            f"element slots (budget from level_bucket_waste="
            f"{params.level_bucket_waste:g}); retune the waste knob for "
            "this topology family" + T008_NOTE,
        ))
    return findings



def reference_plan(compiled, params, findings=None):
    """``(shapes, plan)``: the level shapes and the scan-bucket plan of
    the reference's executor (``compiler/buckets.plan_segments``), which
    the port does not execute: it sweeps every level one by one and pads
    nothing.  VET-T008 and the cost model's ``bucket_schedule`` read it;
    the VET-C006 findings of tiled and sparse levels are appended to
    ``findings`` when given."""
    from isotope_tpu_torch.compiler import buckets

    if findings is None:
        findings = []
    # The step encoding decision
    # (dense / tiled / sparse) is the engine's own
    # (compiler/buckets.level_encoding), so VET-C006 reports the
    # executor's real fallbacks, not a reimplementation's.
    shapes = []
    offset = 0
    for d, lvl in enumerate(compiled.levels):
        pmax = max(int(lvl.step_is_real.sum(1).max(initial=0)), 1)
        import numpy as np

        sparse = False
        tiles = None
        residual_slots = 0
        if lvl.num_calls:
            n_slots = len(np.unique(lvl.call_seg))
            widths = lvl.step_is_real[:, :pmax].sum(1)
            enc, tile_plan = buckets.level_encoding(
                lvl.num_hops, pmax, n_slots, widths,
                sparse_level_elems=params.sparse_level_elems,
                tiling=params.sparse_tiling,
                tile_pmax=params.sparse_tile_pmax,
            )
            sparse = enc != "dense"
            if enc == "tiled":
                tiles = tile_plan.shapes()
                res_widths = widths[tile_plan.residual]
                # EXACT residual slot count (call-bearing steps of the
                # residual hops) — the engine's tiled.residual.n_slots,
                # not the script-width approximation, so the vet
                # surface agrees with costmodel.schedule_rows(sim)
                call_parent = lvl.call_seg // compiled.max_steps
                res_mask = np.isin(call_parent, tile_plan.residual)
                residual_slots = len(np.unique(lvl.call_seg[res_mask]))
                if len(tile_plan.residual):
                    grid = lvl.num_hops * pmax
                    # pure padding of the avoided dense grid: slots the
                    # grid holds beyond EVERY hop's real steps (tiled
                    # hops' real work is not padding)
                    pad = grid - int(widths.sum())
                    findings.append(Finding(
                        "VET-C006", SEV_INFO,
                        f"{len(tile_plan.residual)} of {lvl.num_hops} "
                        f"hop(s) at depth {d} exceed the "
                        f"sparse_tile_pmax={params.sparse_tile_pmax} "
                        f"tile cap (widest script "
                        f"{int(res_widths.max(initial=0))} steps) and "
                        "stay on the residual sparse path "
                        f"({residual_slots} slot(s)); the dense grid "
                        f"they avoid is {grid} element-slots "
                        f"({pad} pure padding, "
                        f"{pad / max(grid, 1):.1%} waste)",
                        path=f"levels[{d}]",
                    ))
            elif enc == "sparse":
                grid = lvl.num_hops * pmax
                residual_slots = n_slots
                pad = grid - int(widths.sum())
                findings.append(Finding(
                    "VET-C006", SEV_INFO,
                    f"level at depth {d} ({lvl.num_hops} hop(s), "
                    f"widest script {pmax} steps) does not tile — the "
                    f"whole level runs the sparse call-slot path over "
                    f"{n_slots} slot(s); its dense grid would be "
                    f"{grid} element-slots "
                    f"({pad / max(grid, 1):.1%} pure padding)",
                    path=f"levels[{d}]",
                ))
        shapes.append(buckets.LevelShape(
            size=lvl.num_hops, pmax=pmax, children=lvl.num_children,
            calls=lvl.num_calls, attempts=lvl.max_attempts,
            sparse=sparse, offset=offset, tiles=tiles,
            residual_slots=residual_slots,
        ))
        offset += lvl.num_hops
    plan = buckets.plan_segments(
        shapes, waste=params.level_bucket_waste,
        enabled=params.bucketed_scan,
        schedule=params.bucket_schedule,
    )
    return shapes, plan

def _capacity_qps(compiled, params) -> float:
    """Static saturation throughput (the engine's capacity_qps without
    building a Simulator): bottleneck station capacity over expected
    visits."""
    import numpy as np

    visits = compiled.expected_visits()
    mu = 1.0 / params.cpu_time_s
    reps = compiled.services.replicas.astype(np.float64)
    with np.errstate(divide="ignore"):
        per_svc = np.where(
            visits > 0, reps * mu / np.maximum(visits, 1e-30), np.inf
        )
    return float(per_svc.min())


def lint_config(config) -> Tuple[List[Finding], Dict[str, object]]:
    """Lint an ExperimentConfig (sweep TOML): grid and schedule rules.

    Returns ``(findings, graphs)`` where ``graphs`` maps each readable
    topology path to its decoded ServiceGraph so callers can chain the
    per-graph passes without re-reading files."""
    from isotope_tpu_torch.runner.run import run_label  # the label law itself

    findings: List[Finding] = []
    graphs: Dict[str, object] = {}

    # VET-C001: missing/unreadable/undecodable topologies (YAML syntax
    # errors are yaml.YAMLError, NOT ValueError — vet must report them,
    # not crash on them)
    import yaml

    for i, p in enumerate(config.topology_paths):
        try:
            graphs[p] = ServiceGraph.from_yaml_file(p)
        except OSError as e:
            findings.append(Finding(
                "VET-C001", SEV_ERROR, str(e),
                path=f"topology_paths[{i}]",
            ))
        except (ValueError, yaml.YAMLError) as e:
            findings.append(Finding(
                "VET-C001", SEV_ERROR, f"{p}: {e}",
                path=f"topology_paths[{i}]",
            ))

    # VET-C002: duplicate labels (the runner raises at run time; vet
    # reports the same defect statically, with the colliding labels)
    labels = [
        run_label(topo, env.name, load, config.labels)
        for topo in config.topology_paths
        for env in config.environments
        for load in config.load_models()
    ]
    dupes = sorted({lb for lb in labels if labels.count(lb) > 1})
    if dupes:
        findings.append(Finding(
            "VET-C002", SEV_ERROR,
            f"colliding run labels: {', '.join(dupes)} (topology file "
            "stems and the load grid must disambiguate)",
        ))

    # schedule rules need the union of service names across topologies
    all_names = {
        s.name for g in graphs.values() for s in g.services
    }
    duration = float(config.duration_s)
    for i, ev in enumerate(config.chaos):
        if graphs and ev.service not in all_names:
            findings.append(Finding(
                "VET-C003", SEV_ERROR,
                f"chaos targets unknown service {ev.service!r}",
                path=f"chaos[{i}]",
            ))
        elif ev.start_s >= duration:
            findings.append(Finding(
                "VET-C004", SEV_WARN,
                f"chaos window [{ev.start_s:g}, {ev.end_s:g})s starts "
                f"after the {duration:g}s run ends",
                path=f"chaos[{i}]",
            ))
    for i, ts in enumerate(config.churn):
        if graphs and ts.service not in all_names:
            findings.append(Finding(
                "VET-C003", SEV_ERROR,
                f"churn targets unknown service {ts.service!r}",
                path=f"churn[{i}]",
            ))
        elif ts.period_s >= duration and len(ts.weights) > 1:
            findings.append(Finding(
                "VET-C004", SEV_WARN,
                f"churn period {ts.period_s:g}s never completes a "
                f"weight rotation within the {duration:g}s run",
                path=f"churn[{i}]",
            ))
    if config.mtls is not None and (
        config.mtls.period_s >= duration and len(config.mtls.taxes_s) > 1
    ):
        findings.append(Finding(
            "VET-C004", SEV_WARN,
            f"mtls period {config.mtls.period_s:g}s never alternates "
            f"within the {duration:g}s run",
            path="mtls",
        ))

    # VET-C005: open-loop offered rate vs static capacity
    # VET-T010: breaker caps vs steady-state expected queue/concurrency
    if config.load_kind == "open":
        params = config.sim_params()
        for p, g in graphs.items():
            try:
                from isotope_tpu_torch.compiler import compile_graph

                compiled = compile_graph(g, entry=config.entry)
            except ValueError:
                continue  # compile defects are the graph passes' job
            cap = _capacity_qps(compiled, params)
            stem = pathlib.Path(p).stem
            for q in config.qps:
                if q is not None and q >= cap:
                    findings.append(Finding(
                        "VET-C005", SEV_WARN,
                        f"open-loop qps {q:g} >= static capacity "
                        f"{cap:.1f} of {stem}: queues are unstable "
                        "(waits grow without bound over the run)",
                    ))
            findings.extend(
                _lint_breaker_capacity(g, compiled, params, config.qps)
            )
            findings.extend(
                _lint_rollout_samples(g, compiled, config.qps)
            )

    # VET-T023: the sweep's ensemble spec (zero members / duplicate
    # seeds) — config-level, so a broken fleet fails before any
    # topology compiles
    if getattr(config, "ensemble", 0):
        try:
            findings.extend(lint_ensemble(config.ensemble_spec()))
        except ValueError as e:
            findings.append(Finding(
                "VET-T023", SEV_ERROR, str(e), path="sim.ensemble",
            ))

    # VET-T026: the sweep's search bracket (degenerate population /
    # horizon schedule / rank channel) — config-level for the same
    # fail-before-compile reason
    if getattr(config, "search_candidates", 0):
        try:
            findings.extend(lint_search(
                config.search_spec(),
                num_requests=config.num_requests,
            ))
        except ValueError as e:
            findings.append(Finding(
                "VET-T026", SEV_ERROR, str(e), path="search",
            ))
    return findings, graphs


def _lint_rollout_samples(graph, compiled, qps_grid) -> List[Finding]:
    """VET-T017: a gate whose ``min_samples`` cannot accumulate on the
    canary arm within one bake at a configured offered rate — the
    controller HOLDS forever (or near enough that the schedule never
    finishes inside the run).  The canary arm's sample rate at a step
    of weight ``w`` is ``qps x expected_visits x w``, so the binding
    step is the first (smallest) one."""
    if not getattr(graph, "rollouts", None):
        return []
    from isotope_tpu_torch.sim import rollout as rollout_mod

    rset, _ = rollout_mod.lint_rollouts(
        graph.rollouts, [s.name for s in graph.services]
    )
    if rset is None:
        return []
    findings: List[Finding] = []
    visits = compiled.expected_visits()
    name_idx = {n: i for i, n in enumerate(compiled.services.names)}
    for name, r in rset.per_service.items():
        if not r.active or name not in name_idx:
            continue
        w0 = r.steps[0]
        per_visit = visits[name_idx[name]]
        for q in qps_grid:
            if q is None:
                continue
            expected = q * per_visit * w0 * r.bake_s
            if expected < r.gates.min_samples:
                findings.append(Finding(
                    "VET-T017", SEV_WARN,
                    f"gate min_samples={r.gates.min_samples:g} on "
                    f"{name!r} is unreachable within one bake at "
                    f"{q:g} qps: step 0 ({w0:.0%}) collects only "
                    f"~{expected:.0f} canary samples per "
                    f"{r.bake_s:g}s bake — the controller holds "
                    "indefinitely (lower min_samples, raise the "
                    "first step, or lengthen bake)",
                    path=f"rollouts.{name}.gates.min_samples",
                ))
    return findings


def _lint_breaker_capacity(
    graph, compiled, params, qps_grid
) -> List[Finding]:
    """VET-T010: a circuit breaker whose ``max_pending`` /
    ``max_connections`` sit below the M/M/k STEADY-STATE expected
    queue depth / in-flight concurrency at a configured offered rate
    sheds healthy traffic permanently — a misconfiguration, not a
    protection."""
    if not getattr(graph, "policies", None):
        return []
    import numpy as np

    from isotope_tpu_torch.sim import policies as policies_mod
    from isotope_tpu_torch.sim.feedback import np_mmk

    pset, _ = policies_mod.lint_policies(
        graph.policies, [s.name for s in graph.services]
    )
    if pset is None:
        return []
    findings: List[Finding] = []
    visits = compiled.expected_visits()
    mu = 1.0 / params.cpu_time_s
    reps = compiled.services.replicas.astype(np.float64)
    names = compiled.services.names
    for q in qps_grid:
        if q is None:
            continue
        p_wait, wait_rate, rho = np_mmk(q * visits, mu, reps)
        rho_c = np.minimum(rho, 0.9999)
        lq = p_wait * rho_c / np.maximum(1.0 - rho_c, 1e-9)
        inflight = lq + rho_c * reps
        for s, name in enumerate(names):
            pol = pset.for_service(name)
            if pol.breaker is None:
                continue
            b = pol.breaker
            if b.max_pending is not None and b.max_pending < lq[s]:
                findings.append(Finding(
                    "VET-T010", SEV_WARN,
                    f"breaker max_pending={b.max_pending:g} on "
                    f"{name!r} is below the steady-state expected "
                    f"queue depth {lq[s]:.1f} at {q:g} qps: the "
                    "breaker sheds HEALTHY traffic permanently",
                    path=f"policies.{name}.breaker.max_pending",
                ))
            if (
                b.max_connections is not None
                and b.max_connections < inflight[s]
            ):
                findings.append(Finding(
                    "VET-T010", SEV_WARN,
                    f"breaker max_connections={b.max_connections:g} "
                    f"on {name!r} is below the steady-state expected "
                    f"concurrency {inflight[s]:.1f} at {q:g} qps",
                    path=f"policies.{name}.breaker.max_connections",
                ))
    return findings


# -- trace-driven ingest (isotope-ingest/v1 artifacts) -----------------


def lint_ingest(graph: ServiceGraph, report_doc: dict) -> List[Finding]:
    """Lint a fitted topology against its own ingest report.

    Host-side companions to the fit: VET-T027 checks the fitted qps
    schedule's PEAK against the fitted station capacity (expected
    visits computed by DP over the fitted DAG — an errored parent
    skips its calls, so visits carry the (1 - errorRate) factor the
    engine applies); VET-T028 surfaces services the fitter emitted
    with zero observed samples (graph closure required the node, but
    every knob on it is a default, not a measurement).
    """
    findings: List[Finding] = []
    fit = report_doc.get("fit", {})
    entry = report_doc.get("entry")
    names = [s.name for s in graph.services]
    idx = {n: i for i, n in enumerate(names)}
    by_name = {s.name: s for s in graph.services}
    if entry not in idx:
        return findings

    # expected visits per entry request: DFS accumulation over the
    # (acyclic — the fitter broke cycles) fitted call graph
    visits: Dict[str, float] = {n: 0.0 for n in names}
    visits[entry] = 1.0
    order: List[str] = []
    seen = set()

    def topo(n: str) -> None:
        # iterative post-order: fitted graphs can be chain-deep
        stack = [(n, False)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if node in seen:
                continue
            seen.add(node)
            stack.append((node, True))
            for t in _call_targets(by_name[node].script):
                if t in by_name and t not in seen:
                    stack.append((t, False))

    topo(entry)
    for node in reversed(order):
        v = visits[node]
        if v <= 0:
            continue
        svc = by_name[node]
        passthrough = 1.0 - float(svc.error_rate)
        for cmd in svc.script:
            subs = cmd if isinstance(cmd, ConcurrentCommand) else [cmd]
            for sub in subs:
                if isinstance(sub, RequestCommand) and (
                    sub.service_name in visits
                ):
                    visits[sub.service_name] += (
                        v * passthrough * sub.send_probability
                    )

    schedule = fit.get("qps_schedule") or []
    cpu_time = float(fit.get("cpu_time_s") or 0.0)
    if schedule and cpu_time > 0:
        peak = max(schedule)
        mu = 1.0 / cpu_time
        for name in names:
            v = visits.get(name, 0.0)
            if v <= 0:
                continue
            reps = max(by_name[name].num_replicas, 1)
            capacity = reps * mu / v
            if peak > capacity:
                findings.append(Finding(
                    "VET-T027", SEV_WARN,
                    f"window-peak {peak:g} qps x {v:.2f} expected "
                    f"visits exceeds {name!r}'s fitted station "
                    f"capacity {capacity:.0f} qps ({reps} replica(s) "
                    f"at cpu_time {cpu_time * 1e6:.0f}us): the replay "
                    "saturates where the source did not",
                    path=f"services[{idx[name]}]",
                ))

    for row in fit.get("services", []):
        samples = row.get("observed", {}).get("samples", 0.0)
        name = row.get("name")
        if name in idx and (samples or 0.0) <= 0:
            findings.append(Finding(
                "VET-T028", SEV_WARN,
                f"service {name!r} was emitted with zero observed "
                "samples: its error/timing knobs are fit defaults",
                path=f"services[{idx[name]}]",
            ))
    return findings
