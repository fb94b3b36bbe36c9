"""The vet orchestrator: compose the passes into one report.

The port of ``isotope_tpu.analysis.vet``.  ``vet`` (``commands/
vet_cmd.py``) and the ``--vet`` pre-flight gate (``runner/run.py``)
both funnel through here:

1. **topology & config lint** (``topo_lint``) — pure host;
2. **op audit** (``op_audit``) — one pilot block of the engine at the
   reference's trace size, recorded op by op (``oplog``); never a real
   block;
3. **pre-flight cost model** (``costmodel``) — the memory verdict and
   the ladder rung to start on;
4. **gradient audit** (``grad_audit``, opt-in with ``--grad``) — the
   design-knob taint classification.

The pilot runs on the Simulator's device (the card unless the caller
asked for the CPU).  Every finding increments the telemetry registry
(``isotope_engine_vet_errors_total`` / ``_warnings_total`` render as
first-class Prometheus series; per-rule counts land in the counters),
so a scrape of a vetted run shows what vet decided.  ``report.meta``
carries the cost model's numbers and the wall of each pass
(``timings_s``).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.analysis import costmodel, op_audit, topo_lint
from isotope_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_WARN,
    Finding,
    Report,
    suppression_patterns,
)

ENV_VET = "ISOTOPE_VET"
ENV_VET_SUPPRESS = "ISOTOPE_VET_SUPPRESS"

#: rules the runner's gate never blocks on while the degradation
#: ladder is armed — the rung pre-selection IS their recovery.  The
#: reference lists VET-M001 too, whose recovery is its host rung; the
#: port's rungs all run on the device, so VET-M001 blocks.
MEMORY_RULES = ("VET-M002",)

#: the memory verdict's rules (a suppressed one suppresses the verdict)
_VERDICT_RULES = ("VET-M001", "VET-M002")

class VetError(ValueError):
    """A blocking vet verdict (deterministic: the case is recorded as
    failed, never retried)."""

    def __init__(self, report: Report, strict: bool,
                 nonblocking=()):
        self.report = report
        blocking = report.blocking(strict, nonblocking)
        lines = "; ".join(
            f"{f.rule} {f.path}".strip() for f in blocking[:4]
        )
        more = len(blocking) - 4
        super().__init__(
            f"vet found {len(blocking)} blocking finding(s): {lines}"
            + (f" (+{more} more)" if more > 0 else "")
        )


def vet_mode(cli_value: Optional[str] = None) -> Optional[str]:
    """Resolve the gate mode: CLI ``--vet[=strict]`` wins, then
    ``$ISOTOPE_VET`` (``1``/``on`` or ``strict``); None = gate off."""
    if cli_value:
        return cli_value
    env = os.environ.get(ENV_VET, "").strip().lower()
    if env in ("1", "on", "true", "yes"):
        return "on"
    if env == "strict":
        return "strict"
    return None


def default_suppressions() -> list:
    return suppression_patterns(os.environ.get(ENV_VET_SUPPRESS))


def _count(report: Report) -> None:
    """Fold a report into the telemetry registry."""
    telemetry.counter_inc("vet_runs_total")
    for f in report.findings:
        telemetry.counter_inc("vet_findings")
        telemetry.counter_inc(f"vet_rule.{f.rule}")
        if f.severity == SEV_ERROR:
            telemetry.counter_inc("vet_errors_total")
        elif f.severity == SEV_WARN:
            telemetry.counter_inc("vet_warnings_total")
    for _ in report.suppressed:
        telemetry.counter_inc("vet_suppressed")


@contextmanager
def _timed(timings: dict, name: str):
    """Time one pass into ``timings`` and the telemetry phase
    ``vet.<name>`` (``grad_audit`` is the reference's ``vet.grad``)."""
    t0 = time.perf_counter()
    with telemetry.phase(f"vet.{name.replace('_audit', '')}"):
        yield
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def _plan_windows(sim, load):
    """The ``(windows, width)`` grid this LOAD plans."""
    from isotope_tpu_torch.metrics.timeline import plan_windows

    w, width, _ = plan_windows(
        getattr(load, "duration_s", 0.0) or 1.0,
        sim.params.timeline_window_s,
        sim.params.timeline_max_windows,
        sim.compiled.num_services,
        log=lambda m: None,
    )
    return w, width


def vet_simulator(
    sim,
    load,
    block_requests: Optional[int] = None,
    *,
    graph=None,
    entry: Optional[str] = None,
    trace: bool = True,
    device_bytes: Optional[float] = None,
    suppress=(),
    rung_names=costmodel.RUNG_NAMES,
    ensemble=None,
    protected: bool = False,
    split_spec=None,
    search_spec=None,
    grad: bool = False,
    protected_case=None,
) -> Report:
    """Full vet of one built Simulator under one load.

    Lint runs when ``graph`` is given; the op audit and cost model
    always run (``trace=False`` records no pilot and degrades the cost
    model to the plan-only estimate).  The recommended ladder start
    rung lands in ``report.meta['start_rung']``.

    ``ensemble`` (an EnsembleSpec, or a member count) adds the fleet
    spec lint (VET-T023) and the member-capacity verdict (VET-M004, or
    VET-T025 with ``protected``, VET-M006 for observed fleets) with the
    chunk the engine picks in ``meta['ensemble']``.  ``split_spec``
    lints the splitting config (VET-T024); ``search_spec`` lints the
    bracket (VET-T026) and runs its widest-rung verdict (VET-M005).
    ``grad=True`` runs the gradient audit on a second, knob-armed pilot;
    its ``isotope-gradaudit/v1`` document lands in ``meta['grad']``.

    The byte estimate reads two pilot sizes (:func:`sizing_pilots`):
    the audited pilot and one of twice its requests, or, for a
    protected case (``protected_case`` = ``(tl_plan, rollouts)``: the
    run's window grid and whether it rolls out), two protected pilots
    under the case's control effects.  The audits read the audited
    plain pilot only.
    """
    report = Report(suppress=suppress)
    timings: dict = {}
    with telemetry.phase("vet.total"):
        with _timed(timings, "lint"):
            if graph is not None:
                report.extend(topo_lint.lint_graph(
                    graph, entry=entry, params=sim.params,
                ))
            report.extend(topo_lint.lint_compiled(
                sim.compiled, params=sim.params,
            ))
        with _timed(timings, "pilot"):
            audit_findings, pilot, traced_n = op_audit.audit_simulator(
                sim, load, trace=trace,
            )
            sizing = (
                sizing_pilots(sim, load, pilot, protected_case)
                if pilot is not None else None
            )
        report.extend(audit_findings)
        with _timed(timings, "cost"):
            block = (
                int(block_requests) if block_requests
                else sim.default_block_size()
            )
            est = costmodel.estimate_run(
                sim, block,
                log=sizing[0].log if sizing is not None else None,
                trace_requests=sizing[0].n if sizing is not None
                else traced_n,
                capacity_override=device_bytes,
                slope_log=sizing[1].log if sizing is not None else None,
                slope_requests=sizing[1].n if sizing is not None else None,
            )
            mem_findings, start_rung = costmodel.memory_findings(
                est, rung_names=rung_names,
            )
            report.extend(mem_findings)
            report.extend(costmodel.timeline_findings(est))
            if ensemble is not None:
                _fleet_verdicts(report, sim, load, est, ensemble,
                                protected, protected_case)
        if grad:
            from isotope_tpu_torch.analysis import grad_audit

            with _timed(timings, "grad_audit"):
                gfinds, gdoc = grad_audit.audit_grad(sim, load)
            report.extend(gfinds)
            report.meta["grad"] = gdoc
        if split_spec is not None:
            report.extend(topo_lint.lint_split(split_spec))
        if search_spec is not None:
            _search_verdicts(report, sim, load, est, search_spec)
        report.meta["cost"] = {
            "block_requests": est.block_requests,
            "trace_requests": est.trace_requests,
            "slope_requests": est.slope_requests,
            "pilot": "protected" if protected_case is not None
            else "plain",
            "flops_at_block": est.flops_at_block,
            "peak_bytes_at_block": est.peak_bytes_at_block,
            "critical_path": est.critical_path,
            "capacity_bytes": est.capacity_bytes,
            "num_segments": len(est.segments),
            "timeline_bytes": est.timeline_bytes,
        }
        if est.oplog is not None:
            report.meta["cost"]["oplog"] = est.oplog.to_dict()
            report.meta["cost"]["census_calls"] = pilot.log.census_calls
        with _timed(timings, "cost"):
            # the reference executor's bucket schedule, ranked by
            # per-segment critical-path cost (the port sweeps levels)
            report.meta["bucket_schedule"] = costmodel.schedule_rows(sim)
        # the layout verdict (parallel/layout.py): what --mesh auto
        # would pick for this topology in this world, with its merge's
        # cost rows; advisory, as in the reference
        try:
            from isotope_tpu_torch.parallel.layout import choose_layout
            from isotope_tpu_torch.parallel.mesh import (
                host_count,
                world_size,
            )

            report.meta["mesh_layout"] = choose_layout(
                world_size(), sim.compiled.num_services,
                max_slices=host_count(),
            ).to_dict()
        except Exception:  # advisory only
            pass
        # a suppressed memory finding must also suppress the verdict
        report.meta["start_rung"] = (
            start_rung if mem_findings and any(
                f.rule in _VERDICT_RULES for f in report.findings
            ) else 0
        )
        report.meta["rung_names"] = list(rung_names)
        report.meta["timings_s"] = timings
    _count(report)
    return report


def sizing_pilots(sim, load, pilot, protected_case=None):
    """The two pilots the byte estimate reads (``costmodel.pilot_bytes``):
    the audited pilot (``pilot``) and one of twice its requests, both
    plain; for a protected case two protected pilots of those sizes
    (``oplog.run_pilot(protected=protected_case)``)."""
    from isotope_tpu_torch.analysis import oplog

    n1 = pilot.n
    if protected_case is not None:
        pilot = oplog.run_pilot(sim, load, n1, protected=protected_case)
    return pilot, oplog.run_pilot(sim, load, 2 * n1,
                                  protected=protected_case)


def _fleet_verdicts(report, sim, load, est, ensemble, protected,
                    protected_case=None):
    """VET-T023, then VET-M004 / VET-T025 / VET-M006 and the chunk, from
    the bytes the engine sizes the fleet's chunk from
    (``costmodel.fleet_member_bytes``: its folded pilot, under the
    control laws on ``protected_case``'s window grid, or the one this
    load plans); with no capacity, the reference's law."""
    if isinstance(ensemble, int):
        from isotope_tpu_torch.sim.ensemble import EnsembleSpec

        ensemble = EnsembleSpec.of(ensemble)
    report.extend(topo_lint.lint_ensemble(ensemble))
    attr = bool(sim.params.attribution)
    timeline = bool(sim.params.timeline) and not protected
    roll = getattr(sim, "_rollouts", None) is not None
    grid = None
    if protected or timeline:
        grid = (tuple(protected_case[0]) if protected_case is not None
                else _plan_windows(sim, load))
    sizes = None
    if est.capacity_bytes:
        control = None
        if protected:
            control = (grid, sim._policies is not None, roll)
        elif timeline:
            control = (grid, False, False)
        sizes = costmodel.fleet_member_bytes(
            sim, load, est.block_requests, control=control,
            blame=None if attr else False, jittered=ensemble.jittered,
        )
    carry = 0.0
    if protected:
        carry = costmodel.protected_carry_bytes(sim, grid[0], roll=roll)
        report.extend(costmodel.protected_ensemble_findings(
            est, ensemble.members, carry, member_bytes=sizes,
        ))
    else:
        report.extend(costmodel.ensemble_findings(
            est, ensemble.members, member_bytes=sizes,
        ))
    # an observed fleet stacks blame histograms and window series on
    # top of the event tensors; the protected carry above already
    # counts the recorder, so only attribution adds there
    obs_carry = 0.0
    if attr or timeline:
        obs_carry = costmodel.observability_carry_bytes(
            sim, attr=attr, timeline_windows=grid[0] if timeline else None,
        )
        report.extend(costmodel.observed_ensemble_findings(
            est, ensemble.members, obs_carry, base_carry_bytes=carry,
            member_bytes=sizes,
        ))
    # the chunk the engine picks (Simulator.ensemble_chunk_size /
    # protected_ensemble_chunk)
    report.meta["ensemble"] = {
        "members": ensemble.members,
        "protected": bool(protected),
        "chunk": costmodel.fleet_need(
            est, ensemble.members, 0.0 if sizes else carry + obs_carry,
            sizes,
        )[1],
    }
    if sizes is not None:
        report.meta["ensemble"]["member_bytes"] = sizes._asdict()


def _search_verdicts(report, sim, load, est, search_spec):
    """VET-T026, then VET-M005 and the widest rung's chunk."""
    from isotope_tpu_torch.sim.search import SearchSpec

    report.extend(topo_lint.lint_search(search_spec))
    if not isinstance(search_spec, SearchSpec):
        return
    widths = search_spec.rung_widths()
    conns = getattr(load, "connections", 0) or 0
    sizes = None
    if est.capacity_bytes:
        sizes = costmodel.fleet_member_bytes(
            sim, load, est.block_requests,
            jittered=search_spec.candidates.jittered,
        )
    report.extend(costmodel.search_findings(
        est, widths[0], connections=conns, member_bytes=sizes,
    ))
    report.meta["search"] = {
        "candidates": search_spec.members,
        "rungs": search_spec.rungs,
        "eta": search_spec.eta,
        "widths": list(widths),
        # the chunk the bracket picks (sim/search.search_auto_chunk)
        "chunk": costmodel.fleet_need(
            est, widths[0], costmodel.search_carry_bytes(conns), sizes,
        )[1],
    }


def vet_topology_path(
    path,
    *,
    load=None,
    entry: Optional[str] = None,
    trace: bool = True,
    device_bytes: Optional[float] = None,
    suppress=(),
    params=None,
    graph=None,
    grad: bool = False,
    device=None,
) -> Report:
    """Vet one topology YAML end to end (decode -> lint -> build ->
    pilot -> cost model).  Decode failures become findings instead of
    tracebacks — vet must not crash on the config it exists to judge.
    ``graph`` supplies an already-decoded ServiceGraph; ``device`` is
    where the Simulator is built (``cuda`` by default)."""
    import yaml

    from isotope_tpu_torch.models.graph import ServiceGraph

    report = Report(suppress=suppress)
    timings: dict = {}
    with _timed(timings, "lint"):
        if graph is None:
            try:
                graph = ServiceGraph.from_yaml_file(path)
            except (OSError, ValueError, yaml.YAMLError) as e:
                report.add(Finding(
                    "VET-C001", SEV_ERROR, str(e), path=str(path),
                ))
                _count(report)
                return report
        report.extend(topo_lint.lint_graph(graph, entry=entry,
                                           params=params))
    if report.errors:
        # graph-level errors (cycles, no entrypoint, unreachable
        # services) make the compiled program meaningless
        _count(report)
        return report

    from isotope_tpu_torch.sim.config import LoadModel

    if load is None:
        load = LoadModel(kind="open", qps=1000.0)
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.sim.config import SimParams
    from isotope_tpu_torch.sim.engine import Simulator

    with _timed(timings, "build"):
        sim = Simulator(
            compile_graph(graph, entry=entry),
            params if params is not None else SimParams(),
            device=device,
        )
    sub = vet_simulator(
        sim, load, graph=None, entry=entry, trace=trace,
        device_bytes=device_bytes, suppress=suppress, grad=grad,
    )
    # merge: sub already counted itself; move its findings over
    report.findings.extend(sub.findings)
    report.suppressed.extend(sub.suppressed)
    report.meta.update(sub.meta)
    sub_t = report.meta.get("timings_s", {})
    for k, v in timings.items():
        sub_t[k] = sub_t.get(k, 0.0) + v
    report.meta["timings_s"] = sub_t
    return report


def vet_config_path(
    config_path,
    *,
    trace: bool = True,
    device_bytes: Optional[float] = None,
    suppress=(),
    grad: bool = False,
    device=None,
) -> Report:
    """Vet a sweep TOML: config lint plus every referenced topology."""
    from isotope_tpu_torch.runner.config import load_toml

    report = Report(suppress=suppress)
    try:
        config = load_toml(config_path)
    except (OSError, ValueError) as e:
        report.add(Finding(
            "VET-C001", SEV_ERROR, str(e), path=str(config_path),
        ))
        _count(report)
        return report
    cfg_findings, graphs = topo_lint.lint_config(config)
    report.extend(cfg_findings)
    _count(report)
    for p, g in graphs.items():
        sub = vet_topology_path(
            p, entry=config.entry, trace=trace,
            device_bytes=device_bytes, suppress=suppress,
            params=config.sim_params(), graph=g, grad=grad,
            device=device,
        )
        report.findings.extend(sub.findings)
        report.suppressed.extend(sub.suppressed)
        if sub.meta:
            report.meta[str(p)] = sub.meta
    return report
