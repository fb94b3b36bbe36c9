"""The sweep driver: topology x environment x connections x qps.

The port of ``isotope_tpu.runner.run``.  It mirrors the shape of the
reference's drivers (run_tests.py:35-44 outer product; runner.py:522-525
conn x qps grid; fortio.py artifact formats) with compilation replacing
deployment and simulation replacing ``kubectl exec fortio load``.

Checkpoint/resume: every completed run appends one line to
``<out>/checkpoint.jsonl`` (after a header binding the config), and its
per-run artifacts are written immediately.  A killed sweep re-invoked
with the same config skips the completed prefix: case ``i`` draws from
``RootedSource(TorchDraws(seed), i)`` (the reference's ``fold_in(
PRNGKey(seed), i)``), with ``i`` counted over restored cases too, so
the resumed tail draws the streams the uninterrupted sweep would have,
and the final benchmark.csv is identical except the wall-clock
StartTime column.

Every case runs under the run supervisor (``resilience/``): transients
retry with backoff, an out-of-memory error walks the degradation ladder
(``scan`` -> ``half-block``, on the Simulator's own device), and an
unrecoverable case is recorded FAILED in the checkpoint while the sweep
goes on.  A sticky CUDA error is recorded FAILED too and then ends the
sweep: the CUDA context is lost, and the same command in a new process
resumes from the checkpoint.  A device mesh (``--mesh``, ``$ISOTOPE_MESH``,
``mesh_data`` / ``mesh_svc``; ``parallel/``) serves the plain, attributed
and recorded cases of a world of several ranks (``torchrun``): every
rank runs the sweep, only rank 0 writes (the results directory, the
CSV, the checkpoint, the documents and the console lines), and a
barrier ends the sweep.  Where the reference's diagnostic passes (attribution, the
fleet dispatch, the search bracket, splitting, the fleet explainer) are
best-effort, the port's fail the case: an error is recorded, never
swallowed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import sys
from typing import List, Optional, Sequence, Tuple

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.metrics.fortio import (
    DEFAULT_CSV_KEYS,
    WindowSummary,
    convert_data,
    fortio_result_from_summary,
    window_summary_from_summary,
    write_csv,
)
from isotope_tpu_torch.resilience import (
    ResiliencePolicy,
    call_with_retries,
    classify,
    execution_rungs,
    is_sticky_cuda_error,
    run_ladder,
)
from isotope_tpu_torch.resilience.supervisor import finish, rung_blocks
from isotope_tpu_torch.sim.config import OPEN_LOOP


@dataclasses.dataclass
class RunResult:
    label: str
    topology: str
    environment: str
    flat: dict                    # the reference's single-line schema
    window: WindowSummary
    fortio_json: dict
    prometheus_text: str
    # engine self-telemetry snapshot (RunTelemetry.to_dict()); None when
    # telemetry emission is off or the run was restored from checkpoint
    telemetry: Optional[dict] = None
    # which degradation-ladder rung served the run (None = undegraded)
    degraded_to: Optional[str] = None
    # unrecoverable failure: the case is recorded, the sweep continued
    failed: bool = False
    error: Optional[str] = None
    # critical-path blame (metrics/attribution.py): the blame.json doc,
    # the AttributionSummary, and the CompiledGraph its hop vectors
    # are indexed by; None when the attribution pass was off
    blame: Optional[dict] = None
    attribution: Optional[object] = None
    compiled: Optional[object] = None
    # flight-recorder windowed series (metrics/timeline.py): the
    # timeline.json doc and the TimelineSummary; None when off
    timeline: Optional[dict] = None
    timeline_summary: Optional[object] = None
    # resilience policies (sim/policies.py) and reactive canary
    # rollouts (sim/rollout.py) of the PROTECTED main run: the
    # documents and the summaries; None when the co-sim was off
    policies: Optional[dict] = None
    policies_summary: Optional[object] = None
    rollouts: Optional[dict] = None
    rollouts_summary: Optional[object] = None
    # load-balancing laws (sim/lb.py): the lb.json doc; None when the
    # topology declares no active lb entries
    lb: Optional[dict] = None
    # scenario ensembles (sim/ensemble.py): the isotope-ensemble/v2
    # doc and the EnsembleSummary; None when the ensemble axis was off
    ensemble: Optional[dict] = None
    ensemble_summary: Optional[object] = None
    # fleet divergence explainer (metrics/fleetblame.py); None when the
    # fleet carried no attribution
    fleet_blame: Optional[dict] = None
    # config search (sim/search.py): the isotope-search/v1 doc; None
    # when the [search] block was off
    search: Optional[dict] = None
    # the exception that failed the case (None when it ran)
    cause: Optional[BaseException] = dataclasses.field(
        default=None, repr=False, compare=False,
    )


def _failed_window(reason: str) -> WindowSummary:
    return WindowSummary(
        start_s=0.0, duration_s=0.0, count=0, qps=0.0,
        error_percent=100.0, discarded=True,
        discard_reason=f"run failed: {reason}",
        percentiles_us={}, cpu_cores={},
    )


def run_label(topo_path: str, env: str, load, extra: str = "") -> str:
    """The reference's run label: topology stem, environment, load, and
    the ``--labels`` suffix."""
    stem = pathlib.Path(topo_path).stem
    qps = "max" if load.qps is None else f"{load.qps:g}"
    base = f"{stem}_{env.lower()}_{qps}qps_{load.connections}c"
    return f"{base}_{extra}" if extra else base


def num_requests(load, capacity: float, cap: int) -> int:
    """Size the batch so the simulated run spans ``load.duration_s``."""
    rate = capacity if load.qps is None else min(load.qps, capacity)
    return max(1, min(int(rate * load.duration_s), cap))


def _case_source(config, index, device):
    """Case ``index``'s draws: ``RootedSource(TorchDraws(seed), index)``
    (the reference's ``fold_in(PRNGKey(seed), index)``); ``index`` may
    be a path (a fleet member's ``(index, seed)``).  ``TorchDraws`` is
    looked up when called, so a test can hand every case the
    reference's draws."""
    from isotope_tpu_torch import sim as sim_pkg
    from isotope_tpu_torch.sim.draws import RootedSource

    return RootedSource(sim_pkg.TorchDraws(config.seed, device), index)


def resolve_mesh_request(config):
    """The mesh request of a sweep: ``"auto"``, a ``MeshSpec``, or
    ``None`` (the legacy ``mesh_data`` / ``mesh_svc`` sizing).

    Priority: the config's explicit spec (CLI ``--mesh`` / TOML ``[sim]
    mesh``) > ``$ISOTOPE_MESH`` > the legacy keys.  Spec errors are
    key-pathed config errors raised here, before any simulation.
    """
    from isotope_tpu_torch.parallel.mesh import (
        mesh_spec_from_env,
        parse_mesh_spec,
    )

    if config.mesh_spec:
        return parse_mesh_spec(str(config.mesh_spec))
    return mesh_spec_from_env()


def _mesh_spec(config, mesh_req):
    """The factorization a sweep runs on: an explicit spec, else
    ``mesh_data`` x ``mesh_svc`` (``mesh_data`` 0 = the world's ranks
    over ``mesh_svc``), or ``"auto"``, which each topology resolves
    against its service count (:meth:`_LazyTopology.spec`).  A spec the
    world cannot hold, or a world whose devices do not divide over its
    hosts (``auto``), raises the key-pathed config error before
    anything simulates."""
    from isotope_tpu_torch.models.errors import config_path
    from isotope_tpu_torch.parallel.layout import enumerate_specs
    from isotope_tpu_torch.parallel.mesh import (
        MeshSpec,
        check_world,
        host_count,
        world_size,
    )

    if mesh_req == "auto":
        with config_path("mesh"):
            enumerate_specs(world_size(), 1, max_slices=host_count())
        return mesh_req
    if isinstance(mesh_req, MeshSpec):
        spec = mesh_req
    else:
        svc = max(config.mesh_svc, 1)
        data = (
            config.mesh_data if config.mesh_data > 0
            else max(world_size() // svc, 1)
        )
        spec = MeshSpec(data=data, svc=svc)
    if spec.size > 1:
        check_world(spec)
    return spec


def _vet_gate(mode: str, sim, topo, config, load, n, block, policy,
              ensemble=None, protected: bool = False,
              split_spec=None, search_spec=None, timeline=None) -> int:
    """The ``--vet`` pre-flight: lint + op audit + cost model for one
    case of ``n`` requests, on the Simulator the case runs on; the
    estimate is at the block the case runs (``block``, capped by ``n``:
    the reference estimates at ``block``).  A protected case (policy or
    rollout tables: ``protected``) runs its blocks at
    :func:`protected_window_block`'s size under its control laws, so its
    estimate is at that block, from protected pilots on its window grid
    (``timeline``: the ``--timeline`` width).

    Returns the ladder rung index the case should START on (the memory
    verdict's recommendation, 0 when everything fits).  Blocking
    findings raise :class:`~isotope_tpu_torch.analysis.VetError` — a
    deterministic failure the sweep records like any other, the case
    never running.  VET-M002 never blocks while the ladder is armed
    (the half-block start IS its recovery); VET-M001 always blocks:
    every rung of the port's ladder runs on the device."""
    from isotope_tpu_torch.analysis import (
        MEMORY_RULES,
        VetError,
        default_suppressions,
        vet_simulator,
    )
    from isotope_tpu_torch.sim.engine import block_rows

    rung_names = tuple(name for name, _ in rung_blocks(block))
    protected_case = None
    if protected:
        win, block = protected_window_block(
            sim, load, block, config.timeline_window_s, timeline
        )
        rate = load.qps if load.qps is not None else sim.capacity_qps()
        protected_case = (
            sim.plan_timeline_windows(n, rate, win),
            topo.rollout_tables is not None,
        )
    report = vet_simulator(
        sim, load, block_requests=block_rows(load, n, block),
        graph=topo.graph, entry=config.entry,
        suppress=default_suppressions(),
        rung_names=rung_names,
        ensemble=ensemble,
        protected=protected,
        split_spec=split_spec,
        search_spec=search_spec,
        protected_case=protected_case,
    )
    for f in report.sorted():
        print(f"vet: {f.render()}", file=sys.stderr)
    nonblocking = MEMORY_RULES if policy.degrade else ()
    if report.blocking(strict=(mode == "strict"),
                       nonblocking_rules=nonblocking):
        raise VetError(report, mode == "strict", nonblocking)
    est = report.meta.get("cost", {}).get("peak_bytes_at_block")
    if est:
        # published so the post-run measured/estimate ratio gauge can
        # calibrate CAPACITY_FILL from real runs
        telemetry.gauge_set("vet_peak_bytes_estimate", float(est))
    start = int(report.meta.get("start_rung", 0))
    if start:
        telemetry.counter_inc("vet_rung_preselections")
        telemetry.set_meta("vet_start_rung", rung_names[start])
        print(
            f"vet: memory verdict pre-selects ladder rung "
            f"{rung_names[start]!r}",
            file=sys.stderr,
        )
    return start


def _record_vet_memory_ratio() -> None:
    """Measured/estimated device-peak-bytes ratio gauge: pairs the
    VET-M cost-model estimate with the run's real high-water
    (``torch.cuda.max_memory_allocated`` since the last
    ``reset_peak_memory_stats``, ``telemetry.record_device_memory``) so
    ``CAPACITY_FILL`` can be calibrated from real runs."""
    est = telemetry.gauge_get("vet_peak_bytes_estimate")
    measured = telemetry.gauge_get("device_memory_peak_bytes_max")
    if est and measured:
        telemetry.gauge_set(
            "vet_peak_bytes_measured_ratio", measured / est
        )


class _LazyTopology:
    """Compile a topology (and build its simulators) only if some run of
    it actually executes — a fully-resumed topology costs nothing."""

    def __init__(self, topo_path: str, config, device=None,
                 mesh_spec=None):
        self.path = topo_path
        self.config = config
        self.device = device
        # the mesh the sweep runs on (a MeshSpec, size 1: no mesh; or
        # "auto", resolved by spec())
        self.mesh_spec = mesh_spec
        self.mesh_layout = None
        self.mesh_layout_score = None
        self._sharded = {}
        self._compiled = None
        self._collector = None
        self._entry_resp = 0.0
        self._graph = None
        self._sims = {}
        self._tables = {}

    @property
    def compiled(self):
        if self._compiled is None:
            from isotope_tpu_torch.compiler import compile_graph
            from isotope_tpu_torch.metrics.prometheus import (
                MetricsCollector,
            )
            from isotope_tpu_torch.models.graph import ServiceGraph

            graph = ServiceGraph.from_yaml_file(self.path)
            self._graph = graph
            self._compiled = compile_graph(graph, entry=self.config.entry)
            self._entry_resp = float(
                self._compiled.services.response_size[
                    self._compiled.entry_service
                ]
            )
            self._collector = MetricsCollector(self._compiled)
        return self._compiled

    @property
    def graph(self):
        self.compiled
        return self._graph

    @property
    def collector(self):
        self.compiled
        return self._collector

    @property
    def entry_response_size(self) -> float:
        self.compiled
        return self._entry_resp

    def _table(self, name: str, armed: bool):
        if name not in self._tables:
            self._tables[name] = None
            if armed:
                from isotope_tpu_torch import compiler

                build = getattr(compiler, f"compile_{name}")
                self._tables[name] = build(self.graph, self.compiled)
        return self._tables[name]

    @property
    def policy_tables(self):
        """Compiled resilience-policy tables (sim/policies.py), or
        None when the topology declares none or the config leaves the
        co-sim off."""
        return self._table("policies", self.config.policies)

    @property
    def rollout_tables(self):
        """Compiled progressive-delivery tables (sim/rollout.py), or
        None when the topology declares no active rollout or the config
        leaves the co-sim off."""
        return self._table("rollouts", self.config.rollouts)

    @property
    def lb_tables(self):
        """Compiled load-balancing tables (sim/lb.py), or None when the
        topology declares no ``lb:`` entries.  No config gate: a
        declared lb law IS the data plane being measured, on every run
        kind."""
        return self._table("lb", True)

    def sims(self, env):
        """The Simulator of an environment, built on first use."""
        if env.name not in self._sims:
            from isotope_tpu_torch.sim import Simulator

            params = env.apply(self.config.sim_params())
            self._sims[env.name] = Simulator(
                self.compiled, params, self.config.chaos,
                self.config.churn, mtls=self.config.mtls,
                policies=self.policy_tables, rollouts=self.rollout_tables,
                lb=self.lb_tables, device=self.device,
            )
        return self._sims[env.name]

    def spec(self):
        """The sweep's factorization for this topology: ``"auto"`` runs
        the layout search (``parallel/layout.py``) over the world's
        devices and hosts against the compiled service count, once."""
        if self.mesh_spec == "auto":
            from isotope_tpu_torch.parallel.layout import choose_layout
            from isotope_tpu_torch.parallel.mesh import (
                host_count,
                world_size,
            )

            chosen = choose_layout(world_size(), self.compiled.num_services,
                                   max_slices=host_count())
            self.mesh_spec = chosen.spec
            self.mesh_layout_score = chosen.score_s
            print(f"mesh auto: {self.path} -> {chosen.spec.describe()} "
                  f"(score {chosen.score_s:.3g}s/merge)", file=sys.stderr)
        return self.mesh_spec

    def sharded(self, env):
        """The environment's ``ShardedSimulator`` over the sweep's mesh
        (sharing :meth:`sims`' Simulator), or None when the mesh has
        one rank."""
        spec = self.spec()
        if spec is None or spec.size == 1:
            return None
        if env.name not in self._sharded:
            from isotope_tpu_torch.parallel import (
                ShardedSimulator,
                build_mesh,
            )

            sim = self.sims(env)
            self._sharded[env.name] = ShardedSimulator(
                self.compiled,
                build_mesh(spec, device=sim.device.type),
                sim=sim,
            )
            self.mesh_layout = spec.describe()
        return self._sharded[env.name]


class _EnsembleGroups:
    """Same-shape case collapse for ensemble sweeps (sim/ensemble.py).

    Grid cells of one (topology, environment) that share the load KIND,
    connection count, and computed run shape (request count + block)
    run the same fleet program, so their fleets pack into ONE dispatch:
    members of cell i draw from ``(index_i, seed)`` under the sweep's
    seed (the reference's ``fold_in(fold_in(seed_key, run_index_i),
    seed)``, the checkpoint-resume law, so a collapsed cell's members
    equal its uncollapsed dispatch's) with each cell's exact target qps
    riding ``member_qps``.  Typical win: a qps grid capped by
    ``num_requests`` — every cell past the cap has the same shape and
    the whole loop collapses.

    Results are cached per label; cells reached later in the sweep
    loop read their slice instead of re-dispatching.
    """

    def __init__(self, config, spec, cells, completed):
        self.config = config
        self.spec = spec          # the per-cell EnsembleSpec
        self.cells = cells        # [{"topo","env","label","load","idx"}]
        self.completed = set(completed)
        self.results: dict = {}   # label -> per-cell EnsembleSummary

    def _group_for(self, label, topo_path, env_name, load, sim, n):
        """The cells that can ride this dispatch (self included)."""
        me = [c for c in self.cells if c["label"] == label]
        if load.kind != OPEN_LOOP or load.qps is None:
            # closed-loop rate solves are per-cell host pilots; keep
            # those cells on their own (still one fleet per cell)
            return me
        cap = sim.capacity_qps()
        group = [
            c for c in self.cells
            if c["topo"] == topo_path
            and c["env"] == env_name
            and c["label"] not in self.completed
            and c["load"].kind == load.kind
            and c["load"].connections == load.connections
            and c["load"].qps is not None
            and num_requests(c["load"], cap, self.config.num_requests) == n
        ]
        return group if any(c["label"] == label for c in group) else me

    def _dispatch(self, label, topo_path, env_name, load, sim, n, control):
        """``(group, member sources, member qps, group spec)`` of this
        cell's dispatch; ``control`` puts each cell's member 0 on the
        cell's own draws (a protected fleet's control member)."""
        import numpy as np

        from isotope_tpu_torch.sim.ensemble import EnsembleSpec

        spec = self.spec
        group = self._group_for(label, topo_path, env_name, load, sim, n)
        member_keys, member_qps = [], []
        seed_scale = (
            spec.qps_scale if spec.qps_scale is not None
            else np.ones(spec.members)
        )
        for c in group:
            if control:
                member_keys.append(
                    _case_source(self.config, c["idx"], sim.device)
                )
            member_keys.extend(
                _case_source(self.config, (c["idx"], int(s)), sim.device)
                for s in spec.seeds[1 if control else 0:]
            )
            if c["load"].qps is not None:
                member_qps.extend(float(c["load"].qps) * seed_scale)
        if len(group) == 1:
            group_spec = spec
            qps_arg = None if load.qps is None else np.asarray(member_qps)
        else:
            # qps jitter folds into the exact per-member rates; the
            # physics jitters tile per cell
            group_spec = EnsembleSpec(
                seeds=tuple(range(len(member_keys))),
                cpu_scale=(
                    np.tile(spec.cpu_scale, len(group))
                    if spec.cpu_scale is not None else None
                ),
                error_scale=(
                    np.tile(spec.error_scale, len(group))
                    if spec.error_scale is not None else None
                ),
                mode=spec.mode,
            )
            qps_arg = np.asarray(member_qps)
        return group, member_keys, qps_arg, group_spec

    def _serve(self, label, group, ens, member_chaos=None):
        """Slice the group's fleet into per-cell summaries."""
        from isotope_tpu_torch.sim.ensemble import EnsembleSummary, tree_map

        n_seeds = self.spec.members
        # served cells leave the grouping pool: a later cell's group
        # must never re-dispatch members whose results already landed
        self.completed.update(c["label"] for c in group)
        for i, c in enumerate(group):
            sl = slice(i * n_seeds, (i + 1) * n_seeds)

            def cell(stacked, sl=sl):
                return tree_map(lambda x: x[sl], stacked)

            self.results[c["label"]] = EnsembleSummary(
                spec=self.spec,
                summaries=cell(ens.summaries),
                offered_qps=ens.offered_qps[sl],
                chunk=ens.chunk,
                member_chaos=(
                    None if member_chaos is None else member_chaos[sl]
                ),
                timelines=cell(ens.timelines),
                policies=cell(ens.policies),
                rollouts=cell(ens.rollouts),
                attributions=cell(ens.attributions),
            )
        if len(group) > 1:
            telemetry.counter_inc("ensemble_group_dispatches")
            telemetry.gauge_set("ensemble_group_cells", len(group))
            print(
                f"ensemble: collapsed {len(group)} same-shape "
                f"{'protected ' if ens.protected else ''}case(s) "
                f"({len(group) * n_seeds} members) into one dispatch",
                file=sys.stderr,
            )
        return self.results.pop(label)

    def run(self, label, topo_path, env_name, load, sim, n, block,
            attribution=None, timeline=None, sharded=None):
        """This cell's EnsembleSummary (dispatching its whole same-shape
        group on first touch).  ``attribution`` (``"on"`` / ``"tail"``)
        and ``timeline`` (a window width) thread the fleet observability
        pass through the SAME dispatch; ``sharded`` (a
        ``ShardedSimulator``) spreads the fleet's members over its
        mesh."""
        if label in self.results:
            telemetry.counter_inc("ensemble_collapsed_cases")
            return self.results.pop(label)
        group, keys, qps_arg, group_spec = self._dispatch(
            label, topo_path, env_name, load, sim, n, control=False,
        )
        obs_kw = {}
        if attribution is not None:
            obs_kw.update(attribution=True, tail=attribution == "tail")
        if timeline is not None:
            obs_kw.update(timeline=True, window_s=float(timeline))
        ens = (sharded or sim).run_ensemble(
            load, n, _case_source(self.config, group[0]["idx"], sim.device),
            group_spec, block_size=block, trim=True, member_keys=keys,
            member_qps=qps_arg, **obs_kw,
        )
        return self._serve(label, group, ens)

    def run_protected(self, label, topo_path, env_name, load, sim, n,
                      block, roll: bool, chaos_jitter, attribution=None,
                      timeline=None, sharded=None):
        """The same-shape collapse extended to PROTECTED fleets: grid
        cells whose policy/rollout fleets share a shape ride ONE
        ``run_policies_ensemble`` / ``run_rollouts_ensemble`` dispatch.
        Each cell keeps its control member on the cell's own draws (and,
        under ``chaos_jitter``, the solo chaos schedule), so a collapsed
        cell's members equal its uncollapsed dispatch's."""
        if label in self.results:
            telemetry.counter_inc("ensemble_collapsed_cases")
            return self.results.pop(label)
        spec = self.spec
        group, keys, qps_arg, group_spec = self._dispatch(
            label, topo_path, env_name, load, sim, n, control=True,
        )
        win, blk = protected_window_block(
            sim, load, block, self.config.timeline_window_s, timeline
        )
        member_chaos = None
        if chaos_jitter is not None and tuple(sim._chaos_events):
            from isotope_tpu_torch.resilience import faults

            base_events = tuple(sim._chaos_events)
            reps = sim.compiled.services.replicas_by_name()
            member_chaos = ([base_events] + [
                faults.jitter_chaos_events(
                    base_events, chaos_jitter,
                    faults.member_event_seeds(chaos_jitter, s,
                                              len(base_events)),
                    reps,
                )
                for s in spec.seeds[1:]
            ]) * len(group)
        runner = sharded or sim
        method = (
            runner.run_rollouts_ensemble if roll
            else runner.run_policies_ensemble
        )
        obs_kw = {}
        if attribution is not None:
            obs_kw = dict(attribution=True, tail=attribution == "tail")
        with telemetry.phase("ensemble.run"):
            ens = method(
                load, n,
                _case_source(self.config, group[0]["idx"], sim.device),
                group_spec, block_size=blk, trim=True, window_s=win,
                member_keys=keys, member_qps=qps_arg,
                member_chaos=member_chaos, **obs_kw,
            )
        telemetry.counter_inc("protected_fleet_cases")
        return self._serve(label, group, ens, member_chaos)


def _config_fingerprint(config) -> str:
    """Config identity for resume: the dataclass repr plus a hash of
    each topology file's bytes — editing a topology YAML must
    invalidate the checkpoint, not silently replay stale results."""
    h = hashlib.sha256()
    for p in config.topology_paths:
        try:
            h.update(pathlib.Path(p).read_bytes())
        except OSError:
            h.update(b"<missing>")
    return f"{config!r}#topos={h.hexdigest()[:16]}"


def _load_checkpoint(path: pathlib.Path, fingerprint: str) -> List[dict]:
    """Trustworthy records, or [] when absent/config-mismatched.

    A corrupted or truncated line (a kill mid-append, disk trouble) is
    QUARANTINED — skipped and counted — instead of invalidating
    everything after it: records are self-contained and matched by
    label, so one bad line costs exactly one re-run.  Failure records
    (``"failed": true``) are loaded too; the resume loop re-executes
    those cases.
    """
    if not path.exists():
        return []
    lines = path.read_text().splitlines()
    if not lines:
        return []
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError:
        return []
    if header.get("config") != fingerprint:
        return []
    records = []
    for i, line in enumerate(lines[1:], 2):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            telemetry.counter_inc("checkpoint_quarantined_records")
            print(
                f"warning: quarantined corrupt checkpoint record "
                f"{path}:{i} (its run will re-execute)",
                file=sys.stderr,
            )
            continue
        if not isinstance(rec, dict) or "label" not in rec:
            telemetry.counter_inc("checkpoint_quarantined_records")
            continue
        records.append(rec)
    return records


def _restore_result(rec: dict, out: pathlib.Path) -> RunResult:
    prom_path = out / f"{rec['label']}.prom"
    return RunResult(
        label=rec["label"],
        topology=rec["topology"],
        environment=rec["environment"],
        flat=rec["flat"],
        window=WindowSummary(**rec["window"]),
        fortio_json=rec["fortio_json"],
        prometheus_text=(
            prom_path.read_text() if prom_path.exists() else ""
        ),
        degraded_to=rec.get("degraded_to"),
    )


def _timeline_pass(run_timeline, load, n, source, block, window_s):
    """The timeline pass of one case: the main run's draws and blocking,
    reduced to the windowed series on the device (a failure fails the
    case).  ``run_timeline`` is the Simulator's, the mesh's
    (``ShardedSimulator.run_timeline``) or, when the ``single-device``
    rung served a mesh case, its emulated twin's."""
    with telemetry.phase("timeline.pass"):
        _, tl = run_timeline(load, n, source, block_size=block, trim=True,
                             window_s=window_s)
    telemetry.counter_inc("timeline_passes")
    return tl


def protected_window_block(sim, load, block: int,
                           timeline_window_s: float,
                           timeline=None, shards: int = 1
                           ) -> Tuple[float, int]:
    """The protected runs' ``(window_s, block)``: the control loops act
    at block boundaries, so the block is capped near ONE recorder window
    of requests (the default memory-sized block would give a whole-run
    actuation lag).  Without an explicit ``--timeline`` width the window
    is ``min(timeline_window_s, duration / 8)``, so a run spans at least
    ~8 windows: a window that never completes is a control loop that
    never observes.  ``shards`` is a mesh run's shard count: each shard
    runs ``1 / shards`` of the window's requests a block, so the mesh
    still acts once a window.  The fleets pass 1: a member is a solo
    run."""
    if timeline is not None:
        win = float(timeline)
    else:
        win = min(timeline_window_s, max(load.duration_s / 8.0, 1e-3))
    rate = load.qps if load.qps is not None else sim.capacity_qps()
    return win, max(
        256, min(block, int(max(rate * win / max(shards, 1), 1.0)))
    )


def _protected_run(sim, load, n, source, block, config, collector, policy,
                   timeline, roll: bool, attribution=None, sharded=None):
    """The protected co-sim main run of one case (sim/policies.py and/or
    sim/rollout.py): the PROTECTED physics is the measurement, so this
    replaces the plain ladder run.  Failures walk the ladder's rungs
    (:func:`rung_blocks`) with ``degraded_to`` recorded: a half-block
    protected run is a DIFFERENT measurement, since the control loops
    actuate at block boundaries and halving the block halves the
    actuation lag.
    ``attribution`` reduces the blame over the protected physics in the
    same loop (same draws, blocking and trajectory).

    ``sharded`` (a ``ShardedSimulator`` with ``svc = 1``) serves the run
    on its mesh, the block sized a shard (:func:`protected_window_block`
    with its shard count), on the rungs ``sharded``,
    ``sharded-half-block`` and ``single-device`` (the lockstep twin on
    this rank's device).  A svc-sharded mesh splits the per-service
    layout the replicated control state needs: the case runs on one
    device, with the reference's warning.

    Returns ``(summary, timeline, roll_summary | None, pol_summary |
    None, attr_summary | None, degraded_to | None)``."""
    runner = sharded if sharded is not None and sharded.n_svc == 1 else sim
    if sharded is not None and runner is sim:
        print(
            "warning: the protected co-sim falls back to the single-device "
            "scan (the svc-sharded mesh splits the per-service metric "
            "layout the replicated control state needs; use svc=1)",
            file=sys.stderr,
        )
    name = "run_rollouts" if roll else "run_policies"
    win, block = protected_window_block(
        sim, load, block, config.timeline_window_s, timeline,
        shards=getattr(runner, "n_shards", 1),
    )
    kwargs = dict(trim=True, window_s=win)
    if runner is sim:
        # the sharded runner summarizes with its own collector
        kwargs["collector"] = collector
    if attribution is not None:
        kwargs.update(attribution=True, tail=attribution == "tail")
    (_, full), (_, half) = rung_blocks(block)
    if runner is sim:
        specs = [(r, b, name) for r, b in rung_blocks(block)]
    else:
        specs = [("sharded", full, name), ("sharded-half-block", half, name),
                 ("single-device", full, name + "_emulated")]

    def rung(b, method):
        def thunk():
            out = getattr(runner, method)(load, n, source, block_size=b,
                                          **kwargs)
            finish(out[0])
            return out
        return thunk

    with telemetry.phase(f"{'rollouts' if roll else 'policies'}.run"):
        out, degraded_to = run_ladder(
            [(r, rung(b, method)) for r, b, method in specs],
            policy, site_prefix="engine",
        )
    telemetry.counter_inc(f"{'rollout' if roll else 'policy'}_main_runs")
    # run_rollouts -> (summary, tl, roll[, pol][, attr]);
    # run_policies -> (summary, tl, pol[, attr])
    rest = list(out[2:])
    attr = rest.pop() if attribution is not None else None
    roll_main = rest.pop(0) if roll else None
    pol_main = rest.pop(0) if rest else None
    return out[0], out[1], roll_main, pol_main, attr, degraded_to


def splitting_pass(sim, load, n: int, source, block: int, split,
                   protected: bool = False, roll: bool = False,
                   timeline_window_s: float = 10.0, timeline=None,
                   chaos_jitter=None, sharded=None) -> dict:
    """The importance-splitting estimate of one fleet-served case
    (``sim/splitting.py``, the reference's ``_splitting_pass``): one
    SHORT-HORIZON fleet a level (``max(256, int(n * split.horizon))``
    requests a member), members ranked by ``split``'s severity, the
    worst quantile cloned with redrawn seeds.  The fleets draw from a
    lane of their own, member ``w`` under ``RootedSource(source,
    SPLIT_INDEX)`` extended by ``w`` (the reference's ``fold_in(
    fold_in(run_key, 777_000_001), w)``).  A protected case runs
    ``run_policies_ensemble`` / ``run_rollouts_ensemble`` (``roll``) on
    its window and block (:func:`protected_window_block`); under the
    Simulator's chaos schedule and ``chaos_jitter`` each member's
    schedule is jittered from its chaos seeds.  ``sharded`` (a
    ``ShardedSimulator``) runs each level's fleet over its mesh.
    Returns the ``isotope-splitting/v1`` document.  Unlike the
    reference's best-effort pass, a failure raises."""
    import numpy as np

    from isotope_tpu_torch.sim import splitting as split_mod
    from isotope_tpu_torch.sim.draws import SPLIT_INDEX, RootedSource
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    n_short = max(256, int(n * split.horizon))
    chaos = tuple(sim._chaos_events)
    jitter = chaos_jitter if chaos else None
    base = RootedSource(source, SPLIT_INDEX)
    kwargs = {}
    blk = block
    runner = sharded or sim
    if protected:
        win, blk = protected_window_block(sim, load, block,
                                          timeline_window_s, timeline)
        method = (
            runner.run_rollouts_ensemble if roll
            else runner.run_policies_ensemble
        )
        kwargs["window_s"] = win
    else:
        method = runner.run_ensemble
    if jitter is not None:
        from isotope_tpu_torch.resilience import faults

        reps = sim.compiled.services.replicas_by_name()

    def evaluate(chaos_seeds, work_seeds):
        espec = EnsembleSpec.of(len(work_seeds))
        mkeys = [RootedSource(base, int(w)) for w in work_seeds]
        mc = None
        if jitter is not None:
            mc = [
                faults.jitter_chaos_events(chaos, jitter, row, reps)
                for row in np.asarray(chaos_seeds)
            ]
        out = method(
            load, n_short, base, espec, block_size=blk, trim=False,
            member_keys=mkeys, member_chaos=mc, **kwargs,
        )
        return split_mod.severity_scores(split, out.summaries,
                                         out.timelines)

    with telemetry.phase("splitting.pass"):
        doc = split_mod.subset_estimate(
            evaluate, split, chaos_components=max(len(chaos), 1),
        )
    telemetry.counter_inc("splitting_passes")
    return doc


def _member_stamp(ens, worst: int, protected: bool) -> dict:
    """The stamp naming a fleet's worst member in its documents, so a
    rare failure the fleet found replays solo.  A protected fleet's
    member 0 is the CONTROL member: it rides the run's own draws."""
    if not protected:
        return {"member": int(worst),
                "member_seed": int(ens.spec.seeds[worst]),
                "fleet_members": ens.members, "worst_member": True}
    stamp = {
        "member": int(worst),
        "member_seed": None if worst == 0 else int(ens.spec.seeds[worst]),
        "member_key": (
            "run_key" if worst == 0 else "fold_in(run_key, member_seed)"
        ),
        "fleet_members": ens.members,
        "worst_member": True,
    }
    if ens.member_chaos is not None:
        stamp["member_chaos"] = [
            {"service": ev.service, "start_s": float(ev.start_s),
             "end_s": float(ev.end_s), "replicas_down": ev.replicas_down,
             "drain": ev.drain}
            for ev in ens.member_chaos[worst]
        ]
    return stamp


@dataclasses.dataclass
class _Case:
    """One executed case's run and outputs on their way to a RunResult."""

    sim: object = None
    n: int = 0
    block: int = 0
    source: object = None
    summary: object = None
    degraded_to: Optional[str] = None
    ens: object = None        # the cell's EnsembleSummary (fleet-served)
    prot_fleet: bool = False
    attr: object = None       # the served (or worst member's) blame
    tl: object = None         # ... timeline
    pol: object = None        # ... policy and rollout series
    roll: object = None
    mesh_layout: Optional[str] = None  # the mesh that served the case
    sharded: object = None    # its ShardedSimulator


def _execute(case: _Case, topo, env, load, config, index, policy,
             ens_groups, attribution, timeline, label, vet=None,
             search_spec=None) -> None:
    """Build and run one case under the supervisor, filling ``case``:
    the vet gate first when armed (``vet``), whose memory verdict may
    start the plain ladder at a later rung (recorded as degraded, as a
    ladder descent would be).  A memory-degraded fleet, plain or
    protected, gives way to the solo run (a protected one keeps its
    own ladder), as in the reference: even a one-member chunk runs the
    full block."""
    sim = call_with_retries(lambda: topo.sims(env), site="engine.build",
                            policy=policy)
    sharded = call_with_retries(lambda: topo.sharded(env),
                                site="engine.build", policy=policy)
    n = num_requests(load, sim.capacity_qps(), config.num_requests)
    block = sim.default_block_size()
    source = _case_source(config, index, sim.device)
    protected = (
        topo.policy_tables is not None or topo.rollout_tables is not None
    )
    roll = topo.rollout_tables is not None
    case.sim, case.n, case.block, case.source = sim, n, block, source
    # the mesh serves the case where the reference's does: open loops,
    # and closed loops whose connections divide over the shards
    if sharded is not None and (
        load.kind == OPEN_LOOP
        or load.connections % sharded.n_shards == 0
    ):
        case.mesh_layout = topo.mesh_layout
    else:
        sharded = None
    case.sharded = sharded
    start_rung = 0
    if vet is not None:
        start_rung = _vet_gate(
            vet, sim, topo, config, load, n, block, policy,
            ensemble=config.ensemble_spec() if ens_groups is not None
            else None,
            protected=protected,
            split_spec=config.ensemble_split,
            search_spec=search_spec,
            timeline=timeline,
        )
    if protected and ens_groups is not None and start_rung == 0:
        # a PROTECTED fleet: member 0 rides the run's own draws (its
        # solo protected run), the worst member's series are the case's
        ens = ens_groups.run_protected(
            label, topo.path, env.name, load, sim, n, block, roll,
            config.chaos_jitter_spec(), attribution=attribution,
            timeline=timeline, sharded=sharded,
        )
        case.ens, case.prot_fleet = ens, True
        worst = ens.worst_member()
        case.summary = ens.pooled()
        case.tl = ens.member_timeline(worst)
        if ens.policies is not None:
            case.pol = ens.member_policies(worst)
        if ens.rollouts is not None:
            case.roll = ens.member_rollouts(worst)
        if ens.attributions is not None:
            case.attr = ens.member_attribution(worst)
    elif protected:
        (case.summary, case.tl, case.roll, case.pol, case.attr,
         case.degraded_to) = _protected_run(
            sim, load, n, source, block, config, topo.collector, policy,
            timeline, roll, attribution=attribution, sharded=sharded,
        )
    elif ens_groups is not None and start_rung == 0:
        # a Monte Carlo fleet serves the case (same-shape cells collapse
        # into one dispatch); the reported summary pools the members
        with telemetry.phase("ensemble.run"):
            case.ens = ens_groups.run(
                label, topo.path, env.name, load, sim, n, block,
                attribution=attribution, timeline=timeline,
                sharded=sharded,
            )
        ens = case.ens
        case.summary = ens.pooled()
        # an observed fleet's worst member's series are the case's
        if ens.timelines is not None:
            case.tl = ens.member_timeline(ens.worst_member())
        if ens.attributions is not None:
            case.attr = ens.member_attribution(ens.worst_member())
    else:
        rungs = execution_rungs(sim, load, n, source, block,
                                collector=topo.collector, trim=True,
                                attribution=attribution, sharded=sharded)
        (case.summary, case.attr), case.degraded_to = run_ladder(
            rungs[start_rung:], policy, site_prefix="engine",
        )
        if start_rung and case.degraded_to is None:
            # the pre-selected rung IS a degradation: recorded exactly
            # as a ladder descent would be
            case.degraded_to = rungs[start_rung][0]
            telemetry.set_meta("degraded_to", case.degraded_to)
        if timeline is not None:
            # the recorder pass replays the rung that served the run
            run_tl, block = _timeline_rung(sim, sharded, block,
                                           case.degraded_to)
            case.tl = _timeline_pass(run_tl, load, n, source, block,
                                     timeline)
    if case.ens is not None:
        telemetry.counter_inc("ensemble_cases")
        telemetry.set_meta("ensemble", str(case.ens.members))


def _timeline_rung(sim, sharded, block: int, degraded_to):
    """``(run_timeline, block)`` replaying the ladder rung that served
    a case: the Simulator's at that rung's block, or on a mesh its
    collective run (``sharded``, ``sharded-half-block``) or its
    emulated twin (``single-device``)."""
    blocks = dict(rung_blocks(block))
    if sharded is None:
        return sim.run_timeline, blocks[degraded_to or "scan"]
    if degraded_to == "single-device":
        return sharded.run_timeline_emulated, block
    if degraded_to == "sharded-half-block":
        return sharded.run_timeline, blocks["half-block"]
    return sharded.run_timeline, block


def _documents(case: _Case, topo, label, config, load, attribution,
               timeline, search_spec):
    """The case's documents and flat row.  Returns ``(doc, flat, window,
    extra)``, ``extra`` mapping artifact suffixes to documents."""
    from isotope_tpu_torch.metrics import attribution as attr_mod
    from isotope_tpu_torch.metrics import timeline as timeline_mod

    ens, compiled = case.ens, topo.compiled
    protected = case.pol is not None or case.roll is not None
    extra = {}
    stamp = None
    if ens is not None and (case.prot_fleet or ens.timelines is not None
                            or ens.attributions is not None):
        stamp = _member_stamp(ens, ens.worst_member(), case.prot_fleet)
    if case.attr is not None:
        extra["blame"] = attr_mod.to_doc(compiled, case.attr)
    if case.tl is not None:
        extra["timeline"] = timeline_mod.to_doc(compiled, case.tl)
    if case.pol is not None:
        from isotope_tpu_torch.sim import policies as policies_mod

        extra["policies"] = policies_mod.to_doc(compiled, case.pol,
                                                topo.policy_tables)
    if case.roll is not None:
        from isotope_tpu_torch.sim import rollout as rollout_mod

        extra["rollout"] = rollout_mod.to_doc(compiled, case.roll,
                                              topo.rollout_tables)
    if stamp is not None:
        for d in extra.values():
            d.update(stamp)
    if topo.lb_tables is not None and topo.lb_tables.active:
        # ACTIVE laws only: an all-fifo block is the plain M/M/k path
        from isotope_tpu_torch.sim import lb as lb_mod

        extra["lb"] = lb_mod.to_doc(topo.lb_tables, tl=case.tl,
                                    pol=case.pol)
    summary = case.summary
    doc = fortio_result_from_summary(
        summary, load, labels=label,
        response_size_bytes=topo.entry_response_size,
    )
    if ens is not None:
        # the pooled count spans N member runs of one duration each:
        # the rate is per member, as RequestedQPS is (counts pooled)
        doc["ActualQPS"] /= ens.members
    flat = convert_data(doc)
    window = window_summary_from_summary(
        summary, service_names=compiled.services.names,
        replicas=compiled.services.replicas,
    )
    if ens is not None:
        window = dataclasses.replace(window, qps=window.qps / ens.members)
    flat["windowDiscarded"] = window.discarded
    if case.mesh_layout is not None:
        # the factorization that served the case is run METADATA (like
        # degraded_to): a record made on another layout is another
        # measurement
        flat["_mesh_layout"] = case.mesh_layout
        telemetry.set_meta("mesh_layout", case.mesh_layout)
    if case.degraded_to is not None:
        # degradation is run METADATA: a row off a fallback rung says so
        flat["degraded_to"] = case.degraded_to
    if "policies" in extra:
        flat["_policies"] = True
        telemetry.set_meta("policies", "on")
    if "rollout" in extra:
        flat["_rollout"] = True
        telemetry.set_meta("rollouts", "on")
    if "lb" in extra:
        flat["_lb"] = True
        telemetry.set_meta("lb", "on")
    if config.ingest:
        flat["_ingest"] = str(config.ingest.get("label", "ingested"))
        telemetry.set_meta("ingest", flat["_ingest"])
    if ens is not None:
        split_doc = None
        if config.ensemble_split:
            split_doc = splitting_pass(
                case.sim, load, case.n, case.source, case.block,
                config.split_spec(), protected=protected,
                roll=case.roll is not None,
                timeline_window_s=config.timeline_window_s,
                timeline=timeline, chaos_jitter=config.chaos_jitter_spec(),
                sharded=case.sharded,
            )
        ens_doc = ens.to_doc(label=label, slo_s=config.ensemble_slo_s,
                             splitting=split_doc)
        flat["_ensemble"] = ens.members
        if case.prot_fleet:
            flat["_protected_fleet"] = True
            if ens_doc.get("worst_member") == 0:
                # the control member rides the run's own draws
                ens_doc["worst_member_seed"] = None
        extra["ensemble"] = ens_doc
        if ens.attributions is not None:
            from isotope_tpu_torch.metrics import fleetblame

            win_s = None
            if ens.timelines is not None:
                win_s = float(ens.timelines.window_s.reshape(-1)[0])
            extra["fleet-blame"] = fleetblame.to_doc(
                compiled, ens.attributions, ens.timelines, label=label,
                severity=ens.severity(), seeds=ens.spec.seeds,
                window_s=win_s,
            )
            flat["_fleet_blame"] = True
            telemetry.counter_inc("fleet_blame_docs")
    if search_spec is not None and not protected:
        # the bracket screens perturbations of THIS case on its own
        # draw lane (the reference's fold_in(run_key, 911)), so the
        # measurement above is untouched
        from isotope_tpu_torch.sim.draws import RootedSource

        with telemetry.phase("search.run"):
            srch = (case.sharded or case.sim).run_search(
                load, case.n, RootedSource(case.source, 911), search_spec,
                block_size=case.block,
            )
        extra["search"] = srch.to_doc(label)
        flat["_search"] = search_spec.members
        telemetry.counter_inc("search_cases")
        telemetry.set_meta("search", str(search_spec.members))
    flat.update({
        "cpu_cores_" + name: round(v, 4)
        for name, v in window.cpu_cores.items()
    })
    return doc, flat, window, extra


def _write_artifacts(out: pathlib.Path, result: RunResult, extra: dict,
                     run_telem) -> None:
    label = result.label
    with open(out / f"{label}.json", "w") as f:
        json.dump(result.fortio_json, f, indent=2)
    (out / f"{label}.prom").write_text(result.prometheus_text)
    for suffix in ("blame", "timeline", "policies", "rollout", "lb",
                   "ensemble", "fleet-blame", "search"):
        if extra.get(suffix) is not None:
            with open(out / f"{label}.{suffix}.json", "w") as f:
                json.dump(extra[suffix], f, indent=2)
    if result.attribution is not None:
        from isotope_tpu_torch.metrics.export import write_flamegraph

        write_flamegraph(out / f"{label}.flame.txt", result.compiled,
                         result.attribution)
    if run_telem is not None:
        run_telem.append_jsonl(out / "telemetry.jsonl")


def run_experiment(
    config,
    out_dir: Optional[str] = None,
    progress=None,
    resume: bool = True,
    profile_dir: Optional[str] = None,
    export: Sequence[str] = (),
    policy: Optional[ResiliencePolicy] = None,
    vet: Optional[str] = None,
    attribution: Optional[str] = None,
    timeline: Optional[float] = None,
    device=None,
) -> List[RunResult]:
    """Run every case of ``config``'s grid on ``device`` (``cuda`` by
    default).

    ``profile_dir`` captures a ``torch.profiler`` trace per executed run
    into ``<profile_dir>/<label>/trace.json`` (Chrome trace format) —
    the analogue of the reference's per-run ``perf record`` flame
    capture (runner.py:405-417).  ``export`` lists exporter specs (e.g.
    ``bigquery:proj.ds.table``) run over the collected results after the
    CSV is written — the collector's upload hook (fortio.py:235-242).

    Every device-touching phase runs under the resilience supervisor
    (``policy``; default from ``ISOTOPE_MAX_RETRIES`` /
    ``ISOTOPE_NO_DEGRADE``): transients retry with backoff, OOM walks
    the degradation ladder, and an unrecoverable case is recorded as
    FAILED in the checkpoint while the sweep continues — resume retries
    failed cases and never re-runs completed ones.  A sticky CUDA error
    (:func:`~isotope_tpu_torch.resilience.is_sticky_cuda_error`) is
    recorded FAILED and re-raised: the lost context would fail every
    later case.

    ``attribution`` (``"on"`` / ``"tail"``; requires
    ``config.attribution``) reduces critical-path blame per case in the
    run that serves it: the blame tables ride ``RunResult.blame`` and,
    with an output directory, ``<label>.blame.json`` +
    ``<label>.flame.txt``.  ``timeline`` (a window width in seconds;
    requires ``config.timeline``) runs a flight-recorder pass per case
    (``<label>.timeline.json``).  Fleet-served cases thread both through
    the fleet dispatch: the worst member's documents, stamped with its
    member and seed, and ``<label>.fleet-blame.json``.

    ``vet`` (``"on"`` / ``"strict"``, or ``$ISOTOPE_VET``) runs the
    static pre-flight gate before each case (:func:`_vet_gate`): a
    blocking verdict fails the case before it runs, and the memory
    verdict may start the ladder at ``half-block`` (recorded as
    degraded).

    A device mesh (``mesh_spec``, ``$ISOTOPE_MESH``, ``mesh_data`` /
    ``mesh_svc``; ``overlap`` pipelines its merge) of more than one rank
    serves the plain, attributed and recorded cases, the fleets (plain,
    observed and protected), the search brackets, the protected runs
    (a svc-sharded mesh falls back to one device, with a warning) and
    the splitting passes (``parallel/sharded.py``) in a world of as
    many ranks (``torchrun``): every rank runs the sweep and returns the
    same results, rank 0 alone writes, and a barrier ends the sweep.
    ``--mesh auto`` resolves each topology's factorization by the
    layout search (``parallel/layout.py``: the world's devices and
    hosts, the compiled service count) and prints it to stderr; a spec
    the world cannot hold raises the key-pathed config error before
    anything simulates."""
    from isotope_tpu_torch.analysis.vet import vet_mode
    from isotope_tpu_torch.parallel import mesh as mesh_mod

    vet = vet_mode(vet)
    mesh_spec = _mesh_spec(config, resolve_mesh_request(config))
    world = mesh_mod.world_size()
    if world > 1:
        mesh_mod.init_world(device if device is not None else "cuda")
    writer = mesh_mod.world_rank() == 0
    # resolve exporter specs up front: a typo'd --export must fail
    # before any simulation, not after
    exporters = []
    if export:
        if out_dir is None:
            raise ValueError(
                "export specs require out_dir (exporters write their "
                "datafiles under the run's output directory)"
            )
        from isotope_tpu_torch.metrics.export import resolve_exporter

        exporters = [resolve_exporter(s) for s in export]
    if policy is None:
        policy = ResiliencePolicy.from_env()
    # spec errors surface here, before anything simulates
    ens_spec = config.ensemble_spec()
    search_spec = config.search_spec()

    # labels are the identity of a run everywhere downstream (artifact
    # names, the checkpoint restore key, the CSV rows): a colliding grid
    # would clobber artifacts and restore the wrong record
    grid_cells = [
        {"topo": topo_path, "env": env.name, "load": load,
         "label": run_label(topo_path, env.name, load, config.labels),
         "idx": i}
        for i, (topo_path, env, load) in enumerate(
            (t, e, ld)
            for t in config.topology_paths
            for e in config.environments
            for ld in config.load_models()
        )
    ]
    grid_labels = [c["label"] for c in grid_cells]
    dupes = {lb for lb in grid_labels if grid_labels.count(lb) > 1}
    if dupes:
        raise ValueError(
            f"duplicate run label(s) in the sweep grid: "
            f"{sorted(dupes)} — disambiguate the topology filenames "
            "(labels use the file stem) or the load grid"
        )

    out = ckpt_file = None
    done: dict = {}
    if out_dir is not None:
        out = pathlib.Path(out_dir)
        ckpt_path = out / "checkpoint.jsonl"
        fingerprint = _config_fingerprint(config)
        # every rank reads the checkpoint, so every rank skips the same
        # cases (their collectives pair up); rank 0 rewrites it after
        records = _load_checkpoint(ckpt_path, fingerprint) if resume else []
        if world > 1:
            _barrier()
        if writer:
            out.mkdir(parents=True, exist_ok=True)
            # rewrite via temp + atomic rename: drops any truncated tail
            # a kill left behind, guarantees appends start on a fresh
            # line, and a kill during the rewrite itself cannot lose the
            # old file
            tmp_path = out / "checkpoint.jsonl.tmp"
            with open(tmp_path, "w") as tmp:
                tmp.write(json.dumps({"config": fingerprint}) + "\n")
                for rec in records:
                    tmp.write(json.dumps(rec) + "\n")
                tmp.flush()
                os.fsync(tmp.fileno())
            os.replace(tmp_path, ckpt_path)
            ckpt_file = open(ckpt_path, "a")
        # label-keyed restore (latest record wins): completed cases are
        # never re-run, FAILED and quarantined-corrupt cases are
        done = {rec["label"]: rec for rec in records}
    if not writer:
        # only rank 0 writes: its console lines, profiles and documents
        progress = None
        profile_dir = None

    ens_groups = None
    if ens_spec is not None:
        completed = {lb for lb, rec in done.items() if not rec.get("failed")}
        ens_groups = _EnsembleGroups(config, ens_spec, grid_cells,
                                     completed)

    results: List[RunResult] = []
    with mesh_mod.rank_console():
        try:
            index = 0
            for topo_path in config.topology_paths:
                topo = _LazyTopology(topo_path, config, device, mesh_spec)
                for env in config.environments:
                    for load in config.load_models():
                        results.append(_sweep_case(
                            topo, env, load, config, index, done, out,
                            ckpt_file, progress, policy, ens_groups,
                            attribution, timeline, search_spec,
                            profile_dir, vet,
                        ))
                        index += 1
        finally:
            if ckpt_file is not None:
                ckpt_file.close()
        _finish_sweep(results, out if writer else None, exporters)
    if world > 1:
        _barrier()
    return results


def _barrier() -> None:
    """Every rank of the world waits here."""
    import torch.distributed as dist

    dist.barrier()


def _finish_sweep(results, out, exporters) -> None:
    """The sweep's closing writes (``out`` None: none) and its failure
    count on the console."""
    ok = [r for r in results if not r.failed]
    if out is not None:
        with open(out / "results.jsonl", "w") as f:
            for r in results:
                f.write(json.dumps(r.flat) + "\n")
        # the per-service cpu_cores_<svc> columns are record-dependent
        extra_keys = sorted(
            {k for r in ok for k in r.flat if k.startswith("cpu_cores_")}
        )
        keys = DEFAULT_CSV_KEYS
        if extra_keys:
            keys = keys + "," + ",".join(extra_keys)
        write_csv(keys, [r.flat for r in ok], out / "benchmark.csv")
        for exporter in exporters:
            print(exporter(results, out), file=sys.stderr)
    n_failed = len(results) - len(ok)
    if n_failed:
        print(
            f"warning: {n_failed} run(s) failed and were recorded in "
            "the checkpoint; re-invoke with the same config to retry "
            "them",
            file=sys.stderr,
        )


def _sweep_case(topo, env, load, config, index, done, out, ckpt_file,
                progress, policy, ens_groups, attribution, timeline,
                search_spec, profile_dir, vet=None) -> RunResult:
    """Case ``index`` of the sweep: restored from the checkpoint when it
    completed before, else run, its artifacts and checkpoint line
    written at once (a kill loses at most the in-flight run)."""
    label = run_label(topo.path, env.name, load, config.labels)
    rec = done.get(label)
    if rec is not None and not rec.get("failed"):
        return _restore_result(rec, out)
    if progress:
        progress(label)
    if telemetry.emitting():
        # each telemetry.jsonl record covers exactly ONE run
        telemetry.reset()
    result, extra, run_telem = _run_case(
        topo, env, load, config, index, label, policy, ens_groups,
        attribution, timeline, search_spec, profile_dir, vet,
    )
    if result.failed:
        if ckpt_file is not None:
            ckpt_file.write(json.dumps({
                "label": label,
                "topology": topo.path,
                "environment": env.name,
                "failed": True,
                "error": result.error[:1000],
                "error_class": extra["error_class"],
            }) + "\n")
            ckpt_file.flush()
        if is_sticky_cuda_error(result.cause):
            # the CUDA context is lost: every later case of this process
            # would fail too, so the sweep stops; the same command in a
            # new process resumes from the checkpoint
            print("error: the CUDA context is lost; the sweep stops here "
                  "(re-invoke the same command to resume)",
                  file=sys.stderr)
            raise result.cause
        return result
    if ckpt_file is None:
        return result
    _write_artifacts(out, result, extra, run_telem)
    rec_out = {
        "label": label,
        "topology": topo.path,
        "environment": env.name,
        "flat": result.flat,
        "window": dataclasses.asdict(result.window),
        "fortio_json": result.fortio_json,
    }
    if result.degraded_to is not None:
        rec_out["degraded_to"] = result.degraded_to
    ckpt_file.write(json.dumps(rec_out) + "\n")
    ckpt_file.flush()
    return result


def _run_case(topo, env, load, config, index, label, policy, ens_groups,
              attribution, timeline, search_spec, profile_dir, vet=None):
    """One case, executed and documented: ``(RunResult, artifacts,
    RunTelemetry or None)``; an unrecoverable error gives a FAILED
    result whose artifacts hold its ``error_class``."""
    import contextlib

    case = _Case()
    if profile_dir is not None:
        from isotope_tpu_torch.telemetry.profile import torch_trace

        prof_ctx = torch_trace(pathlib.Path(profile_dir) / label)
    else:
        prof_ctx = contextlib.nullcontext()
    try:
        with prof_ctx:
            _execute(case, topo, env, load, config, index, policy,
                     ens_groups, attribution, timeline, label, vet,
                     search_spec)
            doc, flat, window, extra = _documents(
                case, topo, label, config, load, attribution, timeline,
                search_spec,
            )
    except NotImplementedError:
        # an unported path (ROADMAP.md names it) ends the sweep: it
        # would fail every case that takes it
        raise
    except Exception as e:
        # unrecoverable for THIS case (deterministic error, retries or
        # ladder exhausted): record it, keep the sweep alive
        if ens_groups is not None:
            ens_groups.completed.add(label)
        err_class = classify(e)
        err_text = f"{type(e).__name__}: {e}"
        telemetry.counter_inc("run_failures")
        print(f"error: run {label} failed ({err_class}): {err_text}",
              file=sys.stderr)
        return RunResult(
            label=label, topology=topo.path, environment=env.name,
            flat={"Labels": label, "failed": True, "error": err_text},
            window=_failed_window(err_text), fortio_json={},
            prometheus_text="", failed=True, error=err_text, cause=e,
        ), {"error_class": err_class}, None
    if case.degraded_to is not None:
        telemetry.set_meta("degraded_to", case.degraded_to)
    # full exposition: the five service series plus the sim-side
    # resource series the alarm queries read
    prom_text = topo.collector.full_text(case.summary)
    run_telem = None
    if telemetry.emitting():
        # one scrape sees workload AND engine
        telemetry.record_device_memory()
        _record_vet_memory_ratio()
        run_telem = telemetry.snapshot(label=label)
        prom_text += run_telem.prometheus_text()
    ens = case.ens
    result = RunResult(
        label=label,
        topology=topo.path,
        environment=env.name,
        flat=flat,
        window=window,
        fortio_json=doc,
        prometheus_text=prom_text,
        telemetry=run_telem.to_dict() if run_telem else None,
        degraded_to=case.degraded_to,
        blame=extra.get("blame"),
        attribution=case.attr,
        compiled=(
            topo.compiled
            if case.attr is not None or case.tl is not None else None
        ),
        timeline=extra.get("timeline"),
        timeline_summary=case.tl,
        policies=extra.get("policies"),
        policies_summary=case.pol,
        rollouts=extra.get("rollout"),
        rollouts_summary=case.roll,
        lb=extra.get("lb"),
        ensemble=extra.get("ensemble"),
        ensemble_summary=ens,
        fleet_blame=extra.get("fleet-blame"),
        search=extra.get("search"),
    )
    return result, extra, run_telem
