"""The ranks of the mesh fleets' and protected runs' ``gloo`` worlds.

``tests/test_torch_sharded_fleets.py`` and
``tests/test_torch_sharded_protected.py`` launch one world of processes
per mesh shape with :func:`launch` (``tests/torch_mesh_world.py``'s
launcher): each process runs this file as a script (``python
tests/torch_mesh_fleet_world.py WORLD RANK SIZE DIR``), joins the world
through ``init_method="file://DIR/init"``, runs every scenario of its
world through the port's collective path and saves what each returned
to ``DIR/rank<R>.pt``.

As in ``torch_mesh_world.py`` the ranks import no JAX: they draw from
the draws the parent recorded (``Recording`` around ``JaxReplayDraws``)
while it ran the same scenarios through the port's emulated twins, and
the compiled topologies are built from their YAML in each process.
"""
from __future__ import annotations

import io
import pathlib
import sys
import time
from contextlib import redirect_stderr

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
for p in (str(REPO), str(REPO / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from torch_mesh_world import (  # noqa: E402
    FORK,
    GROUP_TIMEOUT_S,
    NpzDraws,
)
from torch_mesh_world import launch as _launch  # noqa: E402

# the reference's storm case (tests/test_torch_policies.py): retries,
# a breaker, a retry budget and an autoscaler on a worker that loses 3
# of its 4 replicas in [0.2 s, 0.5 s)
STORM = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 4
  script:
  - call: {service: worker, timeout: 850us, retries: 2}
- name: worker
  numReplicas: 4
policies:
  worker:
    breaker: {max_pending: 6}
    retry_budget: {budget_percent: 20%, min_retries_concurrent: 2}
    autoscaler: {min_replicas: 4, max_replicas: 12,
                 target_utilization: 50%, sync_period: 100ms,
                 stabilization_window: 1s, scale_up_step: 2}
"""
STORM_KILL = dict(service="worker", start_s=0.2, end_s=0.5, replicas_down=3)
STORM_QPS = 0.325 * 4 * 13_000.0

# a bad canary (30% errors) the controller rolls back within the run
ROLLOUT = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 2
  script:
  - call: worker
- name: worker
  numReplicas: 2
rollouts:
  defaults:
    gates: {min_samples: 20}
  worker:
    steps: [10%, 50%, 100%]
    bake: 100ms
    rollback: {cooldown: 200ms, max_retries: 1}
    canary: {error_rate: 30%}
"""

# the canary under a retry budget: both control layers in one carry
COMPOSED = ROLLOUT + """
policies:
  defaults:
    retry_budget: {budget_percent: 25%}
"""

# tests/test_torch_splitting.py's chaos case
SPLIT = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: worker, timeout: 2ms, retries: 1}
- name: worker
  numReplicas: 2
  errorRate: 1%
"""
SPLIT_KILL = dict(service="worker", start_s=0.02, end_s=0.08,
                  replicas_down=1)
SPLIT_SPEC = dict(levels=3, members=4, keep=0.5, threshold=0.05,
                  severity="err_share", horizon=0.5, seed=2)
SPLIT_JITTER = dict(time=0.4, magnitude=0.5, seed=1)

FLEET_KILL = dict(service="x", start_s=0.05, end_s=0.15, replicas_down=1)
JITTER = dict(qps_jitter=0.1, cpu_jitter=0.2, error_jitter=0.5,
              jitter_seed=3)
OPEN = dict(kind="open", qps=2000.0)
N, BLOCK = 512, 256

#: the fleet scenarios: name -> (graph, SimParams fields, chaos events,
#: tables ("policies" / "rollouts"), entry point, load, requests, block,
#: spec keywords, entry-point keywords)
FLEETS = {
    "fleet": (FORK, {}, (), None, "run_ensemble", OPEN, N, BLOCK,
              dict(members=6, mode="map", **JITTER), dict(trim=True)),
    "fleet_vmap": (FORK, {}, (), None, "run_ensemble", OPEN, N, BLOCK,
                   dict(members=6, mode="vmap", **JITTER),
                   dict(trim=True)),
    "closed": (FORK, {}, (), None, "run_ensemble",
               dict(kind="closed", qps=1500.0, connections=8), N, BLOCK,
               dict(members=4, mode="map"), {}),
    "chaos": (FORK, {}, (FLEET_KILL,), None, "run_ensemble", OPEN, N,
              BLOCK, dict(members=4, mode="vmap"),
              dict(member_chaos="jitter")),
    "observed": (FORK, dict(attribution=True, attribution_top_k=4,
                            timeline=True), (), None, "run_ensemble", OPEN,
                 N, BLOCK, dict(members=5, mode="vmap"),
                 dict(attribution=True, tail=True, timeline=True,
                      window_s=0.1)),
    "policies": (STORM, dict(timeline=True), (STORM_KILL,), "policies",
                 "run_policies_ensemble", dict(kind="open", qps=STORM_QPS),
                 2_048, 1_024, dict(members=4, mode="vmap"),
                 dict(window_s=0.05)),
    "rollouts": (ROLLOUT, dict(timeline=True), (), "rollouts",
                 "run_rollouts_ensemble", dict(kind="open", qps=8_000.0),
                 2_048, 512, dict(members=3, mode="map"),
                 dict(window_s=0.05)),
    "search": (FORK, {}, (), None, "run_search", OPEN, 1_024, BLOCK,
               dict(members=8, **JITTER), dict(eta=2, rungs=2)),
    "split": (SPLIT, {}, (SPLIT_KILL,), None, "splitting", dict(
        kind="open", qps=8_000.0), 1_024, 256, {}, {}),
}

#: the protected scenarios: name -> (graph, SimParams fields, chaos,
#: tables, entry point, load, requests, per-shard block, keywords)
PROTECTED = {
    "policies": (STORM, dict(timeline=True, timeline_window_s=0.1),
                 (STORM_KILL,), "policies", "run_policies",
                 dict(kind="open", qps=STORM_QPS), 8_192, 512,
                 dict(trim=True, window_s=0.1)),
    "attributed": (STORM, dict(timeline=True, attribution=True,
                               attribution_top_k=4),
                   (STORM_KILL,), "policies", "run_policies",
                   dict(kind="open", qps=STORM_QPS), 4_096, 512,
                   dict(window_s=0.1, attribution=True, tail=True)),
    "closed": (STORM, dict(timeline=True), (), "policies", "run_policies",
               dict(kind="closed", qps=2_000.0, connections=8), 4_096, 512,
               dict(window_s=0.5)),
    "rollouts": (ROLLOUT, dict(timeline=True), (), "rollouts",
                 "run_rollouts", dict(kind="open", qps=8_000.0), 8_192,
                 256, dict(window_s=0.05)),
    # tests/test_rollout.py's protected attribution pin: the canary and
    # the budget in one carry, the blame reduced in the same loop
    "composed": (COMPOSED, dict(timeline=True, attribution=True,
                                attribution_top_k=4), (), "both",
                 "run_rollouts", dict(kind="open", qps=8_000.0), 4_096,
                 256, dict(window_s=0.05, attribution=True)),
}

#: world -> (mesh spec (data, svc, slices), scenario table, scenarios,
#: extra checks)
WORLDS = {
    "fleet2": ((2, 1, 1), "fleets", list(FLEETS), []),
    "fleet4": ((2, 2, 1), "fleets", list(FLEETS), []),
    "fleet8": ((2, 2, 2), "fleets", list(FLEETS), []),
    "prot2": ((2, 1, 1), "protected", list(PROTECTED),
              ["ladder_gather", "ladder_compute", "block"]),
    "prot4": ((2, 1, 2), "protected", ["policies", "rollouts"],
              ["svc_fallback"]),
    "prot8": ((4, 1, 2), "protected", ["policies", "closed"], []),
}


# -- the port's side ----------------------------------------------------------


def _tables(graph: str, which):
    from isotope_tpu_torch.compiler import (
        compile_graph,
        compile_policies,
        compile_rollouts,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph

    g = ServiceGraph.from_yaml(graph)
    c = compile_graph(g)
    kw = {}
    if which in ("policies", "both"):
        kw["policies"] = compile_policies(g, c)
    if which in ("rollouts", "both"):
        kw["rollouts"] = compile_rollouts(g, c)
    return c, kw


def port_sharded(table: str, name: str, mesh, device="cpu"):
    """The port's ShardedSimulator of scenario ``name`` over ``mesh``."""
    from isotope_tpu_torch.parallel import ShardedSimulator
    from isotope_tpu_torch.sim import SimParams
    from isotope_tpu_torch.sim.config import ChaosEvent

    row = (FLEETS if table == "fleets" else PROTECTED)[name]
    graph, params, chaos, which = row[:4]
    compiled, kw = _tables(graph, which)
    return ShardedSimulator(
        compiled, mesh, SimParams(**params),
        tuple(ChaosEvent(**c) for c in chaos), device=device, **kw,
    )


def run_fleet(name: str, sh, source, emulated: bool):
    """Fleet scenario ``name`` on ``sh``: its collective path, or its
    emulated twin (``emulated``; the splitting pass: the solo fleets)."""
    from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
    from isotope_tpu_torch.runner.run import splitting_pass
    from isotope_tpu_torch.sim import LoadModel
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec
    from isotope_tpu_torch.sim.splitting import SplitSpec

    _, _, _, _, method, load, n, block, spec_kw, kw = FLEETS[name]
    load = LoadModel(**load)
    if method == "splitting":
        return splitting_pass(
            sh.sim, load, n, source, block, SplitSpec(**SPLIT_SPEC),
            chaos_jitter=ChaosJitterSpec(**SPLIT_JITTER),
            sharded=None if emulated else sh,
        )
    spec_kw = dict(spec_kw)
    spec = EnsembleSpec.from_jitter(spec_kw.pop("members"), **spec_kw)
    kw = dict(kw)
    suffix = "_emulated" if emulated else ""
    if method == "run_search":
        return getattr(sh, "run_search" + suffix)(
            load, n, source, SearchSpec(candidates=spec, **kw),
            block_size=block,
        )
    if kw.get("member_chaos") == "jitter":
        kw["member_chaos"] = ChaosJitterSpec(time=0.3, magnitude=0.5,
                                             seed=11)
    return getattr(sh, method + suffix)(load, n, source, spec,
                                        block_size=block, **kw)


def run_protected(name: str, sh, source, emulated: bool):
    from isotope_tpu_torch.sim import LoadModel

    _, _, _, _, method, load, n, block, kw = PROTECTED[name]
    fn = getattr(sh, method + ("_emulated" if emulated else ""))
    return fn(LoadModel(**load), n, source, block_size=block, **kw)


def twin_runs(world: str, source) -> dict:
    """Every scenario of ``world`` through the port's emulated twin (the
    world's mesh shape), its draws recorded through ``source``."""
    from isotope_tpu_torch.parallel import EmulatedMesh, MeshSpec

    spec, table, names, _ = WORLDS[world]
    out = {}
    for name in names:
        sh = port_sharded(table, name, EmulatedMesh(MeshSpec(*spec)))
        if table == "fleets":
            out[name] = run_fleet(name, sh, source, True)
        else:
            out[name] = run_protected(name, sh, source, True)
    return out


class _Config:
    timeline_window_s = 10.0


def _protected_case(sh, source, sharded=True):
    """``runner/run._protected_run`` of the ``policies`` scenario (the
    runner's window and block, its ladder), stderr captured."""
    from isotope_tpu_torch.resilience import ResiliencePolicy
    from isotope_tpu_torch.runner.run import _protected_run
    from isotope_tpu_torch.sim import LoadModel

    _, _, _, _, _, load, n, _, kw = PROTECTED["policies"]
    err = io.StringIO()
    with redirect_stderr(err):
        out = _protected_run(
            sh.sim, LoadModel(**load), n, source, 65_536, _Config(),
            sh.collector, ResiliencePolicy(sleep=lambda s: None),
            kw["window_s"], False, sharded=sh if sharded else None,
        )
    return dict(out=out, stderr=err.getvalue())


def _ladder(mesh, source, rank: int, plan: str, fault_ranks) -> dict:
    """``plan`` installed on ``fault_ranks`` only: every rank's protected
    ladder takes the same rungs."""
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.resilience import faults

    sh = port_sharded("protected", "policies", mesh)
    telemetry.reset()
    if rank in fault_ranks:
        faults.install(plan)
    t0 = time.monotonic()
    try:
        got = _protected_case(sh, source)
    finally:
        faults.clear()
    got["seconds"] = time.monotonic() - t0
    got["degradations"] = telemetry.counter_get("degradations_total")
    return got


def _block(mesh, source) -> dict:
    """The per-shard block the runner hands a mesh-served protected run
    (``protected_window_block(..., shards=n_shards)``)."""
    sh = port_sharded("protected", "policies", mesh)
    seen = []
    inner = sh.run_policies

    def spy(*a, **kw):
        seen.append(kw["block_size"])
        return inner(*a, **kw)

    sh.run_policies = spy
    got = _protected_case(sh, source)
    return dict(blocks=seen, summary=got["out"][0])


def _svc_fallback(source) -> dict:
    """A protected case on a svc-sharded mesh: the runner falls back to
    the single-device scan with the reference's warning (beside it, the
    Simulator's own run at the runner's window and block); the mesh's
    own ``run_policies`` refuses."""
    from isotope_tpu_torch.parallel import MeshSpec, build_mesh
    from isotope_tpu_torch.runner.run import protected_window_block
    from isotope_tpu_torch.sim import LoadModel

    mesh = build_mesh(MeshSpec(2, 2), device="cpu",
                      timeout_s=GROUP_TIMEOUT_S)
    sh = port_sharded("protected", "policies", mesh)
    got = _protected_case(sh, source)
    _, _, _, _, _, load, n, _, kw = PROTECTED["policies"]
    load = LoadModel(**load)
    win, block = protected_window_block(sh.sim, load, 65_536, 10.0,
                                        kw["window_s"])
    got["solo"] = sh.sim.run_policies(load, n, source, block_size=block,
                                      trim=True, window_s=win,
                                      collector=sh.collector)
    try:
        run_protected("policies", sh, source, False)
        got["refusal"] = None
    except ValueError as e:
        got["refusal"] = str(e)
    return got


# -- a rank ------------------------------------------------------------------


def rank_main(world: str, rank: int, size: int, workdir: str) -> None:
    import datetime

    import torch.distributed as dist

    from isotope_tpu_torch.parallel import MeshSpec, build_mesh
    from isotope_tpu_torch.parallel.mesh import close_world

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    dist.init_process_group(
        "gloo", init_method=f"file://{work / 'init'}", rank=rank,
        world_size=size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    source = NpzDraws(np.load(work / "draws.npz"))
    spec, table, names, extras = WORLDS[world]
    mesh = build_mesh(MeshSpec(*spec), device="cpu",
                      timeout_s=GROUP_TIMEOUT_S)
    out = {}
    for name in names:
        sh = port_sharded(table, name, mesh)
        if table == "fleets":
            out[name] = run_fleet(name, sh, source, False)
        else:
            out[name] = run_protected(name, sh, source, False)
    # the runner-level checks compare ranks and runs of this world
    # only: they draw from the port's own source
    from isotope_tpu_torch.sim import TorchDraws

    source = TorchDraws(5, "cpu")
    for name in extras:
        if name == "ladder_gather":
            out[name] = _ladder(mesh, source, rank, "oom:sharded.gather:2",
                                (1,))
        elif name == "ladder_compute":
            out[name] = _ladder(mesh, source, rank,
                                "oom:sharded.compute:1", (1,))
        elif name == "block":
            out[name] = _block(mesh, source)
        elif name == "svc_fallback":
            out[name] = _svc_fallback(source)
    torch.save(out, work / f"rank{rank}.pt")
    close_world()


def launch(world: str, workdir: pathlib.Path, timeout_s: float) -> list:
    """``world``'s ranks, each a process of its own, killed past
    ``timeout_s``; returns each rank's saved results."""
    return _launch(world, workdir, timeout_s, script=__file__,
                   size=int(np.prod(WORLDS[world][0])))


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
