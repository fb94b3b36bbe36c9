"""The ranks of the mesh tests' ``gloo`` worlds, and what they run.

``tests/test_torch_sharded.py`` launches one world of processes per mesh
shape with :func:`launch`; each process runs this file as a script
(``python tests/torch_mesh_world.py WORLD RANK SIZE DIR``): it joins the
world through ``init_method="file://DIR/init"`` (no port), builds the
mesh over ``gloo``, runs every scenario of its world through the port's
collective path and saves what each returned to ``DIR/rank<R>.pt``.

The ranks import neither JAX nor the JAX package.  They draw from
:class:`NpzDraws`: the draws the parent recorded (:class:`Recording`
around its ``JaxReplayDraws``) while it ran the same scenarios through
the port's emulated twin, keyed by draw index and draw spec, so the
collective path, the twin and the JAX ``ShardedSimulator`` all consume
the same numbers.  The compiled topology crosses as
``compiler.compiled_to_arrays`` arrays.
"""
from __future__ import annotations

import os
import pathlib
import signal
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from isotope_tpu_torch.sim.draws import Draws, index_path  # noqa: E402

#: timeout of every process group of a world (seconds)
GROUP_TIMEOUT_S = 60.0

FORK = """
defaults:
  responseSize: 1 KiB
services:
- name: entry
  isEntrypoint: true
  script:
  - - call: x
    - call: y
  - call: z
- name: x
  numReplicas: 2
- name: y
  script:
  - call: z
- name: z
"""

LB_CHAIN = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 8
  script:
  - call: worker
- name: worker
  numReplicas: 4
policies:
  worker:
    lb: {policy: ring_hash, hash_skew: 1.2, panic_threshold: 40%}
"""

OPEN = dict(kind="open", qps=2000.0)
CLOSED = dict(kind="closed", qps=1000.0, connections=16)
N, BLOCK = 4096, 256

#: name -> (graph, SimParams fields, entry point, load, requests, block,
#: entry-point keywords, chaos events)
SCENARIOS = {
    "open": (FORK, {}, "run", OPEN, N, BLOCK, dict(trim=True), ()),
    "overlap": (FORK, dict(overlap=True), "run", OPEN, N, BLOCK,
                dict(trim=True), ()),
    "closed": (FORK, {}, "run", CLOSED, N, BLOCK, {}, ()),
    "attr": (FORK, dict(attribution=True), "run_attributed", OPEN, N,
             BLOCK, dict(tail=True), ()),
    "tl": (FORK, dict(timeline=True), "run_timeline", OPEN, N, BLOCK,
           dict(window_s=0.25), ()),
    # tests/test_lb.py's sharded pin: ring hash, panic, chaos, recorded
    "lb": (LB_CHAIN, dict(timeline=True, timeline_window_s=0.25),
           "run_timeline", dict(kind="open", qps=20_000.0), 8_192, 2_048,
           dict(window_s=0.25),
           (dict(service="worker", start_s=0.2, end_s=1.0,
                 replicas_down=3),)),
}

#: world -> (mesh spec (data, svc, slices), scenarios, fault scenarios)
WORLDS = {
    "data2": ((2, 1, 1), ["open", "overlap", "closed", "attr", "tl"],
              ["ladder_all", "ladder_one"]),
    "data2xsvc2": ((2, 2, 1), ["open", "overlap", "closed", "attr", "tl",
                              "lb"], ["dcn_silent"]),
    "data2xsvc2xslice2": ((2, 2, 2), ["open", "overlap", "closed", "attr",
                                     "tl"], ["dcn_retry"]),
}

#: the lb pin's mesh: four shards on the data axis (tests/test_lb.py)
LB_SPEC = (4, 1, 1)


def mesh_spec_of(world: str, scenario: str):
    return LB_SPEC if scenario == "lb" else WORLDS[world][0]


# -- draws -------------------------------------------------------------------


def _key(root: str, index, spec, field: str) -> str:
    """A recorded array's name: its root seed, draw index and draw
    spec (block size and streams: an open and a closed block of one
    index draw different streams)."""
    path = "-".join(str(i) for i in index_path(index)) or "none"
    return f"{root}|{path}|{zlib.crc32(repr(spec).encode()):08x}|{field}"


class Recording:
    """A draw source recording every block another source hands out."""

    def __init__(self, inner, store: dict, root: str = "run"):
        self.inner, self.store, self.root = inner, store, root

    def with_seed(self, seed: int):
        return Recording(self.inner.with_seed(seed), self.store,
                         f"seed{seed}")

    def draws(self, index, spec) -> Draws:
        out = self.inner.draws(index, spec)
        for field, value in zip(Draws._fields, out):
            if value is not None:
                self.store[_key(self.root, index, spec, field)] = (
                    value.numpy()
                )
        return out


class NpzDraws:
    """The recorded draws, read back by index and draw spec."""

    def __init__(self, arrays, root: str = "run"):
        self.arrays, self.root = arrays, root

    def with_seed(self, seed: int):
        return NpzDraws(self.arrays, f"seed{seed}")

    def draws(self, index, spec) -> Draws:
        fields = {}
        for field in Draws._fields:
            key = _key(self.root, index, spec, field)
            if key in self.arrays:
                fields[field] = torch.from_numpy(
                    np.array(self.arrays[key])
                )
        if not fields:
            raise KeyError(f"no recorded draws for {index} at n={spec.n}")
        return Draws(**fields)


# -- the scenarios (the port's side) ------------------------------------------


def port_sharded(name: str, compiled, mesh, device="cpu"):
    """The port's ShardedSimulator of scenario ``name`` over ``mesh``."""
    from isotope_tpu_torch.compiler import compile_graph, compile_lb
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.parallel import ShardedSimulator
    from isotope_tpu_torch.sim import SimParams
    from isotope_tpu_torch.sim.config import ChaosEvent

    graph, params, _, _, _, _, _, chaos = SCENARIOS[name]
    lb = None
    if graph == LB_CHAIN:
        g = ServiceGraph.from_yaml(graph)
        compiled = compile_graph(g)
        lb = compile_lb(g, compiled)
    return ShardedSimulator(
        compiled, mesh, SimParams(**params),
        tuple(ChaosEvent(**c) for c in chaos), lb=lb, device=device,
    )


def run_scenario(name: str, compiled, mesh, source, emulated: bool):
    """Scenario ``name``'s entry point (its ``*_emulated`` twin with
    ``emulated``) on the port."""
    from isotope_tpu_torch.sim import LoadModel

    _, _, method, load, n, block, kw, _ = SCENARIOS[name]
    sh = port_sharded(name, compiled, mesh)
    fn = getattr(sh, method + ("_emulated" if emulated else ""))
    return fn(LoadModel(**load), n, source, block_size=block, **kw)


def _ladder(compiled, mesh, source, rank: int, fault_ranks) -> dict:
    """``oom:sharded.gather:2`` installed on ``fault_ranks``: the mesh
    ladder's rungs from a clean run's shape, every rank to the same
    rung (tests/test_resilience.py's pin)."""
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.resilience import (
        ResiliencePolicy,
        execution_rungs,
        faults,
        run_ladder,
    )
    from isotope_tpu_torch.sim import LoadModel

    sh = port_sharded("open", compiled, mesh)
    load = LoadModel(**OPEN)
    clean = sh.run(load, N, source, block_size=BLOCK, trim=True)
    telemetry.reset()
    if rank in fault_ranks:
        faults.install("oom:sharded.gather:2")
    try:
        rungs = execution_rungs(sh.sim, load, N, source, BLOCK, trim=True,
                                sharded=sh)
        (summary, _), degraded = run_ladder(
            rungs, ResiliencePolicy(sleep=lambda s: None),
            site_prefix="engine",
        )
    finally:
        faults.clear()
    return dict(clean=clean, summary=summary, degraded=degraded,
                degradations=telemetry.counter_get("degradations_total"))


def _dcn(compiled, mesh, source) -> dict:
    """``transient:sharded.dcn_collective:1`` on every rank: retried to
    the clean run's summary on a mesh with a slice axis, never fired on
    one without (tests/test_multihost.py's pins)."""
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.resilience import (
        ResiliencePolicy,
        execution_rungs,
        faults,
        run_ladder,
    )
    from isotope_tpu_torch.sim import LoadModel

    sh = port_sharded("open", compiled, mesh)
    load = LoadModel(**OPEN)
    clean = sh.run(load, N, source, block_size=BLOCK)
    telemetry.reset()
    faults.install("transient:sharded.dcn_collective:1")
    try:
        rungs = execution_rungs(sh.sim, load, N, source, BLOCK,
                                trim=False, sharded=sh)
        (summary, _), degraded = run_ladder(
            rungs, ResiliencePolicy(sleep=lambda s: None),
            site_prefix="engine",
        )
    finally:
        faults.clear()
    return dict(clean=clean, summary=summary, degraded=degraded,
                retries=telemetry.counter_get("retries_total"),
                injected=telemetry.counter_get("faults_injected"))


def twin_runs(world: str, compiled, source) -> dict:
    """Every scenario of ``world`` through the port's emulated twin,
    its draws recorded through ``source`` (the fault scenarios' rungs
    draw the ``open`` scenario's blocks: their half block is 256 rows
    too, the ladder's floor)."""
    from isotope_tpu_torch.parallel import EmulatedMesh, MeshSpec

    assert max(256, BLOCK // 2) == BLOCK
    out = {}
    for name in WORLDS[world][1]:
        mesh = EmulatedMesh(MeshSpec(*mesh_spec_of(world, name)))
        out[name] = run_scenario(name, compiled, mesh, source, True)
    return out


# -- a rank ------------------------------------------------------------------


def rank_main(world: str, rank: int, size: int, workdir: str) -> None:
    import datetime

    import torch.distributed as dist

    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.compiler import compiled_from_arrays
    from isotope_tpu_torch.parallel import MeshSpec, build_mesh
    from isotope_tpu_torch.parallel.mesh import close_world

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    dist.init_process_group(
        "gloo", init_method=f"file://{work / 'init'}", rank=rank,
        world_size=size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    compiled = compiled_from_arrays(dict(np.load(work / "compiled.npz")))
    source = NpzDraws(np.load(work / "draws.npz"))
    spec, names, fault_names = WORLDS[world]
    out = {}
    for name in names:
        mesh = build_mesh(MeshSpec(*mesh_spec_of(world, name)),
                          device="cpu", timeout_s=GROUP_TIMEOUT_S)
        telemetry.reset()
        out[name] = run_scenario(name, compiled, mesh, source, False)
        if name == "open":
            out["open.telemetry"] = dict(
                sharded_runs=telemetry.counter_get("sharded_runs"),
                shard_count=telemetry.gauge_get("shard_count"),
                imbalance=telemetry.gauge_get(
                    "shard_rows_imbalance_fraction"
                ),
            )
    mesh = build_mesh(MeshSpec(*spec), device="cpu",
                      timeout_s=GROUP_TIMEOUT_S)
    for name in fault_names:
        t0 = time.monotonic()
        if name == "ladder_all":
            out[name] = _ladder(compiled, mesh, source, rank, range(size))
        elif name == "ladder_one":
            out[name] = _ladder(compiled, mesh, source, rank, (1,))
        else:
            out[name] = _dcn(compiled, mesh, source)
        out[name]["seconds"] = time.monotonic() - t0
    out["coordinate"] = list(mesh.get_coordinate())
    torch.save(out, work / f"rank{rank}.pt")
    close_world()


def launch(world: str, workdir: pathlib.Path, timeout_s: float,
           script: str = __file__, size: int = 0) -> list:
    """Run ``world``'s ranks (``size`` of them; default: its mesh's) as
    processes of their own running ``script``, each in its own session;
    past ``timeout_s`` every one is killed.  Returns each rank's saved
    results; raises with the failing ranks' output."""
    size = size or int(np.prod(WORLDS[world][0]))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    procs = []
    for r in range(size):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, script, world, str(r), str(size),
             str(workdir)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        ), log))
    deadline = time.monotonic() + timeout_s
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        logs = "\n".join(
            f"--- rank {r} (rc {procs[r][0].returncode}) ---\n"
            + (workdir / f"rank{r}.log").read_text()[-3000:]
            for r in failed
        )
        raise AssertionError(f"world {world} failed:\n{logs}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(size)]


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
