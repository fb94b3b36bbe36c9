"""A rank of the runner's ``gloo`` world (``tests/test_torch_sharded_runner.py``).

Launched by ``torchrun --standalone --nproc-per-node 8`` (:func:`launch`)
as ``python tests/torch_mesh_runner_world.py DIR``: every rank runs the
same ``run_experiment`` calls of the port on the CPU, drawing from the
draws the parent recorded (``NpzDraws`` in place of ``TorchDraws``, as
the runner tests put ``JaxReplayDraws`` there), and saves what each call
returned, or the error it raised, to ``DIR/rank<R>.json``.  No JAX.
"""
from __future__ import annotations

import io
import json
import os
import pathlib
import signal
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
for p in (str(REPO), str(REPO / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from torch_mesh_world import FORK, NpzDraws  # noqa: E402

WORLD = 8
#: the reference's runner pins' case (tests/test_multihost.py:_config)
CASE = dict(qps=(500.0,), connections=(8,), duration_s=2.0,
            load_kind="open", num_requests=2048)

#: the mesh-served cases of the runner's pins: a fleet, a protected
#: run (its svc-sharded mesh falls back to one device), a search bracket
#: and a fleet's splitting pass
MESH_SERVED = {
    "ensemble": dict(ensemble=4, ensemble_qps_jitter=0.1),
    "policies": dict(policies=True, topology="storm.yaml"),
    # blocks of 250 requests: the bracket's rungs need several blocks
    # (the runner's memory-sized block would hold the whole case)
    "search": dict(search_candidates=8, search_eta=2, search_rungs=2,
                   search_jitter="qps=0.2,cpu=0.1", block=250),
    "split": dict(ensemble=4, ensemble_split=(
        "levels=2,members=4,keep=0.5,threshold=0.05,sev=err_share"),
        ensemble_split_horizon=0.5),
}

TOML = """
topology_paths = ["{topo}"]
environments = ["NONE"]

[client]
qps = [500]
num_concurrent_connections = [8]
duration = "2s"
load_kind = "open"

[sim]
num_requests = 2048
"""


def config(topo, **kw):
    from isotope_tpu_torch.runner.config import (
        DEFAULT_ENVIRONMENTS,
        ExperimentConfig,
    )

    return ExperimentConfig(
        topology_paths=(str(topo),),
        environments=(DEFAULT_ENVIRONMENTS["NONE"],), **CASE, **kw,
    )


def _call(fn):
    """``{"flats": [...]}`` of a run, or ``{"error": type, "message"}``."""
    try:
        results = fn()
    except Exception as e:
        return {"error": type(e).__name__, "message": str(e)}
    return {"flats": [r.flat for r in results],
            "failed": [r.failed for r in results]}


def rank_main(workdir: str) -> None:
    import torch

    import isotope_tpu_torch.sim
    from isotope_tpu_torch import cli
    from isotope_tpu_torch.runner.run import run_experiment
    from isotope_tpu_torch.sim import Simulator

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    rank = int(os.environ["RANK"])
    arrays = np.load(work / "draws.npz")
    real_draws = isotope_tpu_torch.sim.TorchDraws
    isotope_tpu_torch.sim.TorchDraws = (
        lambda seed, device: NpzDraws(arrays)
    )
    topo = work / "t.yaml"
    out = {}

    def run(name, **kw):
        out[name] = _call(lambda: run_experiment(
            config(topo, **kw.pop("cfg", {})), device="cpu", **kw
        ))

    run("explicit", cfg=dict(mesh_spec="2x2x2"), out_dir=str(work / "out"))
    os.environ["ISOTOPE_MESH"] = "4x2"
    run("env")
    del os.environ["ISOTOPE_MESH"]
    run("legacy_world", cfg=dict(mesh_data=0))
    run("legacy_keys", cfg=dict(mesh_data=2, mesh_svc=4))
    run("bad_spec", cfg=dict(mesh_spec="nope=1"))
    run("too_big", cfg=dict(mesh_spec="4x4"))
    run("overlap_on", cfg=dict(mesh_spec="2x2x2", overlap=True))
    run("overlap_off", cfg=dict(mesh_spec="2x2x2"))
    run("auto", cfg=dict(mesh_spec="auto"))
    # the mesh-served cases, each beside the same sweep at --mesh 1x1 on
    # the port's own draws (the mesh and the one device run the same
    # members, candidates and levels)
    isotope_tpu_torch.sim.TorchDraws = real_draws
    for mesh in ("2x2x2", "1x1"):
        for name, kw in MESH_SERVED.items():
            kw = dict(kw)
            topo_name = kw.pop("topology", "t.yaml")
            block = kw.pop("block", None)
            sizing = Simulator.default_block_size
            if block is not None:
                Simulator.default_block_size = (
                    lambda self, budget_elems=0: block
                )
            err = io.StringIO()
            try:
                with redirect_stderr(err):
                    out[f"{name}@{mesh}"] = _call(lambda: run_experiment(
                        config(work / topo_name, mesh_spec=mesh, **kw),
                        device="cpu", out_dir=str(work / f"{name}@{mesh}"),
                    ))
            finally:
                Simulator.default_block_size = sizing
            out[f"{name}@{mesh}"]["stderr"] = err.getvalue()
    isotope_tpu_torch.sim.TorchDraws = (
        lambda seed, device: NpzDraws(arrays)
    )
    # the command line, as `torchrun ... -m isotope_tpu_torch sweep`
    toml = work / "sweep.toml"
    if rank == 0:
        toml.write_text(TOML.format(topo=topo))
    import torch.distributed as dist

    dist.barrier()
    stdout, stderr = io.StringIO(), io.StringIO()
    with redirect_stdout(stdout), redirect_stderr(stderr):
        rc = cli.main(["sweep", str(toml), "-o", str(work / "cli"),
                       "--mesh", "2x2x2", "--overlap", "--device", "cpu"])
    out["cli"] = dict(rc=rc, stdout=stdout.getvalue(),
                      stderr=stderr.getvalue())
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def launch(workdir: pathlib.Path, timeout_s: float) -> list:
    """``torchrun --standalone`` (a free port on this host) with
    ``WORLD`` ranks in a session of its own, killed past ``timeout_s``;
    returns each rank's saved results, or raises with the log."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               ISOTOPE_MESH_TIMEOUT="60")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "ISOTOPE_MESH",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    log_path = workdir / "torchrun.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(WORLD), __file__, str(workdir)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if proc.returncode != 0:
        raise AssertionError(
            f"torchrun rc {proc.returncode}:\n"
            + log_path.read_text()[-4000:]
        )
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(WORLD)]


if __name__ == "__main__":
    rank_main(sys.argv[1])
