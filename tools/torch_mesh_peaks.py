"""Measure the mesh-served protected runs' lockstep twins on one card.

    python3 tools/torch_mesh_peaks.py [--root DIR]

For policies-1000svc-kill and rollouts-multitier-1000-bad
(``chip_smoke.protected_runs``, cut to ``chip_smoke.MESH_PROT_WINDOWS``
windows of 1 s as ``chip_smoke.py`` phase 11 cuts them), runs the
emulated ``MeshSpec(4, 1, 2)`` twin (8 shards in lockstep: the protected
ladder's ``single-device`` rung) at ``protected_window_block(...,
shards=8)``'s block, and the ``MeshSpec(1, 1)`` twin (one shard) at the
same block over the same requests and windows, each once unmeasured and
then measured.  Prints the card's name and power limit, and per run each
twin's own peak (``max_memory_allocated`` above what was allocated when
it started), their ratio, walls, census launches and a SHA-256 digest of
the 8-shard twin's outputs, so that two checkouts' twins compare bit for
bit across processes.  ``--root`` imports ``isotope_tpu_torch`` from
another checkout (default: this one): run the parent and the change in
turns in one call.  Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time
from types import SimpleNamespace

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _digest(x, h) -> None:
    if isinstance(x, torch.Tensor):
        h.update(str((x.dtype, tuple(x.shape))).encode())
        h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    elif isinstance(x, (tuple, list)):
        for v in x:
            _digest(v, h)
    else:
        h.update(repr(x).encode())


def _measured(port, fn):
    """``fn()``'s result, wall seconds, census launches and own peak
    GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    port.census.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return out, wall, port.census.launches, peak


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(ROOT))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_peaks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from isotope_tpu_torch import compiler
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census as census_mod
    from isotope_tpu_torch.parallel import (
        EmulatedMesh,
        MeshSpec,
        ShardedSimulator,
    )
    from isotope_tpu_torch.runner.run import protected_window_block
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
    from isotope_tpu_torch.sim import TorchDraws
    from isotope_tpu_torch.sim.config import ChaosEvent

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card(), flush=True)
    package = pathlib.Path(census_mod.__file__).resolve().parents[1]
    print(f"isotope_tpu_torch from {package}", flush=True)
    census_mod.LIBRARY.build()
    port = SimpleNamespace(
        compile_graph=compiler.compile_graph,
        compile_policies=compiler.compile_policies,
        compile_rollouts=compiler.compile_rollouts,
        ServiceGraph=ServiceGraph, LoadModel=LoadModel,
        Simulator=Simulator, SimParams=SimParams, TorchDraws=TorchDraws,
        census=census_mod.census, realistic_topology=realistic_topology,
        with_call_policy=with_call_policy, ChaosEvent=ChaosEvent,
        protected_window_block=protected_window_block,
    )
    prot = chip_smoke.protected_runs(port)
    one = EmulatedMesh(MeshSpec(1, 1))
    spec = chip_smoke.MESH_PROT_TWIN
    eight = EmulatedMesh(MeshSpec(*spec[:2], slices=spec[2]))
    for name, roll in (("policies-1000svc-kill", False),
                       ("rollouts-multitier-1000-bad", True)):
        (_, psim, load, _, _, window, _, _) = [
            r for r in prot if r[0] == name][0]
        n = int(chip_smoke.MESH_PROT_WINDOWS * window * load.qps)
        method = ("run_rollouts" if roll else "run_policies") + "_emulated"
        twin1 = ShardedSimulator(psim.compiled, one, sim=psim)
        twin8 = ShardedSimulator(psim.compiled, eight, sim=psim)
        _, b8 = protected_window_block(
            psim, load, psim.default_block_size(),
            psim.params.timeline_window_s, chip_smoke.PROTECTED_WINDOW_S,
            shards=twin8.n_shards)

        def call(runner):
            return getattr(runner, method)(
                load, n, TorchDraws(61, "cuda"), block_size=b8, trim=True,
                window_s=window)

        got = {}
        for label, runner in (("8-shard twin", twin8),
                              ("one shard", twin1)):
            call(runner)  # unmeasured: the allocator's growth
            got[label] = _measured(port, lambda: call(runner))
        out, wall, launches, peak = got["8-shard twin"]
        _, wall1, launches1, peak1 = got["one shard"]
        h = hashlib.sha256()
        _digest(out, h)
        print(f"mesh peaks {name}: {n} requests, {window:g} s windows, "
              f"blocks of {b8} a shard; {eight!r} twin own peak "
              f"{peak:.4f} GiB, {wall * 1e3:.2f} ms, census launches "
              f"{launches}; one shard (1x1 twin) own peak {peak1:.4f} GiB, "
              f"{wall1 * 1e3:.2f} ms, census launches {launches1}; ratio "
              f"{peak / max(peak1, 1e-12):.4f}; twin digest "
              f"{h.hexdigest()[:16]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
