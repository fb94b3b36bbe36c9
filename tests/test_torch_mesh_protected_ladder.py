"""The protected mesh ladder's last rung on the CPU, in process.

A mesh-served protected run (``runner/run._protected_run(sharded=)``)
walks ``sharded`` -> ``sharded-half-block`` -> ``single-device``, the last
being the lockstep emulated twin (``ShardedSimulator.run_policies_emulated``)
on this rank's device.  That rung must fit where one shard fits: the twin
suspends every shard's block loop (``Simulator._summary_steps`` over
``run_blocks``) between the shards' merges, and a suspended loop keeps
its carries and its pending observations, never its block.

The ladder runs over a world of one (``gloo``, a ``HashStore`` in this
process: no launcher, no other rank), forced down with ``oom:`` fault
plans; the memory property is checked with weak references to every
block's per-hop tensors on 4- and 8-shard twins.
"""
import weakref

import pytest
import torch

from isotope_tpu_torch.parallel import (
    EmulatedMesh,
    MeshSpec,
    ShardedSimulator,
    build_mesh,
)
from isotope_tpu_torch.parallel import mesh as mesh_mod
from isotope_tpu_torch.resilience import faults
from isotope_tpu_torch.sim import TorchDraws
from isotope_tpu_torch.sim.engine import Simulator
from torch_mesh_fleet_world import _protected_case, port_sharded, run_protected


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if hasattr(x, "_fields"):
        return [t for v in x for t in _leaves(v)]
    return [x]


def assert_bit_equal(got, want, what):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), (what, i)
        else:
            assert x == y, (what, i)


@pytest.fixture
def world_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh_mod.close_world()
    yield build_mesh(MeshSpec(1, 1), device="cpu", timeout_s=60)
    mesh_mod.close_world()


@pytest.mark.parametrize("plan,rung", [
    ("oom:sharded.gather:2", "single-device"),
    ("oom:sharded.compute:2", "single-device"),
], ids=["gather", "compute"])
def test_protected_ladder_reaches_the_single_device_rung(world_of_one, plan,
                                                         rung):
    """Two ``oom:`` faults at a sharded site fail the ``sharded`` and
    ``sharded-half-block`` rungs; the run lands on ``single-device`` (the
    lockstep twin at the full shard block), bit for bit the clean run's
    result on the mesh."""
    clean = _protected_case(port_sharded("protected", "policies",
                                         world_of_one), TorchDraws(3, "cpu"))
    assert clean["out"][-1] is None
    faults.install(plan)
    try:
        got = _protected_case(port_sharded("protected", "policies",
                                           world_of_one),
                              TorchDraws(3, "cpu"))
    finally:
        faults.clear()
    assert got["out"][-1] == rung
    assert_bit_equal(got["out"][:-1], clean["out"][:-1], plan)


def _watch(monkeypatch):
    """Weak references to each block's per-hop tensors; returns ``(live
    blocks after each block was made, live blocks at each merge)``."""
    blocks, made, merged = [], [], []

    def live():
        return sum(any(r() is not None for r in refs) for refs in blocks)

    core = Simulator._simulate_core

    def watched_core(self, *args, **kwargs):
        out = core(self, *args, **kwargs)
        res = out[0]
        blocks.append([weakref.ref(getattr(res, f)) for f in res._fields
                       if f.startswith("hop_")
                       and getattr(res, f) is not None])
        made.append(live())
        return out

    merge = ShardedSimulator.merge_observations

    def watched_merge(self, shards):
        merged.append(live())
        return merge(self, shards)

    monkeypatch.setattr(Simulator, "_simulate_core", watched_core)
    monkeypatch.setattr(ShardedSimulator, "merge_observations",
                        watched_merge)
    return made, merged


@pytest.mark.parametrize("name,spec", [
    ("policies", (4, 1, 2)),
    ("attributed", (2, 1, 2)),
    ("rollouts", (2, 1, 2)),
    ("closed", (2, 1, 2)),
])
def test_lockstep_twin_holds_one_block_at_a_time(monkeypatch, name, spec):
    """At each block the lockstep makes, no other shard's block is alive;
    at each merge, none: the suspended shards hold their carries and
    observations only.  The result is the unwatched twin's, bit for
    bit."""
    want = run_protected(name, port_sharded(
        "protected", name, EmulatedMesh(MeshSpec(*spec))),
        TorchDraws(5, "cpu"), True)
    made, merged = _watch(monkeypatch)
    got = run_protected(name, port_sharded(
        "protected", name, EmulatedMesh(MeshSpec(*spec))),
        TorchDraws(5, "cpu"), True)
    n_shards = spec[0] * spec[1] * spec[2]
    assert len(made) >= 2 * n_shards and len(merged) >= 2
    assert max(made) == 1, made
    assert max(merged) == 0, merged
    assert_bit_equal(got, want, name)
