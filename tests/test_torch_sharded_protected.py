"""The port's mesh-served protected runs (``ShardedSimulator.run_policies``
/ ``run_rollouts``, ``isotope_tpu_torch/parallel/sharded.py``) in
``gloo`` worlds on the CPU, against their lockstep emulated twins and
the JAX package's ``ShardedSimulator``.

Three worlds, each launched once (``tests/torch_mesh_fleet_world.py``,
every group's timeout 60 s, the world killed at ``WORLD_TIMEOUT_S``):
data=2 (the storm case open, attributed and closed, the rollout case
alone and under a retry budget with its blame, and the runner's ladder
and block), data=2 x slice=2 (the storm and
rollout cases, and a svc-sharded mesh's fallback) and data=4 x slice=2.

The merge rule, which these tests pin: every shard runs its slice of
the request stream under the SHARED control state, and each block's
observations (the recorder's block, the (S, W) retry and the (S, 2, W,
4) rollout observations) are all-gathered and summed in the twin's
shard order (each slice's shards, then the slice partials), ``t_done``
the minimum, before the laws advance.  So:

- every rank returns the same results, bit for bit;
- the recorder's series, the policy and the rollout series of the
  collective path equal the lockstep twin's bit for bit (the breakers
  trip, the autoscaler scales and the canary rolls back on the same
  windows);
- the run summary and the blame merge with the plain run's collectives
  (``tests/test_torch_sharded.py``'s bounds: integers and extremes
  equal, float sums within ``n_shards`` float32 spacings of the twin);
- the twin against the JAX ``ShardedSimulator``'s on the same draws:
  ``tests/test_torch_policies.py``'s tolerances (counts equal, seconds
  within rtol 1e-5 / atol 1e-9 s, the timeline band, the policy series
  equal) and the attribution band;
- a fault on one rank of two moves both ranks to the same rung, and a
  mesh-served protected run sizes its block a shard
  (``protected_window_block(..., shards=n_shards)``).
"""
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.compiler import compile_rollouts as jax_compile_rollouts
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.parallel import EmulatedMesh as JaxEmulated
from isotope_tpu.parallel import MeshSpec as JaxMeshSpec
from isotope_tpu.parallel import ShardedSimulator as JaxSharded
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim.config import ChaosEvent as JaxChaos
from isotope_tpu_torch.parallel import EmulatedMesh, MeshSpec
from isotope_tpu_torch.runner.run import protected_window_block
from isotope_tpu_torch.sim import LoadModel
from isotope_tpu_torch.sim import rollout as rollout_mod
from test_torch_attribution import assert_attr_match
from test_torch_policies import (
    assert_policy_summary_equal,
    assert_summaries_match,
)
from test_torch_sharded import (
    assert_attr_twin_close,
    assert_run_twin_close,
)
from test_torch_timeline import assert_timeline_match
from torch_mesh_fleet_world import (
    PROTECTED,
    STORM_QPS,
    WORLDS,
    launch,
    port_sharded,
    twin_runs,
)
from test_torch_replay import JaxReplayDraws
from torch_mesh_world import Recording

KEY = jax.random.PRNGKey(31)
#: a world's processes are killed past this many seconds
WORLD_TIMEOUT_S = 300.0
NAMES = ["prot2", "prot4", "prot8"]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def assert_bit_equal(got, want, what=""):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), (what, i)
        else:
            assert x == y, (what, i)


class _Worlds:
    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.cache = {}

    def get(self, name):
        if name not in self.cache:
            work = self.tmp.mktemp(name)
            store = {}
            twin = twin_runs(name, Recording(JaxReplayDraws(KEY), store))
            np.savez(work / "draws.npz", **store)
            t0 = time.monotonic()
            ranks = launch(name, work, WORLD_TIMEOUT_S)
            spec = WORLDS[name][0]
            self.cache[name] = SimpleNamespace(
                name=name, spec=spec, n_shards=int(np.prod(spec)),
                twin=twin, ranks=ranks, seconds=time.monotonic() - t0,
            )
        return self.cache[name]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory)


def _scenarios(w):
    return WORLDS[w.name][2]


# -- the ranks and the twin ---------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_protected_runs(worlds, name):
    w = worlds.get(name)
    for r, out in enumerate(w.ranks[1:], 1):
        for s in _scenarios(w):
            assert_bit_equal(out[s], w.ranks[0][s], f"rank {r} {s}")
    assert w.seconds < WORLD_TIMEOUT_S


@pytest.mark.parametrize("name", NAMES)
def test_control_series_equal_the_lockstep_twin(worlds, name):
    """The merge rule: the recorder's, policy and rollout series bit
    for bit the twin's."""
    w = worlds.get(name)
    for s in _scenarios(w):
        got, want = w.ranks[0][s], w.twin[s]
        attributed = PROTECTED[s][8].get("attribution", False)
        series = slice(1, -1) if attributed else slice(1, None)
        assert_bit_equal(got[series], want[series], s)


@pytest.mark.parametrize("name", NAMES)
def test_summary_and_blame_merge_with_the_plain_collectives(worlds, name):
    w = worlds.get(name)
    for s in _scenarios(w):
        got, want = w.ranks[0][s], w.twin[s]
        assert_run_twin_close(got[0], want[0], w.n_shards, f"{s}.")
        if PROTECTED[s][8].get("attribution", False):
            assert_attr_twin_close(got[-1], want[-1], w.n_shards)
            assert float(got[-1].tail_cut) == float(want[-1].tail_cut)


@pytest.mark.parametrize("name", NAMES)
def test_the_control_laws_act_on_the_mesh(worlds, name):
    """The cases exercise the laws: the storm's breaker trips and its
    autoscaler scales up; the bad canary rolls back, also under the
    budget with the blame reduced in the same loop."""
    w = worlds.get(name)
    out = w.ranks[0]
    if "policies" in out:
        pol = out["policies"][2]
        assert float(pol.trips.sum()) > 0
        assert float(pol.replicas.max()) > 4
    if "rollouts" in out:
        from torch_mesh_fleet_world import ROLLOUT, _tables

        compiled, kw = _tables(ROLLOUT, "rollouts")
        doc = rollout_mod.to_doc(compiled, out["rollouts"][2],
                                 kw["rollouts"])
        assert doc["services"]["worker"]["rollbacks"] >= 1
    if "composed" in out:
        # (summary, timeline, rollout, policy, blame): the blame of the
        # protected physics rides the same loop
        assert len(out["composed"]) == 5
        assert float(out["composed"][-1].count) > 0
        assert float(out["composed"][2].rollbacks.sum()) >= 1


def test_timeline_counts_cover_every_shard(worlds):
    w = worlds.get("prot8")
    s, tl = w.ranks[0]["policies"][:2]
    assert int(tl.arrivals.sum()) == int(s.count) == PROTECTED[
        "policies"][6]


# -- the twin against the JAX package's --------------------------------------


def _jax_twin(name, mesh):
    graph, params, chaos, which, method, load, n, block, kw = PROTECTED[name]
    jg = JaxGraph.from_yaml(graph)
    jc = jax_compile_graph(jg)
    tables = {}
    if which in ("policies", "both"):
        tables["policies"] = jax_compile_policies(jg, jc)
    if which in ("rollouts", "both"):
        tables["rollouts"] = jax_compile_rollouts(jg, jc)
    sh = JaxSharded(jc, JaxEmulated(JaxMeshSpec(*mesh)), JaxParams(**params),
                    tuple(JaxChaos(**c) for c in chaos), **tables)
    return getattr(sh, method + "_emulated")(JaxLoad(**load), n, KEY,
                                             block_size=block, **kw)


@pytest.mark.parametrize("world,scenario", [
    ("prot2", "policies"), ("prot2", "attributed"), ("prot2", "closed"),
    ("prot2", "composed"), ("prot4", "rollouts"), ("prot4", "policies"),
])
def test_twin_matches_the_jax_twin(worlds, world, scenario):
    w = worlds.get(world)
    got = w.twin[scenario]
    want = _jax_twin(scenario, w.spec)
    assert_summaries_match(got[0], want[0])
    assert_timeline_match(got[1], want[1], f"{scenario} ")
    rest = list(zip(got[2:], want[2:]))
    if PROTECTED[scenario][3] in ("rollouts", "both"):
        g, w = rest.pop(0)
        for f in ("weight", "step", "phase", "promotions", "holds",
                  "rollbacks", "windows_done"):
            np.testing.assert_array_equal(
                np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                err_msg=f)
    if PROTECTED[scenario][3] in ("policies", "both"):
        assert_policy_summary_equal(*rest.pop(0))
    if PROTECTED[scenario][8].get("attribution", False):
        assert_attr_match(*rest.pop(0), float(want[0].latency_sum))
    assert not rest


# -- the runner: ladder, block, svc fallback ---------------------------------


def test_fault_on_one_rank_moves_every_rank_to_the_same_rung(worlds):
    """``oom:sharded.gather:2`` on rank 1 only: both ranks leave the
    sharded and sharded-half-block rungs and end on single-device (the
    lockstep twin) with equal results; ``oom:sharded.compute:1`` on rank
    1 only fails rank 0's first block merge too (rank 1 joins it with
    its status code), so both end on sharded-half-block.  No rank waits
    for a group's timeout."""
    w = worlds.get("prot2")
    for name, rung in (("ladder_gather", "single-device"),
                       ("ladder_compute", "sharded-half-block")):
        a, b = (out[name] for out in w.ranks)
        assert a["out"][-1] == b["out"][-1] == rung, name
        assert_bit_equal(a["out"][:-1], b["out"][:-1], name)
        for out in (a, b):
            assert out["seconds"] < 30.0
            assert out["degradations"] >= 1.0


def test_mesh_protected_run_sizes_its_block_a_shard(worlds):
    """The runner hands a mesh-served protected run
    ``protected_window_block(..., shards=n_shards)``: the window's
    requests divided over the shards (the reference's ``rate * win /
    shards``), so the mesh still acts once a window."""
    w = worlds.get("prot2")
    _, _, _, _, _, load, _, _, kw = PROTECTED["policies"]
    sh = port_sharded("protected", "policies", EmulatedMesh(MeshSpec(2, 1)))
    load = LoadModel(**load)
    win, solo = protected_window_block(sh.sim, load, 65_536, 10.0,
                                       kw["window_s"])
    _, per_shard = protected_window_block(sh.sim, load, 65_536, 10.0,
                                          kw["window_s"], shards=2)
    assert win == kw["window_s"]
    assert solo == int(STORM_QPS * win)
    assert per_shard == int(STORM_QPS * win / 2)
    for out in w.ranks:
        assert out["block"]["blocks"] == [per_shard]


def test_svc_sharded_mesh_falls_back_with_the_reference_warning(worlds):
    w = worlds.get("prot4")
    for out in w.ranks:
        got = out["svc_fallback"]
        assert ("warning: the protected co-sim falls back to the "
                "single-device scan") in got["stderr"]
        assert got["out"][-1] is None
        assert_bit_equal(got["out"][0], got["solo"][0], "summary")
        assert_bit_equal(got["out"][1], got["solo"][1], "timeline")
        assert_bit_equal(got["out"][3], got["solo"][2], "policies")
        assert "svc=1" in got["refusal"]
