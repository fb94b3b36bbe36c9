"""The port's mesh-served fleets, search brackets and splitting passes
(``isotope_tpu_torch/parallel/sharded.py``, ``sim/search.py``) in
``gloo`` worlds on the CPU, against the port's emulated twins, its solo
fleets and the JAX package's twins.

Three worlds, each launched once (``tests/torch_mesh_fleet_world.py``,
one process per rank, every group's timeout 60 s, the world killed at
``WORLD_TIMEOUT_S``): data=2, data=2 x svc=2 and data=2 x svc=2 x
slice=2.  Each runs a jittered fleet member by member (``"map"``) and
folded (``"vmap"``), a paced closed fleet, a chaos fleet
(``member_chaos``), an observed fleet (tail blame and the recorder), a
protected policy fleet under a kill, a rollout fleet, a search bracket
and a splitting pass.  Members are whole runs, so the mesh spreads the
member axis and gathers the member stacks (no sum), and the tolerances
are:

- every rank returns the same results, bit for bit;
- the collective path equals the port's emulated twin bit for bit
  (the bracket's lineage and every rung's summaries too), and the twin
  equals the port's solo fleet at the twin's chunk bit for bit (member
  k of the mesh is solo member k);
- the twin against the JAX ``ShardedSimulator``'s twin on the same
  draws: the fleets' tolerances of ``tests/test_torch_ensemble.py``,
  ``test_torch_fleetblame.py`` and ``test_torch_chaosfleet.py``
  (integers exactly, floats within rtol 1e-5 / atol 1e-9 s, the
  attribution and timeline bands, policy series equal), the bracket's
  lineage equal (on the reference's tie-break uniforms), the splitting
  document equal.
"""
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.parallel import EmulatedMesh as JaxEmulated
from isotope_tpu.parallel import MeshSpec as JaxMeshSpec
from isotope_tpu.parallel import ShardedSimulator as JaxSharded
from isotope_tpu.resilience.faults import ChaosJitterSpec as JaxJitter
from isotope_tpu.runner.run import _splitting_pass as jax_splitting_pass
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import ensemble as jax_ens
from isotope_tpu.sim import search as jax_search
from isotope_tpu.sim import splitting as jax_split
from isotope_tpu.sim.config import ChaosEvent as JaxChaos
from isotope_tpu_torch.parallel import EmulatedMesh, MeshSpec
from isotope_tpu_torch.sim import search
from isotope_tpu_torch.sim.ensemble import member_summary
from test_torch_attribution import assert_attr_match
from test_torch_ensemble import assert_stacks
from test_torch_policies import assert_policy_summary_equal
from test_torch_replay import JaxReplayDraws
from test_torch_timeline import assert_timeline_match
from torch_mesh_fleet_world import (
    FLEETS,
    SPLIT_JITTER,
    SPLIT_SPEC,
    WORLDS,
    launch,
    port_sharded,
    run_fleet,
    twin_runs,
)
from torch_mesh_world import Recording

KEY = jax.random.PRNGKey(29)
#: a world's processes are killed past this many seconds
WORLD_TIMEOUT_S = 300.0
NAMES = ["fleet2", "fleet4", "fleet8"]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, np.ndarray):
        return [torch.from_numpy(x)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for f in x.__dataclass_fields__
                for t in _leaves(getattr(x, f))]
    return [x]


def assert_bit_equal(got, want, what=""):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, \
                (what, i)
            assert torch.equal(x, y), (what, i)
        else:
            assert x == y, (what, i)


class _Worlds:
    """Each world launched on first use, once for the module; the draws
    recorded through the port's twin of the world's mesh."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.cache = {}

    def get(self, name):
        if name not in self.cache:
            self.cache[name] = self._launch(name)
        return self.cache[name]

    def _launch(self, name):
        work = self.tmp.mktemp(name)
        store = {}
        twin = twin_runs(name, Recording(JaxReplayDraws(KEY), store))
        np.savez(work / "draws.npz", **store)
        t0 = time.monotonic()
        ranks = launch(name, work, WORLD_TIMEOUT_S)
        return SimpleNamespace(name=name, spec=WORLDS[name][0], twin=twin,
                               ranks=ranks,
                               seconds=time.monotonic() - t0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _Worlds(tmp_path_factory)


# -- the ranks and the twin ---------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_fleets(worlds, name):
    w = worlds.get(name)
    for r, out in enumerate(w.ranks[1:], 1):
        for s in FLEETS:
            assert_bit_equal(out[s], w.ranks[0][s], f"rank {r} {s}")
    assert w.seconds < WORLD_TIMEOUT_S


@pytest.mark.parametrize("name", NAMES)
def test_mesh_fleets_equal_the_emulated_twin(worlds, name):
    """Fleets, observed, chaos, closed and protected fleets: every
    member's summary, series and blame bit for bit, and the chunk."""
    w = worlds.get(name)
    for s in FLEETS:
        if s in ("search", "split"):
            continue
        got, want = w.ranks[0][s], w.twin[s]
        assert got.chunk == want.chunk, s
        assert_bit_equal(
            (got.summaries, got.timelines, got.policies, got.rollouts,
             got.attributions, got.offered_qps),
            (want.summaries, want.timelines, want.policies, want.rollouts,
             want.attributions, want.offered_qps), s,
        )
        if got.member_chaos is not None:
            assert got.member_chaos == want.member_chaos


@pytest.mark.parametrize("name", NAMES)
def test_mesh_bracket_lineage_equals_the_emulated_twin(worlds, name):
    w = worlds.get(name)
    got, want = w.ranks[0]["search"], w.twin["search"]
    assert got.to_doc("x") == want.to_doc("x")
    assert got.winner == want.winner
    for a, b in zip(got.rungs, want.rungs):
        assert a.chunk == b.chunk
        assert_bit_equal((a.candidates, a.severity, a.survivors, a.order,
                          a.summaries),
                         (b.candidates, b.severity, b.survivors, b.order,
                          b.summaries), f"rung {a.rung}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_splitting_equals_the_solo_pass(worlds, name):
    w = worlds.get(name)
    assert w.ranks[0]["split"] == w.twin["split"]
    assert w.twin["split"]["schema"].startswith("isotope-splitting")


def test_fleet_geometry_balances_the_rounds(worlds):
    """``per_shard = ceil(M / n_shards)`` in balanced rounds of at most
    the chunk: a chunk of the fleet per (round, shard), members in
    order; a rank with none runs a pad (the reference's law)."""
    sh = port_sharded("fleets", "fleet", EmulatedMesh(MeshSpec(2, 2, 2)))
    assert sh.fleet_geometry(6, 64) == (1, 1)
    assert sh.fleet_geometry(20, 64) == (3, 1)
    assert sh.fleet_geometry(20, 2) == (2, 2)
    assert sh.fleet_geometry(33, 2) == (2, 3)
    rows = [sh.shard_members(33, 2, 3, s) for s in range(8)]
    assert rows[0] == [0, 1, 16, 17, 32]
    assert rows[7] == [14, 15, 30, 31]
    assert sorted(sum(rows, [])) == list(range(33))
    assert sh.shard_members(6, 1, 1, 7) == []
    # the fleets ran with 6 members over 8 ranks: two ranks padded
    w = worlds.get("fleet8")
    assert w.ranks[7]["fleet"].summaries.count.shape == (6,)


# -- member k of the mesh is solo member k -----------------------------------


@pytest.mark.parametrize("scenario", ["fleet_vmap", "observed", "policies"])
def test_mesh_member_equals_the_solo_folded_member(worlds, scenario):
    """The folded fleet (chunks of the mesh fleet's width) run solo on
    the same draws: member k bit for bit the mesh's member k."""
    w = worlds.get("fleet4")
    got = w.ranks[0][scenario]
    sh = port_sharded("fleets", scenario, EmulatedMesh(MeshSpec(1, 1)))
    from isotope_tpu_torch.sim import LoadModel
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    _, _, _, _, method, load, n, block, spec_kw, kw = FLEETS[scenario]
    spec_kw = dict(spec_kw)
    spec = EnsembleSpec.from_jitter(spec_kw.pop("members"), **spec_kw)
    solo = getattr(sh.sim, method)(LoadModel(**load), n,
                                   JaxReplayDraws(KEY), spec,
                                   block_size=block, chunk=got.chunk, **kw)
    for k in range(spec.members):
        assert_bit_equal(
            (member_summary(got.summaries, k), got.member_timeline(k)
             if got.timelines is not None else None,
             got.member_attribution(k) if got.attributions is not None
             else None,
             got.member_policies(k) if got.policies is not None else None),
            (member_summary(solo.summaries, k), solo.member_timeline(k)
             if solo.timelines is not None else None,
             solo.member_attribution(k) if solo.attributions is not None
             else None,
             solo.member_policies(k) if solo.policies is not None
             else None),
            f"member {k}",
        )


# -- the twin against the JAX package's -------------------------------------


def _jax_sharded(graph, params, chaos=(), pol=False, mesh=(2, 1, 1)):
    jg = JaxGraph.from_yaml(graph)
    jc = jax_compile_graph(jg)
    return JaxSharded(
        jc, JaxEmulated(JaxMeshSpec(*mesh)), JaxParams(**params),
        tuple(JaxChaos(**c) for c in chaos),
        policies=jax_compile_policies(jg, jc) if pol else None,
    )


def _jax_fleet(scenario):
    graph, params, chaos, which, method, load, n, block, spec_kw, kw = (
        FLEETS[scenario]
    )
    spec_kw = dict(spec_kw, mode="map")
    spec = jax_ens.EnsembleSpec.from_jitter(spec_kw.pop("members"),
                                            **spec_kw)
    sh = _jax_sharded(graph, params, chaos, pol=which == "policies")
    return getattr(sh, method + "_emulated")(JaxLoad(**load), n, KEY, spec,
                                             block_size=block, **kw)


@pytest.mark.parametrize("scenario", ["fleet", "closed"])
def test_twin_fleet_matches_the_jax_twin(worlds, scenario):
    got = worlds.get("fleet2").twin[scenario]
    want = _jax_fleet(scenario)
    assert_stacks(got.summaries, want.summaries)
    np.testing.assert_allclose(got.offered_qps, want.offered_qps,
                               rtol=1e-6)


def test_twin_observed_fleet_matches_the_jax_twin(worlds):
    got = worlds.get("fleet2").twin["observed"]
    want = _jax_fleet("observed")
    assert_stacks(got.summaries, want.summaries)
    for k in range(got.members):
        lat_sum = float(np.asarray(want.summaries.latency_sum)[k])
        assert_attr_match(got.member_attribution(k),
                          want.member_attribution(k), lat_sum)
        assert_timeline_match(got.member_timeline(k),
                              want.member_timeline(k), f"member {k} ")


def test_twin_protected_fleet_matches_the_jax_twin(worlds):
    got = worlds.get("fleet2").twin["policies"]
    want = _jax_fleet("policies")
    assert_stacks(got.summaries, want.summaries)
    for k in range(got.members):
        assert_timeline_match(got.member_timeline(k),
                              want.member_timeline(k), f"member {k} ")
        assert_policy_summary_equal(got.member_policies(k),
                                    want.member_policies(k))


def test_twin_bracket_matches_the_jax_twin(monkeypatch):
    """On the reference's tie-break uniforms the port's twin picks the
    JAX twin's survivors at every rung."""
    def draws(spec, device="cpu"):
        jspec = jax_search.SearchSpec.from_dict(spec.to_dict())
        return torch.from_numpy(
            np.asarray(jax_search.tiebreak_draws(jspec)).copy()
        ).to(device)

    monkeypatch.setattr(search, "tiebreak_draws", draws)
    sh = port_sharded("fleets", "search", EmulatedMesh(MeshSpec(2, 1, 1)))
    got = run_fleet("search", sh, JaxReplayDraws(KEY), True)
    graph, params, _, _, _, load, n, block, spec_kw, kw = FLEETS["search"]
    spec_kw = dict(spec_kw)
    jspec = jax_search.SearchSpec(
        candidates=jax_ens.EnsembleSpec.from_jitter(spec_kw.pop("members"),
                                                    **spec_kw), **kw)
    want = _jax_sharded(graph, params).run_search_emulated(
        JaxLoad(**load), n, KEY, jspec, block_size=block)
    assert got.winner == want.winner
    for a, b in zip(got.rungs, want.rungs):
        np.testing.assert_array_equal(a.candidates, np.asarray(b.candidates))
        np.testing.assert_array_equal(a.survivors, np.asarray(b.survivors))
        np.testing.assert_allclose(a.severity, np.asarray(b.severity),
                                   rtol=1e-5, atol=1e-9)
        assert_stacks(a.summaries, b.summaries,
                      exact=("count", "error_count", "hop_events"),
                      close=("latency_sum", "latency_min", "latency_max"))


def test_twin_splitting_matches_the_reference(worlds):
    graph, _, chaos, _, _, load, n, block, _, _ = FLEETS["split"]
    jc = jax_compile_graph(JaxGraph.from_yaml(graph))
    jchaos = tuple(JaxChaos(**c) for c in chaos)
    want = jax_splitting_pass(
        JaxSimulator(jc, chaos=jchaos), None, False,
        SimpleNamespace(compiled=jc), JaxLoad(**load), n, KEY, block,
        SimpleNamespace(chaos=jchaos, timeline_window_s=10.0), None,
        False, None, jax_split.SplitSpec(**SPLIT_SPEC),
        JaxJitter(**SPLIT_JITTER),
    )
    assert want is not None
    assert worlds.get("fleet2").twin["split"] == want

