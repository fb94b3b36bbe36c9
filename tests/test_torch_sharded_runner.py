"""The port's runner on a device mesh: ``run_experiment`` and ``sweep
--mesh`` in a ``torchrun --standalone`` world of 8 ``gloo`` ranks on the
CPU (``tests/torch_mesh_runner_world.py``, launched once, killed past
``WORLD_TIMEOUT_S``; every group's timeout 60 s), mirroring
``tests/test_multihost.py``'s runner pins.

The ranks draw the JAX runner's case draws (``fold_in(PRNGKey(0), 0)``),
recorded here through the port's emulated twin of the case, so rank 0's
flat row is held to the JAX ``run_experiment``'s on 8 virtual CPU
devices with ``tests/test_torch_runner.py``'s ``flat_close`` (strings,
booleans and counts equal, floats within rtol 1e-5 / atol 1e-9)."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from isotope_tpu.runner import run_experiment as jax_run_experiment
from isotope_tpu.runner.config import DEFAULT_ENVIRONMENTS as JAX_ENVS
from isotope_tpu.runner.config import ExperimentConfig as JaxConfig
from isotope_tpu_torch.parallel import EmulatedMesh, MeshSpec, ShardedSimulator
from isotope_tpu_torch.runner.run import _LazyTopology, num_requests
from isotope_tpu_torch.sim.draws import RootedSource
from test_torch_replay import JaxReplayDraws
from test_torch_runner import flat_close
from torch_mesh_runner_world import CASE, auto_spec, config, launch
from torch_mesh_fleet_world import STORM
from torch_mesh_world import FORK, Recording

#: the world's processes are killed past this many seconds
WORLD_TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("runner-world")
    topo = work / "t.yaml"
    topo.write_text(FORK)
    (work / "storm.yaml").write_text(STORM)
    # the case's draws, recorded through the port's twin of it: the
    # runner's Simulator, request count and block
    cfg = config(topo)
    lazy = _LazyTopology(str(topo), cfg, "cpu")
    env = cfg.environments[0]
    sim = lazy.sims(env)
    (load,) = cfg.load_models()
    store = {}
    source = RootedSource(
        Recording(JaxReplayDraws(jax.random.PRNGKey(cfg.seed)), store), 0
    )
    twin = ShardedSimulator(lazy.compiled,
                            EmulatedMesh(MeshSpec(2, 2, 2)), sim=sim)
    twin.run_emulated(load,
                      num_requests(load, sim.capacity_qps(),
                                   cfg.num_requests),
                      source, block_size=sim.default_block_size(),
                      trim=True)
    np.savez(work / "draws.npz", **store)
    ranks = launch(work, WORLD_TIMEOUT_S)
    (jax_row,), (jax_auto,) = (jax_run_experiment(JaxConfig(
        topology_paths=(str(topo),), environments=(JAX_ENVS["NONE"],),
        mesh_spec=spec, **CASE,
    )) for spec in ("2x2x2", auto_spec()))
    return dict(work=work, ranks=ranks, jax=jax_row.flat,
                jax_auto=jax_auto.flat, topo=topo)


def _flat(out, name):
    assert "error" not in out[name], out[name]
    (flat,) = out[name]["flats"]
    return flat


def test_explicit_mesh_serves_the_case_and_matches_the_jax_runner(world):
    got = _flat(world["ranks"][0], "explicit")
    assert got["_mesh_layout"] == "data=2,svc=2,slice=2"
    assert world["jax"]["_mesh_layout"] == "data=2,svc=2,slice=2"
    flat_close(got, world["jax"], "explicit")


def test_every_rank_returns_rank_zeros_rows(world):
    first = world["ranks"][0]
    for r, out in enumerate(world["ranks"][1:], 1):
        for name in ("explicit", "env", "legacy_world", "legacy_keys",
                     "overlap_on", "overlap_off"):
            a, b = dict(_flat(first, name)), dict(_flat(out, name))
            a.pop("StartTime"), b.pop("StartTime")
            assert a == b, (r, name)


def test_only_rank_zero_writes(world):
    """One checkpoint record, one CSV row, one result line — not one a
    rank; through ``sweep --mesh`` only rank 0 prints, and every rank
    exits 0."""
    out = world["work"] / "out"
    assert len((out / "checkpoint.jsonl").read_text().splitlines()) == 2
    assert len((out / "benchmark.csv").read_text().splitlines()) == 2
    assert len((out / "results.jsonl").read_text().splitlines()) == 1
    cli_out = world["work"] / "cli"
    assert len((cli_out / "checkpoint.jsonl").read_text().splitlines()) == 2
    for r, ranked in enumerate(world["ranks"]):
        got = ranked["cli"]
        assert got["rc"] == 0
        if r == 0:
            assert "1 runs ->" in got["stderr"]
        else:
            assert got["stdout"] == got["stderr"] == "", r
    rows = (cli_out / "results.jsonl").read_text().splitlines()
    assert '"_mesh_layout": "data=2,svc=2,slice=2"' in rows[0]


def test_env_mesh(world):
    assert _flat(world["ranks"][0], "env")["_mesh_layout"] == "data=4,svc=2"


def test_legacy_keys_size_the_mesh_over_the_world(world):
    """``mesh_data`` 0 is the world's ranks over ``mesh_svc``."""
    r0 = world["ranks"][0]
    assert _flat(r0, "legacy_world")["_mesh_layout"] == "data=8,svc=1"
    assert _flat(r0, "legacy_keys")["_mesh_layout"] == "data=2,svc=4"
    # the same shards' draws whatever the factorization: the rate, the
    # extremes and the histogram's quantiles are equal
    keys = ("ActualQPS", "min", "max", "p50", "p90", "p99", "errorPercent")
    rows = {tuple(_flat(r0, n)[k] for k in keys)
            for n in ("explicit", "env", "legacy_world", "legacy_keys")}
    assert len(rows) == 1


def test_bad_mesh_spec_fails_before_simulating(world):
    for out in world["ranks"]:
        assert out["bad_spec"]["error"] == "ValueError"
        assert out["bad_spec"]["message"].startswith("mesh")
        assert out["too_big"]["error"] == "ValueError"
        assert ("mesh: mesh data=4,svc=4 needs 16 devices, have 8"
                in out["too_big"]["message"])


def test_overlap_config_round_trip(world):
    assert dataclasses.replace(config("t.yaml"),
                               overlap=True).sim_params().overlap
    r0 = world["ranks"][0]
    on, off = _flat(r0, "overlap_on"), _flat(r0, "overlap_off")
    assert on["_mesh_layout"] == off["_mesh_layout"]
    flat_close(on, off, "overlap")


def test_mesh_auto_and_a_mesh_served_fleet_name_item_11b(world):
    """``--mesh auto`` runs the layout search on every rank (8 ranks on
    one host, the topology's 4 services) and serves the case at the
    chosen spec, the port's search called outside the world: rank 0
    alone prints the choice, every rank's row equals the explicit run
    at that spec, and rank 0's is held to the JAX runner's at that
    spec with ``flat_close``.  A mesh-served fleet is served
    (``test_mesh_served_fleets_equal_one_device``)."""
    spec = auto_spec()
    line = f"mesh auto: {world['topo']} -> {spec} (score "
    for r, out in enumerate(world["ranks"]):
        got = _flat(out, "auto")
        assert got["_mesh_layout"] == spec
        assert (line in out["auto"]["stderr"]) == (r == 0), r
        assert (_without(got, "StartTime")
                == _without(_flat(out, "auto_explicit"), "StartTime"))
        assert "error" not in out["ensemble@2x2x2"]
        assert _flat(out, "ensemble@2x2x2")["_ensemble"] == 4
    assert world["jax_auto"]["_mesh_layout"] == spec
    flat_close(_flat(world["ranks"][0], "auto"), world["jax_auto"], "auto")


def _docs(world, case, suffix):
    """Rank 0's ``*.<suffix>.json`` documents of a case's sweep."""
    return [json.loads(p.read_text()) for p in
            sorted((world["work"] / case).glob(f"*.{suffix}.json"))]


def _without(row, *keys):
    return {k: v for k, v in row.items() if k not in keys}


@pytest.mark.parametrize("case", ["ensemble", "split"])
def test_mesh_served_fleets_equal_one_device(world, case):
    """A fleet (and its splitting pass) swept at ``--mesh 2x2x2``: the
    members spread over the 8 ranks, their stacks gathered; every
    rank's row, and rank 0's ensemble document but its chunk, equal the
    same sweep at ``--mesh 1x1``."""
    solo = _flat(world["ranks"][0], f"{case}@1x1")
    assert "_mesh_layout" not in solo
    for out in world["ranks"]:
        mesh = _flat(out, f"{case}@2x2x2")
        assert mesh["_mesh_layout"] == "data=2,svc=2,slice=2"
        assert (_without(mesh, "_mesh_layout", "StartTime")
                == _without(solo, "StartTime"))
    (got,), (want,) = (_docs(world, f"{case}@{m}", "ensemble")
                       for m in ("2x2x2", "1x1"))
    # the members a rank folds at a time: 4 members over 8 ranks
    assert (got.pop("chunk"), want.pop("chunk")) == (1, 4)
    assert got == want
    if case == "split":
        assert got["splitting"]["schema"].startswith("isotope-splitting")


def test_mesh_served_bracket_equals_one_device(world):
    """The search bracket of a case on the mesh: the same lineage (every
    rung's candidates, severities and survivors) and winner as at
    ``--mesh 1x1``; only each rung's chunk (the mesh's width a rank)
    differs."""
    (got,), (want,) = (_docs(world, f"search@{m}", "search")
                       for m in ("2x2x2", "1x1"))
    for doc in (got, want):
        for rung in doc["lineage"]:
            rung.pop("chunk")
    assert got == want and len(got["lineage"]) == 2
    for out in world["ranks"]:
        assert _flat(out, "search@2x2x2")["_search"] == 8


def test_protected_case_on_a_svc_mesh_falls_back_to_one_device(world):
    """svc=2 splits the per-service layout the replicated control state
    needs: the case runs the single-device scan, with the reference's
    warning (printed by rank 0, as every line of a mesh sweep), and its
    row equals the one-device sweep's on every rank."""
    solo = _flat(world["ranks"][0], "policies@1x1")
    assert solo["_policies"] is True
    warning = ("warning: the protected co-sim falls back to the "
               "single-device scan")
    for r, out in enumerate(world["ranks"]):
        got = out["policies@2x2x2"]
        assert (warning in got["stderr"]) == (r == 0), r
        mesh = _flat(out, "policies@2x2x2")
        assert (_without(mesh, "_mesh_layout", "StartTime")
                == _without(solo, "StartTime"))
