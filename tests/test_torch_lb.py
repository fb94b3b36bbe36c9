"""The port's load-balancing laws (``sim/lb.py``) against the JAX package.

The host layer (decode, tables, profile, signature, the numpy mirror,
the report) is a copy and must give identical values.  The device
layer (``wait_params``, ``panic_split``) runs in torch in the
reference's float32 order of operations: held to rtol 1e-5.  Engine
runs replay the JAX engine's draws (``tests/test_torch_replay.py``,
the panic coins included) and hold the port to the reference with the
engine tests' tolerances (booleans exactly, floats within rtol 1e-5 and
atol 1e-9 s), except where a backend is past capacity: the mixture law
then clamps that backend's rho at 0.9999 and the wait
``-log(u / p) / rate`` of a station whose rate is ~1.8/s moves by
~7e-8 s per float32 spacing of ``u / p``, which XLA and torch round
differently in ``log``; such a run is held to four such spacings over
its slowest clamped rate (the clamped-station bound of
``tests/test_torch_churn_mtls.py``).
"""
import dataclasses
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_lb as jax_compile_lb
from isotope_tpu.metrics import fortio as jax_fortio
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import lb as jax_lb
from isotope_tpu.sim.feedback import np_mmk
from isotope_tpu_torch import cli
from isotope_tpu_torch.compiler import compile_graph, compile_lb
from isotope_tpu_torch.metrics import fortio
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim import lb as lb_mod
from isotope_tpu_torch.sim.config import ChaosEvent
from test_sparse_tiles import SKEWED
from test_torch_replay import (
    JaxReplayDraws,
    port_compiled,
    run_both,
    scenario_pair,
    summaries_both,
)

MU = 1.0 / SimParams().cpu_time_s
KEY = jax.random.PRNGKey(5)

BASE = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 8
  script:
  - call: worker
  - - call: cache
    - call: store
- name: worker
  numReplicas: 4
- name: cache
  numReplicas: 4
- name: store
  numReplicas: 4
"""

# one policies block per law; at 20,000 qps no backend is past capacity
# (the hottest: the ring's first arc, 0.529 x 20,000 = 10,577/s of
# 13,000/s)
LAWS = {
    "least_request": "policies:\n  defaults:\n    lb: least_request\n",
    "least_request-d1-d3": (
        "policies:\n  worker:\n"
        "    lb: {policy: least_request, choices_d: 1}\n"
        "  cache:\n    lb: {policy: least_request, choices_d: 3}\n"
    ),
    "ring_hash": (
        "policies:\n  cache:\n    lb: {policy: ring_hash, hash_skew: 1.2}\n"
    ),
    "wrr": "policies:\n  store:\n    lb: {policy: wrr, weights: [3, 1, 1, 1]}\n",
    "mixed": (
        "policies:\n  defaults:\n"
        "    lb: {policy: least_request, panic_threshold: 50%}\n"
        "  cache:\n    lb: {policy: ring_hash, hash_skew: 1.2}\n"
        "  store:\n    lb: {policy: wrr, weights: [3, 1, 1, 1]}\n"
    ),
}

PANIC = (
    "policies:\n  defaults:\n"
    "    lb: {policy: least_request, choices_d: 2, panic_threshold: 50%}\n"
    "  cache:\n    lb: {policy: ring_hash, hash_skew: 1.2}\n"
)
# 3 of worker's 4 replicas down: 25% healthy, below the 50% threshold
WORKER_DOWN = dict(service="worker", start_s=0.05, end_s=0.2,
                   replicas_down=3)


def pair(yaml_text):
    """(JAX graph, JAX compiled, JAX lb tables, port lb tables)."""
    jg = JaxGraph.from_yaml(yaml_text)
    jc = jax_compile_graph(jg)
    pg = ServiceGraph.from_yaml(yaml_text)
    return jg, jc, jax_compile_lb(jg, jc), compile_lb(pg, compile_graph(pg))


def port_chaos(*kws):
    return tuple(ChaosEvent(**kw) for kw in kws)


def clamped_atol(sim, qps):
    """Four float32 spacings of ``u / p`` over the slowest wait rate of a
    station the law flags past capacity (atol 1e-9 s when none is)."""
    lam = qps * sim._visits_pc
    qp = lb_mod.wait_params(sim._lb, sim._lb_dev, lam, sim._mu,
                            sim._replicas_pc, sim._k_max)
    rates = qp.wait_rate[qp.unstable]
    if not len(rates):
        return 1e-9
    return 4.0 * 2.0**-23 / float(rates.min())


# -- the fault: simulate applies the topology's laws --------------------------


def test_cli_simulate_applies_the_lb_laws(tmp_path):
    """``simulate --device cpu`` on a topology that declares an active
    ``lb:`` law prints the document of ``Simulator(lb=compile_lb(...))``
    (before the laws were ported it printed the fifo run's), which
    differs from the fifo run's, and the port's lb run equals the JAX
    ``Simulator(lb=...)`` run on the same draws."""
    topo = BASE + LAWS["least_request"]
    path = tmp_path / "lr.yaml"
    path.write_text(topo)
    fifo_path = tmp_path / "fifo.yaml"
    fifo_path.write_text(BASE)
    argv = ["--qps", "20000", "--duration", "0.2s", "--load-kind", "open",
            "--device", "cpu"]

    def simulate(p):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            assert cli.main(["simulate", str(p)] + argv) == 0
        return json.loads(out.getvalue()), err.getvalue()

    got, err = simulate(path)
    fifo, fifo_err = simulate(fifo_path)
    assert "least_request" in err and "lb:" not in fifo_err

    graph = ServiceGraph.from_yaml(topo)
    compiled = compile_graph(graph)
    sim = Simulator(compiled, lb=compile_lb(graph, compiled), device="cpu")
    load = LoadModel(kind="open", qps=20_000.0, duration_s=0.2)
    summary = sim.run_summary(load, 4000, TorchDraws(0, "cpu"),
                              block_size=sim.default_block_size(),
                              trim=True)
    want = fortio.fortio_result_from_summary(
        summary, load, labels=got["Labels"],
        response_size_bytes=float(
            compiled.services.response_size[compiled.entry_service]),
    )
    # the documents differ only in their wall-clock start stamp
    got.pop("StartTime")
    want.pop("StartTime")
    assert got == json.loads(json.dumps(want))
    assert got["DurationHistogram"] != fifo["DurationHistogram"]

    # the same law in both packages, on the same draws
    _, jc, jt, pt = pair(topo)
    jax_sim, port_sim = scenario_pair(jc, lb=(jt, pt))
    want_s = jax_sim.run_summary(JaxLoad(kind="open", qps=20_000.0), 2048,
                                 KEY, block_size=1024)
    got_s = summaries_both(jax_sim, port_sim, 2048, KEY, 1024,
                           kind="open", qps=20_000.0)
    doc_j = jax_fortio.fortio_result_from_summary(
        want_s, JaxLoad(kind="open", qps=20_000.0), labels="lr")
    doc_p = fortio.fortio_result_from_summary(
        got_s, LoadModel(kind="open", qps=20_000.0), labels="lr")
    assert doc_p.keys() == doc_j.keys()
    assert doc_p["RetCodes"] == doc_j["RetCodes"]
    for a, b in zip(doc_p["DurationHistogram"]["Percentiles"],
                    doc_j["DurationHistogram"]["Percentiles"]):
        np.testing.assert_allclose(a["Value"], b["Value"], rtol=1e-5)


def test_cli_lb_out_and_qps_max(tmp_path):
    """``--lb-out`` writes the law document; ``--qps max`` under an
    active law raises the reference's error; ``--lb-out`` on a topology
    without laws warns, as the JAX command does."""
    path = tmp_path / "mixed.yaml"
    path.write_text(BASE + LAWS["mixed"])
    out_json = tmp_path / "lb.json"
    err = io.StringIO()
    with redirect_stdout(io.StringIO()), redirect_stderr(err):
        assert cli.main(["simulate", str(path), "--qps", "20000",
                         "--duration", "0.05s", "--load-kind", "open",
                         "--lb-out", str(out_json), "--device", "cpu"]) == 0
    _, _, jt, _ = pair(BASE + LAWS["mixed"])
    assert json.loads(out_json.read_text()) == json.loads(
        json.dumps(jax_lb.to_doc(jt)))
    assert jax_lb.format_table(jax_lb.to_doc(jt)) in err.getvalue()
    assert f"lb -> {out_json}" in err.getvalue()
    with pytest.raises(ValueError, match="-qps max"):
        cli.main(["simulate", str(path), "--qps", "max", "--device", "cpu"])
    fifo = tmp_path / "fifo.yaml"
    fifo.write_text(BASE)
    err = io.StringIO()
    with redirect_stdout(io.StringIO()), redirect_stderr(err):
        cli.main(["simulate", str(fifo), "--qps", "1000", "--duration",
                  "0.05s", "--load-kind", "open", "--lb-out",
                  str(tmp_path / "none.json"), "--device", "cpu"])
    assert "declares no lb entries" in err.getvalue()


# -- the host layer, a copy ----------------------------------------------------


@pytest.mark.parametrize("raw", [
    "least_request", "ring_hash", "wrr", "fifo",
    {"policy": "least_request", "choices_d": 3, "panic_threshold": "40%"},
    {"policy": "ring_hash", "hash_skew": 1.2},
    {"policy": "wrr", "weights": [3, 1, 1, 1], "panic_threshold": 0.25},
    {"policy": "fifo", "panic_threshold": "50%"},
])
def test_decode_matches_reference(raw):
    got = lb_mod.LbPolicy.decode(raw)
    want = jax_lb.LbPolicy.decode(raw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.kind, got.active) == (want.kind, want.active)


BAD = [
    ("policy", {"policy": "wrr", "spread": 2}),
    ("policy", "bogus"),
    ("policy", {"policy": "ring_hash", "choices_d": 2}),
    ("policy", {"policy": "wrr", "hash_skew": 1.0}),
    ("policy", {"policy": "least_request", "weights": [1, 2]}),
    ("policy", {"policy": "wrr", "weights": [1, 0]}),
    ("policy", {"policy": "least_request", "choices_d": 0}),
    ("policy", {"policy": "ring_hash", "hash_skew": -1}),
    ("policy", 3),
    ("set", {"ghost": {"lb": "fifo"}}),
    ("set", []),
    ("graph", "policies:\n  worker:\n"
              "    lb: {policy: least_request, choices_d: 0}\n"),
]


@pytest.mark.parametrize("where,raw", BAD)
def test_decode_rejects_like_reference(where, raw):
    """Bad entries raise the reference's messages, with its key paths
    through the graph decode."""
    def msg(mod, compile_graph_fn, graph_cls, compile_lb_fn):
        with pytest.raises(ValueError) as e:
            if where == "policy":
                mod.LbPolicy.decode(raw)
            elif where == "set":
                mod.LbSet.decode(raw, ["entry", "worker"])
            else:
                g = graph_cls.from_yaml(BASE + raw)
                compile_lb_fn(g, compile_graph_fn(g))
        return str(e.value)

    got = msg(lb_mod, compile_graph, ServiceGraph, compile_lb)
    want = msg(jax_lb, jax_compile_graph, JaxGraph, jax_compile_lb)
    assert got == want
    if where == "graph":
        assert "policies.worker.lb" in got


def test_lbset_defaults_null_and_lint():
    raw = {"defaults": {"lb": "least_request"},
           "worker": {"lb": {"policy": "ring_hash", "hash_skew": 1.2}},
           "cache": {"lb": None}, "store": {"breaker": {}}}
    names = ["entry", "worker", "cache", "store"]
    got = lb_mod.LbSet.decode(raw, names)
    want = jax_lb.LbSet.decode(raw, names)
    for n in names:
        a, b = got.for_service(n), want.for_service(n)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert got.for_service("cache") is None
    assert got.empty == want.empty is False
    assert lb_mod.lint_lb({"ghost": {"lb": "x"}}, names)[1] == \
        jax_lb.lint_lb({"ghost": {"lb": "x"}}, names)[1]


@pytest.mark.parametrize("law", sorted(LAWS))
def test_build_tables_profile_and_signature(law):
    _, _, jt, pt = pair(BASE + LAWS[law])
    for f in dataclasses.fields(jt):
        np.testing.assert_array_equal(
            np.asarray(getattr(pt, f.name)), np.asarray(getattr(jt, f.name)),
            err_msg=f.name)
    assert pt.signature() == jt.signature()
    for prop in ("any_lr", "any_mix", "any_panic", "active"):
        assert getattr(pt, prop) == getattr(jt, prop), prop
    for k in (1, 4, 7):
        np.testing.assert_array_equal(pt.backend_profile(k),
                                      jt.backend_profile(k))


def test_compile_lb_none_without_entries():
    assert pair(BASE)[3] is None
    # a policies block without lb entries compiles no lb tables
    assert pair(BASE + "policies:\n  worker:\n"
                "    breaker: {max_pending: 8}\n")[3] is None


# -- the laws ------------------------------------------------------------------

GRID_LAWS = {
    "lr-d1": "policies:\n  worker:\n    lb: {policy: least_request, choices_d: 1}\n",
    "lr-d2": "policies:\n  worker:\n    lb: {policy: least_request, choices_d: 2}\n",
    "lr-d3": "policies:\n  worker:\n    lb: {policy: least_request, choices_d: 3}\n",
    "ring-0": "policies:\n  worker:\n    lb: {policy: ring_hash, hash_skew: 0}\n",
    "ring-1.2": "policies:\n  worker:\n    lb: {policy: ring_hash, hash_skew: 1.2}\n",
    "ring-2": "policies:\n  worker:\n    lb: {policy: ring_hash, hash_skew: 2.0}\n",
    "wrr-3111": "policies:\n  worker:\n    lb: {policy: wrr, weights: [3, 1, 1, 1]}\n",
    "wrr-12": "policies:\n  worker:\n    lb: {policy: wrr, weights: [1, 2]}\n",
    "mixed": LAWS["mixed"],
}
# per-station rho of the worker (4 replicas) and the others
RHOS = np.array([1e-4, 0.05, 0.3, 0.5, 0.7, 0.85, 0.95, 0.99, 1.2])


def _tables(law, k_max=8):
    _, _, jt, pt = pair(BASE + GRID_LAWS[law])
    return (jt, jax_lb.device_tables(jt, k_max), pt,
            lb_mod.device_tables(pt, k_max, "cpu"))


@pytest.mark.parametrize("law", sorted(GRID_LAWS))
def test_wait_params_panic_split_and_mirror_match_reference(law):
    """Over a grid of rho and pool sizes, the torch laws equal the JAX
    ones within rtol 1e-5 (booleans exactly) and the numpy mirror equals
    the reference's exactly."""
    jt, jd, pt, pd = _tables(law)
    k = np.array([[8, 4, 4, 4], [8, 3, 2, 1], [2, 4, 1, 3]], np.int32)
    lam = (RHOS[:, None, None] * k[None] * MU).reshape(-1, 4)
    kk = np.tile(k, (len(RHOS), 1))
    want = jax_lb.wait_params(jt, jd, jnp.asarray(lam, jnp.float32), MU,
                              jnp.asarray(kk), 8)
    got = lb_mod.wait_params(pt, pd, torch.tensor(lam, dtype=torch.float32),
                             MU, torch.tensor(kk), 8)
    for f in ("p_wait", "wait_rate", "utilization"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(got.unstable.numpy(),
                                  np.asarray(want.unstable))

    alive = np.floor(kk * np.linspace(0.0, 1.0, kk.size).reshape(kk.shape))
    total = kk.astype(np.float32)
    lam_j, pf_j = jax_lb.panic_split(jd, jnp.asarray(lam, jnp.float32),
                                     jnp.asarray(alive, jnp.float32),
                                     jnp.asarray(total))
    lam_p, pf_p = lb_mod.panic_split(
        pd, torch.tensor(lam, dtype=torch.float32),
        torch.tensor(alive, dtype=torch.float32), torch.tensor(total))
    np.testing.assert_array_equal(lam_p.numpy(), np.asarray(lam_j))
    np.testing.assert_array_equal(pf_p.numpy(), np.asarray(pf_j))

    prof = pt.backend_profile(8)
    for row in range(0, len(lam), 5):
        got_np = lb_mod.np_wait_stats(pt, prof, lam[row], MU, kk[row])
        want_np = jax_lb.np_wait_stats(jt, jt.backend_profile(8), lam[row],
                                       MU, kk[row])
        for a, b in zip(got_np, want_np):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pin", ["d1-exact-mm1", "wrr-uniform-is-d1"])
def test_law_pins(pin):
    """The reference's closed-form anchors, on the port: d = 1 is the
    exact M/M/1 (P(wait) = rho, rate mu (1 - rho)); uniform wrr is the
    d = 1 law, and weights are scale-free."""
    lam = torch.tensor([[200.0, 0.95 * 4 * MU, 1.0, 1.0]])
    k = torch.tensor([[8, 4, 4, 4]])
    _, _, pt, pd = _tables("lr-d1")
    qp = lb_mod.wait_params(pt, pd, lam, MU, k, 8)
    if pin == "d1-exact-mm1":
        assert np.isclose(float(qp.p_wait[0, 1]), 0.95, rtol=1e-4)
        assert np.isclose(float(qp.wait_rate[0, 1]), MU * 0.05, rtol=1e-3)
        return
    lam = torch.tensor([[100.0, 0.8 * 4 * MU, 1.0, 1.0]])
    qp1 = lb_mod.wait_params(pt, pd, lam, MU, k, 8)
    outs = []
    for weights in ("", ", weights: [2, 2, 2, 2]"):
        _, _, t, _ = pair(BASE + "policies:\n  worker:\n"
                          f"    lb: {{policy: wrr{weights}}}\n")
        outs.append(lb_mod.wait_params(
            t, lb_mod.device_tables(t, 8, "cpu"), lam, MU, k, 8))
    np.testing.assert_allclose(outs[0].p_wait[0, 1], qp1.p_wait[0, 1],
                               rtol=1e-5)
    np.testing.assert_allclose(outs[0].wait_rate[0, 1],
                               qp1.wait_rate[0, 1], rtol=1e-4)
    assert torch.equal(outs[0].p_wait, outs[1].p_wait)


# -- engine runs ---------------------------------------------------------------


@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("kind", ["open", "closed"])
def test_engine_matches_reference(law, kind):
    _, jc, jt, pt = pair(BASE + LAWS[law])
    jax_sim, sim = scenario_pair(jc, lb=(jt, pt))
    load = (dict(kind="open", qps=20_000.0) if kind == "open"
            else dict(kind="closed", qps=15_000.0, connections=16))
    got = run_both(jax_sim, sim, 1024, KEY, **load)
    # an active law moves the waits away from the fifo law's
    fifo = Simulator(sim.compiled, device="cpu").run(
        LoadModel(**load), 1024, JaxReplayDraws(KEY))
    assert not torch.equal(got.hop_latency, fifo.hop_latency)


def test_hot_ring_arc_matches_reference_within_its_conditioning():
    """At 30,000 qps the ring's first arc takes 0.529 x 30,000 = 15,870/s
    of one replica's 13,000/s: the law flags the station unstable and
    clamps the arc's rho; floats are held to four spacings over its
    clamped wait rate (module docstring)."""
    _, jc, jt, pt = pair(BASE + LAWS["mixed"])
    jax_sim, sim = scenario_pair(jc, lb=(jt, pt))
    atol = clamped_atol(sim, 30_000.0)
    assert 1e-7 < atol < 1e-6
    got = run_both(jax_sim, sim, 1024, KEY, atol=atol, kind="open",
                   qps=30_000.0)
    assert bool(got.unstable[2]) and float(got.utilization[2]) < 0.6


@pytest.mark.parametrize("tiling", [
    "dense",
    "tiled",
    "tiled-residual",
])
def test_panic_under_chaos_matches_reference(tiling):
    """Panic routing under a kill, on dense levels and on a tiled level
    (the killed hub on a tile, or on the sparse residual): the panic
    coins ride the error path of every level encoding."""
    if tiling == "dense":
        topo = BASE.replace("- name: store\n",
                            "- name: store\n  errorRate: 10%\n") + PANIC
        chaos = [WORKER_DOWN]
        params = None
    else:
        topo = SKEWED.replace(
            "- name: hub\n", "- name: hub\n  numReplicas: 4\n"
        ).replace("- name: w1\n", "- name: w1\n  numReplicas: 4\n") + (
            "policies:\n  defaults:\n"
            "    lb: {policy: least_request, panic_threshold: 50%}\n"
        )
        chaos = [dict(service="hub", start_s=0.02, end_s=0.1,
                      replicas_down=3),
                 dict(service="w1", start_s=0.05, end_s=0.15,
                      replicas_down=2)]
        params = dict(sparse_level_elems=1)
        if tiling == "tiled-residual":
            params["sparse_tile_pmax"] = 3
    _, jc, jt, pt = pair(topo)
    jax_sim, sim = scenario_pair(jc, params, chaos=chaos, lb=(jt, pt))
    if tiling != "dense":
        assert any(lvl.tiled is not None for lvl in sim._levels)
    spec = sim.draw_spec(1024, "open")
    assert spec.panic
    got = run_both(jax_sim, sim, 1024, KEY, kind="open", qps=10_000.0)
    assert bool(got.hop_error.any())
    # every dense census call of a panicking run carries both a fail
    # step and error flags; tiles take a fail step and no error flags
    shapes = iter(sim.census_shapes(1024))
    for lvl in reversed(sim._levels):
        if not lvl.num_children or lvl.sparse is not None:
            continue
        if lvl.tiled is None:
            assert next(shapes)[3:] == (True, True)
        else:
            for tile in lvl.tiled.tiles:
                if tile.num_calls:
                    assert next(shapes)[3:] == (True, False)
    assert next(shapes, None) is None


def test_panic_share_inside_the_kill_window():
    """With 3 of worker's 4 replicas down (25% healthy, threshold 50%),
    about 75% of worker's hops fast-fail while the kill's phase row is
    live and none outside; the caller does not fail.  The row is live
    from 0.05 s until its drain window ends: the drain table, like the
    reference's, is computed from the replica counts (20,000/s against
    one replica's 13,000/s leaves a backlog), not from the panic split."""
    _, jc, jt, pt = pair(BASE + PANIC)
    jax_sim, sim = scenario_pair(jc, chaos=[WORKER_DOWN], lb=(jt, pt))
    got = run_both(jax_sim, sim, 8192, KEY, kind="open", qps=20_000.0)
    w = 1  # worker's hop
    assert int(jc.hop_service[w]) == list(jc.services.names).index("worker")
    bounds, rows = sim._windows_arg(20_000.0, False).numpy()
    live = [(b, e) for b, e, r in zip(bounds, list(bounds[1:]) + [np.inf],
                                      rows) if r == 1 and e > b]
    assert live[0][0] == WORKER_DOWN["start_s"]
    assert live[-1][1] > WORKER_DOWN["end_s"]
    arrive = got.client_start.numpy()
    inside = np.zeros(len(arrive), bool)
    for b, e in live:
        inside |= (arrive >= b) & (arrive < e)
    err = got.hop_error[:, w].numpy()
    share = err[inside].mean()
    assert inside.sum() > 2000 and abs(share - 0.75) < 0.03, share
    assert not err[~inside].any()
    assert not got.client_error.numpy().any()


@pytest.mark.parametrize("entry", ["run", "run_summary", "run_blocks",
                                   "solve_closed_rate"])
def test_qps_max_rejected_under_an_active_law(entry):
    _, jc, jt, pt = pair(BASE + LAWS["least_request"])
    sim = Simulator(port_compiled(jc), lb=pt, device="cpu")
    load = LoadModel(kind="closed", qps=None, connections=8)
    with pytest.raises(ValueError, match="-qps max") as e:
        out = getattr(sim, entry)(load, 256, TorchDraws(0, "cpu"))
        if entry == "run_blocks":
            next(out)
    jax_sim = scenario_pair(jc, lb=(jt, pt))[0]
    with pytest.raises(ValueError) as want:
        jax_sim.run_summary(JaxLoad(kind="closed", qps=None, connections=8),
                            256, KEY)
    assert str(e.value) == str(want.value)


@pytest.mark.parametrize("case", ["no-lb", "all-fifo"])
def test_inactive_tables_change_nothing(case):
    """``lb=None`` (compile_lb of a topology without laws) and an
    all-fifo table with no panic run the same tensors bit for bit as a
    Simulator never told about lb, with the same census calls."""
    topo = BASE if case == "no-lb" else BASE + (
        "policies:\n  worker:\n    lb: fifo\n")
    graph = ServiceGraph.from_yaml(topo)
    compiled = compile_graph(graph)
    tables = compile_lb(graph, compiled)
    assert (tables is None) == (case == "no-lb")
    chaos = port_chaos(WORKER_DOWN)
    a = Simulator(compiled, chaos=chaos, device="cpu")
    b = Simulator(compiled, chaos=chaos, lb=tables, device="cpu")
    assert b._lb_dev is None and not b._lb_panic
    assert a.draw_spec(512, "open") == b.draw_spec(512, "open")
    assert a.census_shapes(512) == b.census_shapes(512)
    load = LoadModel(kind="open", qps=20_000.0)
    ra = a.run(load, 512, TorchDraws(3, "cpu"))
    rb = b.run(load, 512, TorchDraws(3, "cpu"))
    for x, y in zip(ra, rb):
        assert torch.equal(x, y)


FEEDBACK = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 8
  script:
  - call: {service: worker, timeout: 2ms, retries: 2}
- name: worker
  numReplicas: 4
"""


def test_feedback_mirror_with_finite_timeouts():
    """The retry-storm fixed point runs the lb laws through the numpy
    mirror: the port's visit tables equal the reference's, differ from
    the fifo twin's, and the runs on them match the reference."""
    topo = FEEDBACK + (
        "policies:\n  worker:\n"
        "    lb: {policy: ring_hash, hash_skew: 2.0, "
        "panic_threshold: 60%}\n"
    )
    _, jc, jt, pt = pair(topo)
    chaos = [dict(service="worker", start_s=0.02, end_s=0.06,
                  replicas_down=2)]
    jax_sim, sim = scenario_pair(jc, chaos=chaos, lb=(jt, pt))
    assert sim._feedback is not None and sim._feedback.lb is not None
    qps = 0.3 * 4 * MU
    np.testing.assert_allclose(sim._feedback.visits_pc(qps),
                               jax_sim._feedback.visits_pc(qps),
                               rtol=1e-12)
    fifo = Simulator(sim.compiled, chaos=port_chaos(*chaos), device="cpu")
    assert not np.allclose(fifo._feedback.visits_pc(qps),
                           sim._feedback.visits_pc(qps))
    run_both(jax_sim, sim, 1024, KEY, kind="open", qps=qps)
    # the mirror's skewed wait exceeds the aggregate M/M/k's
    lam = np.array([0.1 * 8 * MU, 0.5 * 4 * MU])
    k = np.array([8.0, 4.0])
    p, r = lb_mod.np_wait_stats(pt, pt.backend_profile(8), lam, MU, k)
    p_f, r_f, _ = np_mmk(lam, MU, k)
    assert p[1] / r[1] > 2.0 * (p_f[1] / r_f[1])


def test_to_doc_and_format_table():
    """The static document and its table equal the reference's; the
    per-window split (a timeline or policy summary) is not ported."""
    for law in sorted(LAWS):
        _, _, jt, pt = pair(BASE + LAWS[law])
        doc = lb_mod.to_doc(pt)
        assert doc == jax_lb.to_doc(jt)
        assert lb_mod.format_table(doc) == jax_lb.format_table(doc)
    doc = lb_mod.to_doc(pair(BASE + LAWS["mixed"])[3])
    svc = doc["services"]["store"]
    assert svc["policy"] == "wrr" and "panic_threshold" not in svc
    np.testing.assert_allclose(svc["share"], [0.5, 1 / 6, 1 / 6, 1 / 6],
                               atol=1e-6)
    assert doc["services"]["worker"]["panic_threshold"] == 0.5
    text = lb_mod.format_table(doc)
    assert "store" in text and "panic<50%" in text
    with pytest.raises(NotImplementedError, match="item 8"):
        lb_mod.to_doc(pt, tl=object())
    with pytest.raises(NotImplementedError, match="item 7"):
        lb_mod.to_doc(pt, pol=object())

