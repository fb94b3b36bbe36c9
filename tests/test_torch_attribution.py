"""The port's critical-path attribution (``isotope_tpu_torch/metrics/
attribution.py``, ``Simulator.run_attributed``, ``estimate_tail_cut`` and
the protected runs' ``attribution=True``) against the JAX package, draw
for draw, and the twins of ``tests/test_attribution.py`` that hold on
one device.

Stated tolerances (the port against the JAX package on the same draws):

- counts are equal: requests, tail requests, per-hop crit and error
  counts (int64 in the port, int32 in the reference);
- seconds (the wait / self / net / timeout blame vectors, mean and tail)
  within rtol 1e-5, atol 1e-9 s, the engine's;
- the tail cut within rtol 1e-5 (a quantile of the pilot's histogram);
- ``residual`` and ``residual_abs`` are float32 rounding noise of each
  request's sum of up to 2H + 1 charges, so they are held to
  ``RESID_ULPS`` float32 spacings of the run's latency sum, and both
  sides to the reference's invariant (under 1e-6 s a request);
- the blame histograms: each service's total count is equal, a count
  moves only to an adjacent bucket (the reference takes a float32 log,
  the port a float64 one, so a value within float32 spacings of a
  bucket edge can land one bucket over), and at most ``HIST_MOVED``
  of the counts move;
- exemplars: the same requests (booleans equal, floats at the engine's
  tolerance).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import attribution as jax_attr
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu_torch.metrics import attribution
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim.config import MtlsSchedule
from isotope_tpu_torch.sim.draws import (
    BLOCK_INDEX_BASE,
    TAIL_PILOT_INDEX,
    RootedSource,
)
from test_torch_policies import CHAIN, STORM
from test_torch_policies import both as policy_tables
from test_torch_replay import JaxReplayDraws, port_compiled, scenario_pair
from test_torch_rollout import BAD
from test_torch_rollout import both as rollout_tables
from test_torch_sparse import VARIANTS as SPARSE_CASES
from test_torch_sparse import ENCODINGS

KEY = jax.random.PRNGKey(0)
LOAD = dict(kind="open", qps=200.0)
ATTR = dict(attribution=True)

COUNT_FIELDS = ("count", "tail_count", "crit_count", "error_count",
                "tail_crit_count")
SECOND_FIELDS = ("wait_blame", "self_blame", "net_blame", "timeout_blame",
                 "tail_wait_blame", "tail_self_blame", "tail_net_blame",
                 "tail_timeout_blame")
#: float32 spacings of the latency sum the residuals may differ by
RESID_ULPS = 16
#: share of a blame histogram's counts that may move one bucket over
HIST_MOVED = 1e-3

RETRY_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 400us, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  numReplicas: 2
  script:
  - - call: {service: leaf, probability: 60}
    - call: leaf2
- name: leaf
- name: leaf2
"""


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_hist_band(got, want, what):
    got = _np(got).astype(np.int64)
    want = _np(want).astype(np.int64)
    assert got.shape == want.shape, what
    assert np.array_equal(got.sum(1), want.sum(1)), what
    d = got - want
    # earth mover's distance over the bucket axis: every moved count
    # crossed one edge iff it equals half the absolute difference
    emd = np.abs(np.cumsum(d, axis=1)).sum()
    assert 2 * emd == np.abs(d).sum(), (what, emd)
    assert emd <= HIST_MOVED * max(int(want.sum()), 1), (what, emd)


def assert_attr_match(got, want, latency_sum, exemplars=True, rtol=1e-5,
                      atol=1e-9):
    for name in COUNT_FIELDS:
        assert np.array_equal(_np(getattr(got, name)).astype(np.int64),
                              _np(getattr(want, name)).astype(np.int64)), (
            name
        )
    for name in SECOND_FIELDS:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(float(got.tail_cut), float(want.tail_cut),
                               rtol=rtol)
    bound = RESID_ULPS * float(np.spacing(np.float32(latency_sum)))
    count = float(want.count)
    for name in ("residual", "residual_abs"):
        g, w = float(getattr(got, name)), float(getattr(want, name))
        assert abs(g - w) <= bound, (name, g, w, bound)
    for side in (got, want):
        assert float(side.residual_abs) / count < 1e-6
    assert_hist_band(got.hist, want.hist, "hist")
    assert_hist_band(got.tail_hist, want.tail_hist, "tail_hist")
    if not exemplars:
        return
    assert (got.exemplars is None) == (want.exemplars is None)
    if got.exemplars is None:
        return
    for name in ("error", "hop_sent", "hop_error"):
        assert np.array_equal(_np(getattr(got.exemplars, name)),
                              _np(getattr(want.exemplars, name))), name
    for name in ("latency", "start", "hop_latency", "hop_start"):
        np.testing.assert_allclose(_np(getattr(got.exemplars, name)),
                                   _np(getattr(want.exemplars, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def _summary_equal(got, want):
    for name in ("count", "error_count", "hop_events"):
        assert float(getattr(got, name)) == float(getattr(want, name)), name
    np.testing.assert_allclose(float(got.latency_sum),
                               float(want.latency_sum), rtol=1e-5)


@pytest.fixture(scope="module")
def tree13():
    return jax_compile_graph(JaxGraph.from_yaml_file(
        "examples/topologies/tree-13-services.yaml"
    ))


@pytest.fixture(scope="module")
def tree13_pair(tree13):
    return scenario_pair(tree13, ATTR)


@pytest.fixture(scope="module")
def tree13_runs(tree13_pair):
    """Attributed runs of both engines: mean (1024 requests, blocks of
    256) and tail (2048, blocks of 512, the cut from the pilot)."""
    js, ps = tree13_pair
    out = {}
    for mode, n, block in (("mean", 1024, 256), ("tail", 2048, 512)):
        kw = dict(block_size=block, tail=mode == "tail")
        out[mode] = (
            ps.run_attributed(LoadModel(**LOAD), n, JaxReplayDraws(KEY, js),
                              **kw),
            js.run_attributed(JaxLoad(**LOAD), n, KEY, **kw),
        )
    return out


# -- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("mode", ["mean", "tail"])
def test_run_attributed_matches_reference(tree13_runs, mode):
    (s, a), (js, ja) = tree13_runs[mode]
    _summary_equal(s, js)
    assert_attr_match(a, ja, float(js.latency_sum))
    assert a.crit_count.dtype == torch.int64
    assert a.wait_blame.dtype == torch.float32
    if mode == "tail":
        assert np.isfinite(float(a.tail_cut))
        assert 0 < int(a.tail_count) < int(a.count)


def test_tail_pilot_draws_under_its_index(tree13_pair):
    """The pilot is a run under ``fold_in(key, 777_000)``: its block
    ``b`` draws the path ``(777_000, 1_000_000 + b)``, and its cut
    equals the reference's."""
    js, ps = tree13_pair
    src = JaxReplayDraws(KEY, js)
    spec = ps.draw_spec(64, "open")
    rooted = RootedSource(src, TAIL_PILOT_INDEX).draws(
        BLOCK_INDEX_BASE + 3, spec
    )
    folded = JaxReplayDraws(jax.random.fold_in(KEY, 777_000), js).draws(
        BLOCK_INDEX_BASE + 3, spec
    )
    for a, b in zip(rooted, folded):
        assert (a is None and b is None) or torch.equal(a, b)
    for n, block in ((20_000, 4096), (300, 65_536)):
        got = ps.estimate_tail_cut(LoadModel(**LOAD), n, src,
                                   block_size=block)
        want = js.estimate_tail_cut(JaxLoad(**LOAD), n, KEY,
                                    block_size=block)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_closed_loop_tail_run_matches_reference(tree13):
    """A paced closed loop: the pilot solves its own rate under the
    pilot's index, and the main run reuses it, as the reference's cache
    does."""
    js, ps = scenario_pair(tree13, ATTR)
    load = dict(kind="closed", qps=400.0, connections=8)
    s, a = ps.run_attributed(LoadModel(**load), 2048,
                             JaxReplayDraws(KEY, js), block_size=512,
                             tail=True)
    js_, ja = js.run_attributed(JaxLoad(**load), 2048, KEY,
                                block_size=512, tail=True)
    _summary_equal(s, js_)
    assert_attr_match(a, ja, float(js_.latency_sum))


def test_to_doc_and_format_table_equal_reference(tree13, tree13_runs):
    (_, a), (js, ja) = tree13_runs["tail"]
    pc = port_compiled(tree13)
    doc = attribution.to_doc(pc, a)
    want = jax_attr.to_doc(tree13, ja)
    assert doc["schema"] == "isotope-blame/v1"
    _doc_close(doc, want, "", float(js.latency_sum) / float(js.count))
    assert attribution.format_table(doc) == jax_attr.format_table(doc)
    assert attribution.to_doc(pc, a, top=2)["services"] == doc["services"][:2]


def _doc_close(got, want, path, resid_scale):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _doc_close(got[k], want[k], f"{path}.{k}", resid_scale)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _doc_close(g, w, f"{path}[{i}]", resid_scale)
    elif isinstance(want, float):
        if "residual" in path:
            bound = RESID_ULPS * float(np.spacing(np.float32(resid_scale)))
            assert abs(got - want) <= bound, path
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                       err_msg=path)
    else:
        assert got == want, path


def test_service_and_edge_blame_equal_reference(tree13, tree13_runs):
    (_, a), (_, ja) = tree13_runs["mean"]
    pc = port_compiled(tree13)
    for tail in (False, True):
        for fn in ("service_blame", "edge_blame"):
            got = getattr(attribution, fn)(pc, a, tail=tail)
            want = getattr(jax_attr, fn)(tree13, ja, tail=tail)
            _doc_close(got, want, fn, 1.0)


@pytest.mark.parametrize("case", ["retries-timeouts", "chaos-refused",
                                  "kill-reset"])
def test_retries_timeouts_and_refusals_match_reference(case):
    """Serial attempts summed in attempt order, timeout caps charged to
    the edge, 500s counted; a down entry refuses its clients (the
    refused-connect net charge) and a down callee truncates; an
    ungraceful kill's resets are the residual (the client sees the reset,
    not the tree walk)."""
    load = dict(kind="open", qps=2000.0)
    canonical = "examples/topologies/canonical.yaml"
    if case == "retries-timeouts":
        jc = jax_compile_graph(JaxGraph.from_yaml(RETRY_YAML))
        chaos = [dict(service="leaf2", start_s=0.5, end_s=1.0)]
    elif case == "chaos-refused":
        jc = jax_compile_graph(JaxGraph.from_yaml_file(canonical))
        chaos = [dict(service="a", start_s=0.2, end_s=0.4),
                 dict(service="c", start_s=0.5, end_s=0.7)]
    else:
        jc = jax_compile_graph(JaxGraph.from_yaml_file(canonical))
        chaos = [dict(service="b", start_s=0.2, end_s=0.6, drain=False)]
    js, ps = scenario_pair(jc, ATTR, chaos=chaos)
    s, a = ps.run_attributed(LoadModel(**load), 3000,
                             JaxReplayDraws(KEY, js), block_size=1000,
                             tail=True)
    js_, ja = js.run_attributed(JaxLoad(**load), 3000, KEY, block_size=1000,
                                tail=True)
    _summary_equal(s, js_)
    assert_attr_match(a, ja, float(js_.latency_sum))
    if case == "retries-timeouts":
        assert float(a.timeout_blame.sum()) > 0
        assert int(a.error_count.sum()) > 0
    else:
        assert int(s.error_count) > 0
    if case == "kill-reset":
        # the resets put ~1e-4 s into the residual; float32 rounding
        # alone leaves ~2e-7 s over these 3,000 requests
        assert float(a.residual_abs) > 1e-5


def test_saturated_closed_loop_matches_reference():
    """``-qps max``: the finite-population law's far tail is held at
    rtol 1e-4 / atol 1e-5 s (``tests/test_torch_closed.py``), so the
    seconds and the exemplars' floats are held there; counts, the tail
    cut's requests and the histogram band as everywhere."""
    js, ps = scenario_pair(jax_compile_graph(JaxGraph.from_yaml_file(
        "examples/topologies/canonical.yaml")), ATTR)
    load = dict(kind="closed", qps=None, connections=16)
    s, a = ps.run_attributed(LoadModel(**load), 4096,
                             JaxReplayDraws(KEY, js), block_size=1024,
                             tail=True)
    js_, ja = js.run_attributed(JaxLoad(**load), 4096, KEY,
                                block_size=1024, tail=True)
    _summary_equal(s, js_)
    assert_attr_match(a, ja, float(js_.latency_sum), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("encoding", ["tiled-residual", "sparse"])
def test_tiled_and_sparse_levels_match_reference(encoding):
    """The sweep reads only the (N, H) results, so a level the engine
    tiles (or encodes sparse) attributes as the reference does: the
    skewed hub of ``test_torch_sparse.py`` with its firing timeout and
    retried calls."""
    jc = jax_compile_graph(JaxGraph.from_yaml(SPARSE_CASES["timeout-retries"]))
    js, ps = scenario_pair(jc, dict(attribution=True, **ENCODINGS[encoding]))
    assert encoding.split("-")[0] in {
        "tiled" if l.tiled is not None
        else "sparse" if l.sparse is not None else "dense"
        for l in ps._levels
    }
    load = dict(kind="open", qps=300.0)
    s, a = ps.run_attributed(LoadModel(**load), 600,
                             JaxReplayDraws(KEY, js), block_size=300,
                             tail=True)
    js_, ja = js.run_attributed(JaxLoad(**load), 600, KEY, block_size=300,
                                tail=True)
    assert_attr_match(a, ja, float(js_.latency_sum))
    assert float(a.timeout_blame.sum()) > 0


@pytest.mark.parametrize("roll", [False, True], ids=["policies", "rollouts"])
def test_protected_attributed_runs_match_reference(roll):
    """``run_policies`` / ``run_rollouts`` with ``attribution=True,
    tail=True``: the blame of the protected physics (the tail cut from
    an unprotected pilot), the rest of the tuple unchanged."""
    load = dict(kind="open", qps=0.325 * 4 * 13_000.0)
    if roll:
        jc, jt, _, pc, pt, _ = rollout_tables(BAD)
        js, ps = scenario_pair(jc, dict(timeline=True, attribution=True),
                               rollouts=(jt, pt))
        load = dict(kind="open", qps=500.0)
        run, n, block, win = "run_rollouts", 6000, 1000, 1.0
        chaos_free = True
    else:
        jc, jt, pc, pt = policy_tables(CHAIN + STORM)
        kill = [dict(service="worker", start_s=0.2, end_s=0.5,
                     replicas_down=3)]
        js, ps = scenario_pair(jc, dict(timeline=True, attribution=True,
                                        timeline_window_s=0.1),
                               chaos=kill, policies=(jt, pt))
        run, n, block, win = "run_policies", 10_000, 1024, 0.1
        chaos_free = False
    kw = dict(block_size=block, window_s=win, attribution=True, tail=True)
    got = getattr(ps, run)(LoadModel(**load), n, JaxReplayDraws(KEY, js),
                           **kw)
    want = getattr(js, run)(JaxLoad(**load), n, KEY, **kw)
    assert len(got) == len(want) == 4
    _summary_equal(got[0], want[0])
    assert_attr_match(got[-1], want[-1], float(want[0].latency_sum))
    plain = getattr(ps, run)(LoadModel(**load), n, JaxReplayDraws(KEY, js),
                             block_size=block, window_s=win)
    assert len(plain) == 3
    for name in ("count", "error_count", "hop_events", "latency_sum"):
        assert float(getattr(plain[0], name)) == float(
            getattr(got[0], name)
        ), name
    if not chaos_free:
        assert int(got[-1].error_count.sum()) > 0


# -- the twins of tests/test_attribution.py -----------------------------------


def test_blame_sums_to_client_latency(tree13_runs):
    (s, a), _ = tree13_runs["mean"]
    assert int(a.count) == int(s.count)
    assert float(a.residual_abs) / float(a.count) < 1e-6
    np.testing.assert_allclose(a.total_blame_s, float(s.latency_sum),
                               rtol=1e-5)


def test_self_blame_nonnegative(tree13_runs):
    (_, a), _ = tree13_runs["mean"]
    assert float(a.self_blame.min()) > -1e-7
    assert float(a.wait_blame.min()) >= 0.0


def test_hist_counts_match_crit_counts(tree13_runs):
    for mode in ("mean", "tail"):
        (_, a), _ = tree13_runs[mode]
        assert int(a.hist.sum()) == int(a.crit_count.sum())
        assert int(a.tail_hist.sum()) == int(a.tail_crit_count.sum())


def _split_results(res, cut):
    def part(sl):
        return res._replace(
            client_start=res.client_start[sl],
            client_latency=res.client_latency[sl],
            client_error=res.client_error[sl],
            hop_sent=res.hop_sent[sl],
            hop_error=res.hop_error[sl],
            hop_latency=res.hop_latency[sl],
            hop_start=res.hop_start[sl],
            hop_wait=res.hop_wait[sl],
        )

    return part(slice(None, cut)), part(slice(cut, None))


def test_blocked_accumulation_equals_single_block(tree13_pair):
    """Two halves of one block summed equal the whole block: counts and
    histograms exactly, seconds within float32 summation order."""
    _, ps = tree13_pair
    res = ps.run(LoadModel(**LOAD), 512, TorchDraws(0, "cpu"))
    tables = ps._attribution_tables()
    full, _ = attribution.attribute_block(res, tables, tail_cut=0.002)
    lo, hi = _split_results(res, 256)
    parts = [attribution.attribute_block(p, tables, tail_cut=0.002)[0]
             for p in (lo, hi)]
    summed = attribution.reduce_stacked(parts)
    for name in full._fields:
        got, want = getattr(summed, name), getattr(full, name)
        if want is None:
            assert got is None, name
        elif want.dtype == torch.int64:
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                       atol=1e-7, err_msg=name)


def test_off_leaves_run_summary_byte_identical(tree13, tree13_pair):
    """An attributed run's summary equals the unattributed run's bit for
    bit, and a Simulator with attribution off has no ``hop_wait``."""
    _, ps = tree13_pair
    plain = Simulator(port_compiled(tree13), device="cpu")
    src = TorchDraws(3, "cpu")
    s_off = plain.run_summary(LoadModel(**LOAD), 1024, src, block_size=256)
    s_on, _ = ps.run_attributed(LoadModel(**LOAD), 1024, src, block_size=256)
    for name, a, b in zip(s_off._fields, s_off._replace(metrics=None),
                          s_on._replace(metrics=None)):
        if a is not None:
            assert torch.equal(a, b), name
    assert plain.run(LoadModel(**LOAD), 8, src).hop_wait is None
    assert ps.run(LoadModel(**LOAD), 8, src).hop_wait is not None


def test_run_attributed_requires_flag(tree13):
    sim = Simulator(port_compiled(tree13), device="cpu")
    with pytest.raises(ValueError, match="attribution=True"):
        sim.run_attributed(LoadModel(**LOAD), 64, TorchDraws(0, "cpu"))


def test_attribution_rejects_mtls(tree13):
    with pytest.raises(ValueError, match="MtlsSchedule"):
        Simulator(
            port_compiled(tree13), SimParams(attribution=True),
            mtls=MtlsSchedule(period_s=1.0, taxes_s=(0.0, 1e-3)),
            device="cpu",
        )


def test_attribution_and_timeline_in_one_loop_refused(tree13):
    sim = Simulator(port_compiled(tree13),
                    SimParams(attribution=True, timeline=True), device="cpu")
    control = sim._control(LoadModel(**LOAD), 256, TorchDraws(0, "cpu"),
                           256, None, False, False)
    with pytest.raises(ValueError, match="not both"):
        sim._run_summary(LoadModel(**LOAD), 256, TorchDraws(0, "cpu"), 256,
                         None, False, control, attr=True)


def test_summary_stays_o_buckets(tree13, tree13_pair):
    _, ps = tree13_pair
    n = 4096
    _, a = ps.run_attributed(LoadModel(**LOAD), n, TorchDraws(0, "cpu"),
                             block_size=512)
    bound = max(
        tree13.num_services * attribution.NUM_BLAME_BUCKETS,
        ps.params.attribution_top_k * tree13.num_hops,
    )
    leaves = [x for x in a[:-1]] + list(a.exemplars)
    for leaf in leaves:
        assert leaf.numel() <= bound and leaf.numel() < n


def test_tail_restricts_and_exemplars_are_slowest(tree13_runs):
    (s, a), _ = tree13_runs["tail"]
    assert a.tail_total_blame_s < a.total_blame_s
    assert int(a.tail_hist.sum()) <= int(a.hist.sum())
    lat = _np(a.exemplars.latency)
    assert list(lat) == sorted(lat, reverse=True)
    assert lat[0] == float(s.latency_max)


def test_exemplar_ties_take_the_lowest_index():
    """Equal latencies (a deterministic quiet chain: every request the
    same) give the first requests of the first block, as the
    reference's ``top_k`` does, in every block merge."""
    yaml_text = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{sleep: 2ms}]
"""
    jc = jax_compile_graph(JaxGraph.from_yaml(yaml_text))
    params = JaxParams(attribution=True, service_time="deterministic")
    js, ps = scenario_pair(
        jc, (params, SimParams(attribution=True,
                               service_time="deterministic")),
    )
    load = dict(kind="open", qps=0.001)
    _, a = ps.run_attributed(LoadModel(**load), 64,
                             JaxReplayDraws(KEY, js), block_size=16)
    _, ja = js.run_attributed(JaxLoad(**load), 64, KEY, block_size=16)
    lat = _np(a.exemplars.latency)
    assert np.all(lat == lat[0])
    np.testing.assert_array_equal(_np(a.exemplars.start),
                                  np.asarray(ja.exemplars.start))


def test_merge_host_and_exemplars_host(tree13_runs):
    (_, a), _ = tree13_runs["tail"]
    merged = attribution.merge_host([a, a])
    assert int(merged.count) == 2 * int(a.count)
    np.testing.assert_array_equal(merged.hist, 2 * _np(a.hist))
    ex = merged.exemplars
    assert len(ex.latency) == len(a.exemplars.latency)
    # each row twice: the top K of the doubled batch is every row of the
    # first half of the pairs, slowest first
    np.testing.assert_array_equal(
        ex.latency, np.repeat(_np(a.exemplars.latency), 2)[:len(ex.latency)]
    )


# -- semantic blame -----------------------------------------------------------


def _attr_for(doc: dict, qps=50.0, n=256):
    doc.setdefault("defaults", {"requestSize": 64, "responseSize": 64})
    jc = jax_compile_graph(JaxGraph.decode(doc))
    js, ps = scenario_pair(jc, ATTR)
    s, a = ps.run_attributed(LoadModel(kind="open", qps=qps), n,
                             JaxReplayDraws(KEY, js), block_size=n)
    js_, ja = js.run_attributed(JaxLoad(kind="open", qps=qps), n, KEY,
                                block_size=n)
    assert_attr_match(a, ja, float(js_.latency_sum))
    return ps.compiled, s, a


def test_chain_puts_every_hop_on_the_path():
    compiled, s, a = _attr_for({"services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b", "script": [{"call": "c"}]},
        {"name": "c", "script": [{"sleep": "2ms"}]},
    ]})
    assert np.all(_np(a.crit_count) == int(a.count))
    assert float(a.self_blame[2]) / int(a.count) > 2e-3


def test_fork_blames_the_slow_branch():
    compiled, s, a = _attr_for({"services": [
        {"name": "entry", "isEntrypoint": True,
         "script": [[{"call": "slow"}, {"call": "fast"}]]},
        {"name": "slow", "script": [{"sleep": "20ms"}]},
        {"name": "fast", "script": [{"sleep": "10us"}]},
    ]})
    names = compiled.services.names
    crit = {names[compiled.hop_service[h]]: int(c)
            for h, c in enumerate(_np(a.crit_count))}
    count = int(a.count)
    assert crit["entry"] == count
    assert crit["slow"] / count > 0.99 and crit["fast"] / count < 0.01
    rows = {r["service"]: r
            for r in attribution.service_blame(compiled, a)}
    assert rows["slow"]["share"] > rows.get("fast", {"share": 0.0})["share"]
    assert rows["slow"]["self_s"] / count > 15e-3


def test_timeout_charges_the_edge():
    compiled, s, a = _attr_for({"services": [
        {"name": "a", "isEntrypoint": True,
         "script": [{"call": {"service": "b", "timeout": "1ms"}}]},
        {"name": "b", "script": [{"sleep": "50ms"}]},
    ]})
    assert float(a.timeout_blame[1]) / int(a.count) == pytest.approx(
        1e-3, rel=1e-3
    )
    assert float(a.self_blame[1]) == 0.0
    assert float(a.residual_abs) / int(a.count) < 1e-6
    ab = [e for e in attribution.edge_blame(compiled, a)
          if e["callee"] == "b"][0]
    assert ab["timeout_s"] > 0


def test_error_contributions_counted():
    compiled, s, a = _attr_for({"services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b", "errorRate": "50%", "script": [{"sleep": "1ms"}]},
    ]}, n=512)
    assert int(a.error_count[1]) > 0
    assert float(a.residual_abs) / int(a.count) < 1e-6


def test_exemplar_results_view(tree13_runs):
    (_, a), _ = tree13_runs["tail"]
    res = attribution.exemplar_results(a)
    k = a.exemplars.latency.shape[0]
    assert res.hop_wait.shape == res.hop_latency.shape
    assert res.client_latency.shape == (k,)
    with pytest.raises(ValueError, match="exemplars"):
        attribution.exemplar_results(a._replace(exemplars=None))


def test_port_default_source_runs_attributed(tree13_pair):
    """A production run (``TorchDraws``) of the same simulator: the
    invariants hold without the replayed draws."""
    _, ps = tree13_pair
    s, a = ps.run_attributed(LoadModel(**LOAD), 2048, TorchDraws(7, "cpu"),
                             block_size=512, tail=True)
    assert float(a.residual_abs) / int(a.count) < 1e-6
    np.testing.assert_allclose(a.total_blame_s, float(s.latency_sum),
                               rtol=1e-5)
    assert int(a.hist.sum()) == int(a.crit_count.sum())
    ex = _np(a.exemplars.latency)
    assert list(ex) == sorted(ex, reverse=True)
