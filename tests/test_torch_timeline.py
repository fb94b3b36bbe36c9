"""The port's flight recorder (``isotope_tpu_torch/metrics/timeline.py``,
``Simulator.run_timeline``) against the JAX package's, draw for draw.

Both engines run ``tree-13-services.yaml`` on the same draws
(``JaxReplayDraws``) and record the same windows.  Stated tolerances:

- counts (arrivals, completions, errors, the latency histogram, the
  per-service arrivals / completions / errors) are exact;
- the client latency sums: rtol 1e-5, atol 1e-6 s;
- the occupancy integrals (``svc_inflight_s``, ``svc_busy_s``) are
  first differences of float32 prefix sums of event TIMES (the
  module's ``F(t) = Esum - Ssum + t (A - B)`` identity).  Each package
  sums thousands of event times in its own order and cancels the sums
  in float32, so each carries a rounding error of ~sqrt(events)
  spacings of the largest prefix: they are held to 64 float32 spacings
  of it (horizon x the service's event count).  That is a wide band
  where a window's integral is small, so ``resolved`` runs long service
  times over a short horizon, where the band is under 5% of each
  series' median nonzero value;
- the port's occupancy integrals also equal a float64 recomputation
  from the same SimResults (each hop's overlap with each window,
  summed directly; ``exact_occupancy``) to within what the port's
  fixed-point times and float32 window index can move: 2^-27 s plus a
  float32 spacing of the horizon per hop that touches the window, and
  a float32 rounding of the value per block summed.

The reference bins with a dense boundary contraction for W <= 64 and a
scatter above; the port bins every grid one way, and is held to both.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import timeline as jax_tm
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu_torch.metrics import attribution as port_attr
from isotope_tpu_torch.metrics import timeline as tm
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
from test_torch_replay import JaxReplayDraws, port_compiled

KEY = jax.random.PRNGKey(0)
TREE13 = "examples/topologies/tree-13-services.yaml"
COUNT_FIELDS = (
    "count", "arrivals", "completions", "errors", "latency_hist",
    "svc_arrivals", "svc_completions", "svc_errors",
)
OCC_FIELDS = ("svc_inflight_s", "svc_busy_s")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_timeline_match(got, want, what=""):
    """The module docstring's tolerances."""
    assert got.num_windows == want.num_windows
    assert float(got.window_s) == float(want.window_s)
    for name in COUNT_FIELDS:
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        assert g.shape == w.shape, name
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), (
            f"{what}{name}"
        )
    np.testing.assert_allclose(
        _np(got.latency_sum), _np(want.latency_sum), rtol=1e-5, atol=1e-6,
        err_msg=f"{what}latency_sum",
    )
    horizon = want.num_windows * float(want.window_s)
    events = _np(want.svc_arrivals).sum(1).max(initial=1.0)
    atol = 64 * float(np.spacing(np.float32(horizon * events)))
    for name in OCC_FIELDS:
        np.testing.assert_allclose(
            _np(getattr(got, name)), _np(getattr(want, name)),
            rtol=0.0, atol=atol, err_msg=f"{what}{name}",
        )


def exact_occupancy(res, hop_service, num_services, num_windows, window_s):
    """float64 ``(inflight, busy, touching)`` (S, W) of one block's
    SimResults: each sent hop's in-flight span [start, end) and busy
    span [start + wait, end), clamped to the horizon, overlapped with
    each window directly; ``touching`` counts the hops whose span meets
    the window.  Windows are [j dt, (j+1) dt) with float32 boundaries,
    the last one ending at the horizon."""
    sent = _np(res.hop_sent)
    start = _np(res.hop_start).astype(np.float32)
    end = (start + _np(res.hop_latency)).astype(np.float64)
    busy_start = (start + _np(res.hop_wait)).astype(np.float64)
    W = num_windows
    horizon = W * window_s
    s = np.clip(start.astype(np.float64), 0.0, horizon)
    e = np.minimum(np.maximum(end, s), horizon)
    b = np.minimum(np.maximum(busy_start, s), e)
    bounds = (np.arange(W + 1, dtype=np.float32)
              * np.float32(window_s)).astype(np.float64)
    lo, hi = bounds[:-1], bounds[1:].copy()
    hi[-1] = horizon
    svc = np.broadcast_to(np.asarray(hop_service), sent.shape).reshape(-1)

    def per_service(x):
        acc = np.zeros((num_services, W))
        np.add.at(acc, svc, (x * sent[..., None]).reshape(-1, W))
        return acc

    def overlap(a):
        return np.clip(np.minimum(e[..., None], hi)
                       - np.maximum(a[..., None], lo), 0.0, None)

    touching = (e[..., None] >= lo) & (s[..., None] <= hi)
    return (per_service(overlap(s)), per_service(overlap(b)),
            per_service(touching.astype(np.float64)))


def assert_occupancy_exact(tl, blocks, compiled, what=""):
    """``tl``'s occupancy integrals against ``exact_occupancy`` summed
    over the SimResults ``blocks`` that made it (the module docstring's
    bound)."""
    W, dt = tl.num_windows, float(tl.window_s)
    parts = [exact_occupancy(r, compiled.hop_service,
                             compiled.num_services, W, dt) for r in blocks]
    inflight, busy, touching = (sum(p[i] for p in parts) for i in range(3))
    per_hop = 2.0 ** -27 + float(np.spacing(np.float32(W * dt)))
    for name, want in (("svc_inflight_s", inflight), ("svc_busy_s", busy)):
        got = _np(getattr(tl, name)).astype(np.float64)
        bound = (touching * per_hop
                 + (len(blocks) + 1) * 2.0 ** -23 * np.abs(want))
        worst = np.abs(got - want) - bound
        assert worst.max() <= 0.0, (
            f"{what}{name}: off the float64 recomputation by "
            f"{np.abs(got - want).max():.3g} s"
        )
    assert busy.max() > 0.0


def as_jax(tl):
    """A port TimelineSummary with numpy leaves (what the reference's
    host functions read)."""
    return jax_tm.TimelineSummary(*(_np(x) for x in tl))


@pytest.fixture(scope="module")
def tree13():
    return jax_compile_graph(JaxGraph.from_yaml_file(TREE13))


def _pair(jc, **params):
    js = JaxSimulator(jc, JaxParams(timeline=True, **params))
    ps = Simulator(port_compiled(jc), SimParams(timeline=True, **params),
                   device="cpu")
    return js, ps


@pytest.fixture(scope="module", params=["dense", "wide"])
def recorded(request, tree13):
    """One recorded run per reference regime: 6 windows of 1 s (dense,
    W <= 64) and 103 of 50 ms (wide, the scatter); both engines, the
    same draws, 4 blocks of 256."""
    window = 1.0 if request.param == "dense" else 0.05
    js, ps = _pair(tree13, timeline_window_s=window)
    want = js.run_timeline(JaxLoad(kind="open", qps=200.0), 1024, KEY,
                           block_size=256)
    got = ps.run_timeline(LoadModel(kind="open", qps=200.0), 1024,
                          JaxReplayDraws(KEY, js), block_size=256)
    return request.param, js, ps, got, want


def test_windowed_series_match_reference(recorded):
    regime, _, _, (s_got, tl_got), (s_want, tl_want) = recorded
    assert (tl_want.num_windows <= jax_tm.DENSE_WINDOWS_MAX) == (
        regime == "dense"
    )
    assert_timeline_match(tl_got, tl_want)
    for f in ("count", "error_count", "hop_events"):
        assert float(getattr(s_got, f)) == float(getattr(s_want, f))
    np.testing.assert_allclose(float(s_got.latency_sum),
                               float(s_want.latency_sum), rtol=1e-5)


def test_series_reconcile_with_run_aggregates(recorded):
    _, _, _, (s, tl), _ = recorded
    assert int(tl.count) == int(s.count)
    assert int(tl.arrivals.sum()) == int(s.count)
    assert int(tl.completions.sum()) == int(s.count)
    assert int(tl.errors.sum()) == int(s.error_count)
    assert int(tl.svc_arrivals.sum()) == int(s.hop_events)
    assert int(tl.latency_hist.sum()) == int(s.count)
    # packed carries: the count series are int32, the integrals float32
    assert tl.svc_arrivals.dtype == torch.int32
    assert tl.svc_busy_s.dtype == torch.float32


def test_occupancy_integrals_equal_float64_recomputation(recorded):
    """The recorded run's occupancy integrals against the float64
    recomputation from the blocks of the same run (``run_blocks`` on
    the same draws and blocking)."""
    _, js, ps, (_, tl), _ = recorded
    blocks = list(ps.run_blocks(LoadModel(kind="open", qps=200.0), 1024,
                                JaxReplayDraws(KEY, js), block_size=256))
    assert len(blocks) == 4
    assert_occupancy_exact(tl, blocks, ps.compiled)


@pytest.fixture(scope="module", params=["dense", "wide"])
def resolved(request, tree13):
    """Recorded runs whose occupancy integrals dwarf the float32 band
    the reference is held to: 5 ms service times at 400 qps in 0.1 s
    windows (7 windows, dense), and 20 ms at 200 qps in 8 ms windows
    (80 windows, wide), over 0.64 s; both engines, the same draws."""
    cpu, qps, n, window, block = {
        "dense": (0.005, 400.0, 256, 0.1, 128),
        "wide": (0.02, 200.0, 128, 0.008, 64),
    }[request.param]
    js, ps = _pair(tree13, timeline_window_s=window, cpu_time_s=cpu)
    _, want = js.run_timeline(JaxLoad(kind="open", qps=qps), n, KEY,
                              block_size=block)
    load = LoadModel(kind="open", qps=qps)
    _, got = ps.run_timeline(load, n, JaxReplayDraws(KEY, js),
                             block_size=block)
    blocks = list(ps.run_blocks(load, n, JaxReplayDraws(KEY, js),
                                block_size=block))
    return request.param, ps, got, want, blocks


def test_occupancy_series_match_reference_where_resolved(resolved):
    regime, ps, got, want, blocks = resolved
    assert (want.num_windows <= jax_tm.DENSE_WINDOWS_MAX) == (
        regime == "dense"
    )
    horizon = want.num_windows * float(want.window_s)
    events = _np(want.svc_arrivals).sum(1).max()
    atol = 64 * float(np.spacing(np.float32(horizon * events)))
    for name in OCC_FIELDS:
        w = _np(getattr(want, name))
        assert atol < 0.05 * np.median(w[w > 0]), name
    assert_timeline_match(got, want)
    assert_occupancy_exact(got, blocks, ps.compiled)


def test_run_timeline_summary_equals_run_summary(recorded):
    """A recorded run's RunSummary is the unrecorded run's, bit for bit
    (same draws and blocking; the recorder only reads the blocks)."""
    _, js, ps, (s_got, _), _ = recorded
    plain = ps.run_summary(LoadModel(kind="open", qps=200.0), 1024,
                           JaxReplayDraws(KEY, js), block_size=256)
    for name, a, b in zip(plain._fields, plain, s_got):
        if a is None:
            assert b is None, name
            continue
        assert torch.equal(a, b), name


def test_blocked_accumulation_equals_one_block(tree13):
    """Recording a block in two halves and summing equals recording it
    whole: counts exactly, the latency sums to rounding, the occupancy
    integrals to their stated tolerance (they cancel per part)."""
    js, ps = _pair(tree13, timeline_window_s=1.0)
    res = ps.run(LoadModel(kind="open", qps=200.0), 512,
                 JaxReplayDraws(KEY, js))
    spec = tm.build_spec(ps.compiled, 4, 1.0)
    full = tm.timeline_block(res, spec, packed=True)

    def part(sl):
        return res._replace(**{
            f: getattr(res, f)[sl]
            for f in ("client_start", "client_latency", "client_error",
                      "hop_sent", "hop_error", "hop_latency", "hop_start",
                      "hop_wait")
        })

    acc = tm.zeros_summary(spec, packed=True)
    for sl in (slice(None, 256), slice(256, None)):
        acc = tm.accumulate(acc, tm.timeline_block(part(sl), spec, True))
    assert_timeline_match(acc, full, "halves: ")
    assert_occupancy_exact(full, [res], ps.compiled, "whole: ")
    assert_occupancy_exact(acc, [part(slice(None, 256)),
                                 part(slice(256, None))],
                           ps.compiled, "halves: ")


def test_timeline_block_matches_reference_on_one_block(tree13):
    """The recorder alone, on one block of SimResults handed to both
    packages' ``timeline_block`` (packed and unpacked)."""
    js, ps = _pair(tree13, timeline_window_s=1.0)
    jres = js.run(JaxLoad(kind="open", qps=200.0), 512, KEY)
    pres = ps.run(LoadModel(kind="open", qps=200.0), 512,
                  JaxReplayDraws(KEY, js))
    for packed in (False, True):
        for w, dt in ((4, 1.0), (90, 0.03)):
            want = jax_tm.timeline_block(
                jres, jax_tm.build_spec(tree13, w, dt), packed=packed
            )
            got = tm.timeline_block(
                pres, tm.build_spec(ps.compiled, w, dt), packed=packed
            )
            assert_timeline_match(got, want, f"packed={packed} W={w}: ")
            assert_occupancy_exact(got, [pres], ps.compiled,
                                   f"packed={packed} W={w}: ")
            assert got.arrivals.dtype == (
                torch.int32 if packed else torch.float32
            )


def test_closed_loop_timeline_matches_reference(tree13):
    js, ps = _pair(tree13, timeline_window_s=0.5)
    load = dict(kind="closed", qps=500.0, connections=16)
    _, want = js.run_timeline(JaxLoad(**load), 512, KEY, block_size=128)
    _, got = ps.run_timeline(LoadModel(**load), 512,
                             JaxReplayDraws(KEY, js), block_size=128)
    assert_timeline_match(got, want)
    blocks = list(ps.run_blocks(LoadModel(**load), 512,
                                JaxReplayDraws(KEY, js), block_size=128))
    assert_occupancy_exact(got, blocks, ps.compiled)


def test_run_timeline_requires_flag(tree13):
    ps = Simulator(port_compiled(tree13), SimParams(), device="cpu")
    with pytest.raises(ValueError, match="timeline=True"):
        ps.run_timeline(LoadModel(kind="open", qps=200.0), 256,
                        JaxReplayDraws(KEY))
    # a plain Simulator records nothing: no hop_wait on its results
    res = ps.run(LoadModel(kind="open", qps=200.0), 64, JaxReplayDraws(KEY))
    assert res.hop_wait is None and res.hop_canary is None


def test_plan_windows_clamps_like_reference():
    for args in (
        (1000.0, 1.0, 16, 4),
        (1000.0, 1.0, 1000, 100_000),
        (10.0, 1.0, 256, 13),
        (0.3, 1.0, 256, 13),
    ):
        kw = dict(elem_budget=200_000, log=lambda m: None)
        assert tm.plan_windows(*args, **kw) == jax_tm.plan_windows(
            *args, **kw
        )
    with pytest.raises(ValueError, match="positive"):
        tm.plan_windows(1.0, 0.0, 8, 4)


def test_engine_clamps_window_count(tree13):
    js, ps = _pair(tree13, timeline_window_s=0.001, timeline_max_windows=8)
    assert ps.plan_timeline_windows(512, 200.0) == js.plan_timeline_windows(
        512, 200.0
    )
    _, tl = ps.run_timeline(LoadModel(kind="open", qps=200.0), 512,
                            JaxReplayDraws(KEY, js), block_size=256)
    assert tl.num_windows == 8 and int(tl.arrivals.sum()) == 512


def test_host_surfaces_equal_reference(tree13, recorded):
    """``to_doc``, ``format_table``, ``prometheus_text``, the convoy
    detector, ``window_quantile`` and ``window_stores`` of the same
    summary equal the reference's output."""
    _, _, ps, (_, tl), _ = recorded
    jtl = as_jax(tl)
    doc = tm.to_doc(ps.compiled, tl)
    assert doc == jax_tm.to_doc(tree13, jtl)
    assert doc["schema"] == "isotope-timeline/v1"
    assert tm.format_table(doc) == jax_tm.format_table(doc)
    assert tm.prometheus_text(ps.compiled, tl) == jax_tm.prometheus_text(
        tree13, jtl
    )
    assert tm.leaf_services(ps.compiled) == jax_tm.leaf_services(tree13)
    for w in range(tl.num_windows):
        assert tm.window_quantile(tl, w, 0.99) == jax_tm.window_quantile(
            jtl, w, 0.99
        )
    for (w1, t1, s1), (w2, t2, s2) in zip(
        tm.window_stores(ps.compiled, tl),
        jax_tm.window_stores(tree13, jtl),
    ):
        assert (w1, t1) == (w2, t2)
        assert [(x.name, x.labels, x.value) for x in s1.samples] == [
            (x.name, x.labels, x.value) for x in s2.samples
        ]
    assert tm.sparkline([0, 1, 2, 4]) == jax_tm.sparkline([0, 1, 2, 4])
    # the control-plane projection rides the same document
    acks = np.array([0.05, 0.2, 0.2, 0.9, 2.5, 40.0])
    cp = tm.controlplane_windows(acks, float(tl.window_s), tl.num_windows)
    assert cp == jax_tm.controlplane_windows(acks, float(jtl.window_s),
                                             jtl.num_windows)
    assert tm.to_doc(ps.compiled, tl, controlplane=cp) == jax_tm.to_doc(
        tree13, jtl, controlplane=cp
    )


def test_blame_buckets_equal_reference():
    v = np.concatenate([
        np.geomspace(1e-7, 20.0, 4001), [0.0, 1e-6, 10.0, np.inf]
    ]).astype(np.float32)
    from isotope_tpu.metrics import attribution as jax_attr

    got = port_attr.blame_bucket_index(torch.from_numpy(v)).numpy()
    want = np.asarray(jax_attr.blame_bucket_index(jnp.asarray(v)))
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(port_attr.blame_bucket_centers(),
                                  jax_attr.blame_bucket_centers())
    np.testing.assert_array_equal(port_attr.BLAME_EDGES,
                                  jax_attr.BLAME_EDGES)
