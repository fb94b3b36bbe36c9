"""The pre-flight cost model (``analysis/costmodel.py``) against the JAX
package's.

The traced estimates cannot equal the reference's: the port's pilot
block is another program (no one-hot phase expansion, no bf16 packing)
and its op log is not a jaxpr.  What is held: the estimates are
positive and a closed loop scales by the traced request count; the
plan-only peak (``vet --no-trace``) equals the reference's to the byte;
the memory verdict's rules equal the reference's, with the start rung
mapped onto the port's two-rung ladder; the fleet and search verdicts
equal the reference's on the same numbers, and the ``ensemble`` and
``search`` chunks ``vet`` reports are the ones the engine picks.  The
reference runs live through ``test_torch_vet.jax_core_alias``.
"""
import pathlib

import pytest

from isotope_tpu.analysis import costmodel as jax_cost
from isotope_tpu.analysis import vet as jax_vet
from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim.config import LoadModel as JaxLoad
from isotope_tpu.sim.config import SimParams as JaxParams
from isotope_tpu.sim.engine import Simulator as JaxSimulator
from isotope_tpu_torch.analysis import costmodel, oplog
from isotope_tpu_torch.analysis import vet_simulator, vet_topology_path
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim.config import LoadModel, SimParams
from isotope_tpu_torch.sim.engine import Simulator
from isotope_tpu_torch.sim.ensemble import EnsembleSpec
from isotope_tpu_torch.sim.search import SearchSpec, search_auto_chunk
from test_torch_vet import SHIPPED, jax_core_alias  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPEN = dict(kind="open", qps=100.0)
CHAIN = """
services:
- name: a
  isEntrypoint: true
  script:
  - call: b
- name: b
"""


def chain_pair(params=None):
    jsim = JaxSimulator(jax_compile_graph(JaxGraph.from_yaml(CHAIN)),
                        JaxParams(**(params or {})))
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(CHAIN)),
                    SimParams(**(params or {})), device="cpu")
    return jsim, sim


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("ISOTOPE_VET_INJECT", "ISOTOPE_VET_DEVICE_BYTES",
                 "ISOTOPE_VET_TIMELINE_SHARE"):
        monkeypatch.delenv(name, raising=False)


def test_estimates_are_positive():
    _, sim = chain_pair()
    pilot = oplog.run_pilot(sim, LoadModel(**OPEN))
    assert pilot.n == 8
    oc = costmodel.oplog_cost(pilot.log)
    assert oc.flops > 0 and oc.peak_bytes > 0 and oc.critical_path > 0
    assert oc.external_bytes > 0
    rows = costmodel.segment_table(sim, 4096)
    assert len(rows) == len(sim._levels)
    assert all(r["elems"] > 0 for r in rows)
    est = costmodel.estimate_run(sim, 4096, log=pilot.log,
                                 trace_requests=pilot.n)
    assert est.peak_bytes_at_block == pytest.approx(
        oc.external_bytes + oc.peak_bytes * 4096 / 8)
    assert est.flops_at_block == pytest.approx(oc.flops * 4096 / 8)


def test_closed_loop_estimate_scales_by_actual_traced_n():
    """A 64-connection closed-loop pilot runs 64 requests, not 8: the
    estimate divides by the pilot's own count."""
    _, sim = chain_pair()
    rep_open = vet_simulator(sim, LoadModel(**OPEN), block_requests=4096)
    rep_closed = vet_simulator(
        sim, LoadModel(kind="closed", qps=100.0, connections=64),
        block_requests=4096,
    )
    assert rep_closed.meta["cost"]["trace_requests"] == 64
    po = rep_open.meta["cost"]["peak_bytes_at_block"]
    pc = rep_closed.meta["cost"]["peak_bytes_at_block"]
    assert pc == pytest.approx(po, rel=0.5)  # same order, not ~8x


@pytest.mark.parametrize("example", SHIPPED + [
    "examples/topologies/1000-svc_2000-end.yaml",
    "examples/topologies/realistic-powerlaw-100.yaml",
])
def test_plan_only_peak_equals_reference_to_the_byte(example,
                                                     jax_core_alias):
    """``--no-trace``: the plan-only estimate (ten float32 event
    tensors of the block) is the reference's, byte for byte, with the
    same block."""
    path = str(ROOT / example)
    load = dict(kind="open", qps=1000.0)
    got = vet_topology_path(path, load=LoadModel(**load), trace=False,
                            device="cpu").meta["cost"]
    want = jax_vet.vet_topology_path(path, load=JaxLoad(**load),
                                     trace=False).meta["cost"]
    assert got["block_requests"] == want["block_requests"]
    assert got["peak_bytes_at_block"] == want["peak_bytes_at_block"]
    assert got["timeline_bytes"] == want["timeline_bytes"]


def test_plan_only_peak_counts_the_recorder_like_reference():
    params = dict(timeline=True, timeline_max_windows=512)
    jsim, sim = chain_pair(params)
    got = costmodel.estimate_run(sim, 4096)
    want = jax_cost.estimate_run(jsim, 4096)
    assert got.timeline_bytes == want.timeline_bytes > 0
    assert got.peak_bytes_at_block == want.peak_bytes_at_block
    assert costmodel.peak_bytes_at_block(sim, 4096) == \
        want.peak_bytes_at_block


def test_schedule_rows_are_the_reference_planner_s(jax_core_alias):
    for example in SHIPPED:
        path = str(ROOT / example)
        got = vet_topology_path(path, trace=False, device="cpu")
        want = jax_vet.vet_topology_path(path, trace=False)
        assert got.meta["bucket_schedule"] == want.meta["bucket_schedule"]


def test_oversized_topology_trips_oom_rung_selection(jax_core_alias):
    """``--device-bytes`` far below the estimate: VET-M001 in both, the
    reference pre-selecting its host rung (2, ``cpu-eager``) and the
    port pointing past its two-rung ladder (it blocks); half the block
    fits: VET-M002 and ``half-block`` in both; ample: clean, rung 0."""
    jsim, sim = chain_pair()

    def both(device_bytes):
        want = jax_vet.vet_simulator(jsim, JaxLoad(**OPEN),
                                     block_requests=4096,
                                     device_bytes=device_bytes)
        got = vet_simulator(sim, LoadModel(**OPEN), block_requests=4096,
                            device_bytes=device_bytes)
        return got, want

    got, want = both(65536.0)
    rules = [(f.rule, f.severity) for f in got.findings
             if f.rule.startswith("VET-M")]
    assert rules == [(f.rule, f.severity) for f in want.findings
                     if f.rule.startswith("VET-M")] == [("VET-M001",
                                                         "error")]
    assert want.meta["start_rung"] == 2
    assert want.meta["rung_names"][2] == "cpu-eager"
    assert got.meta["rung_names"] == ["scan", "half-block"]
    assert got.meta["start_rung"] == 2  # past the ladder: no rung fits
    (m1,) = [f for f in got.findings if f.rule == "VET-M001"]
    assert "'scan', 'half-block'" in m1.message
    # each package's own estimate sets its thresholds
    port_peak = got.meta["cost"]["peak_bytes_at_block"]
    ref_peak = want.meta["cost"]["peak_bytes_at_block"]
    for scale, rules, rung in ((0.7, ["VET-M002"], 1), (100.0, [], 0)):
        half = vet_simulator(
            sim, LoadModel(**OPEN), block_requests=4096,
            device_bytes=port_peak * scale / costmodel.CAPACITY_FILL)
        jhalf = jax_vet.vet_simulator(
            jsim, JaxLoad(**OPEN), block_requests=4096,
            device_bytes=ref_peak * scale / jax_cost.CAPACITY_FILL)
        for rep in (half, jhalf):
            assert [f.rule for f in rep.findings
                    if f.rule.startswith("VET-M")] == rules
            assert rep.meta["start_rung"] == rung
            assert rep.meta["rung_names"][1] == "half-block"


def test_suppressed_memory_finding_suppresses_the_verdict():
    _, sim = chain_pair()
    rep = vet_simulator(sim, LoadModel(**OPEN), block_requests=4096,
                        device_bytes=65536.0, suppress=["VET-M001"])
    assert rep.meta["start_rung"] == 0
    assert [f.rule for f in rep.suppressed] == ["VET-M001"]


def _estimates(peak, cap, tl=0.0):
    """The same numbers as each package's CostEstimate."""
    got = costmodel.CostEstimate(
        block_requests=4096, trace_requests=8, oplog=None,
        peak_bytes_at_block=peak, flops_at_block=1.0, critical_path=1,
        segments=[], capacity_bytes=cap, timeline_bytes=tl)
    want = jax_cost.CostEstimate(
        block_requests=4096, trace_requests=8, jaxpr=None,
        peak_bytes_at_block=peak, flops_at_block=1.0, critical_path=1,
        segments=[], capacity_bytes=cap, timeline_bytes=tl)
    return got, want


def _same(got, want):
    assert [(f.rule, f.severity, f.message, f.path) for f in got] == [
        (f.rule, f.severity, f.message, f.path) for f in want]


@pytest.mark.parametrize("peak,cap", [(1e6, 1e9), (1e8, 1e9),
                                      (6e8, 1e9), (1e8, None)])
def test_fleet_and_search_verdicts_equal_reference(peak, cap):
    got, want = _estimates(peak, cap)
    for members in (1, 4, 16, 33):
        _same(costmodel.ensemble_findings(got, members),
              jax_cost.ensemble_findings(want, members))
        _same(costmodel.protected_ensemble_findings(got, members, 3e7),
              jax_cost.protected_ensemble_findings(want, members, 3e7))
        _same(costmodel.observed_ensemble_findings(got, members, 2e7,
                                                   1e7),
              jax_cost.observed_ensemble_findings(want, members, 2e7,
                                                  1e7))
        _same(costmodel.search_findings(got, members, connections=64),
              jax_cost.search_findings(want, members, connections=64))


def test_memory_and_timeline_verdicts_equal_reference(monkeypatch):
    for peak in (1e6, 1.2e9, 3e9):
        got, want = _estimates(peak, 2e9, tl=3e8)
        g, gr = costmodel.memory_findings(got)
        w, wr = jax_cost.memory_findings(want)
        assert [(f.rule, f.severity) for f in g] == [
            (f.rule, f.severity) for f in w]
        assert gr == wr  # the host rung's index is the port's "none"
        _same(costmodel.timeline_findings(got),
              jax_cost.timeline_findings(want))
    monkeypatch.setenv("ISOTOPE_VET_TIMELINE_SHARE", "0.5")
    got, want = _estimates(1e6, 2e9, tl=3e8)
    _same(costmodel.timeline_findings(got),
          jax_cost.timeline_findings(want))


def test_ensemble_and_search_chunks_are_the_engine_s(monkeypatch):
    """``meta['ensemble']['chunk']`` and ``meta['search']['chunk']`` are
    the chunks ``Simulator.ensemble_chunk_size`` and
    ``search_auto_chunk`` pick for the same block and capacity."""
    _, sim = chain_pair()
    block = 4096
    peak = costmodel.peak_bytes_at_block(sim, block)
    monkeypatch.setenv("ISOTOPE_VET_DEVICE_BYTES",
                       str(peak * 10 / costmodel.CAPACITY_FILL))
    load = LoadModel(kind="closed", qps=100.0, connections=8)
    spec = SearchSpec(candidates=EnsembleSpec.of(64), eta=4, rungs=3)
    rep = vet_simulator(sim, load, block_requests=block,
                        ensemble=EnsembleSpec.of(33), search_spec=spec)
    assert rep.meta["ensemble"]["chunk"] == sim.ensemble_chunk_size(
        33, block) == 9
    widest = spec.rung_widths()[0]
    assert rep.meta["search"]["chunk"] == search_auto_chunk(
        sim, widest, block, 8)
    assert rep.meta["search"]["widths"] == list(spec.rung_widths())
    assert any(f.rule == "VET-M004" for f in rep.findings)
