"""The op log (``analysis/oplog.py``) and the op auditor
(``analysis/op_audit.py``): the port's counterparts of the reference's
jaxpr trace and ``jaxpr_audit``.

The VET-J rules fire on recorded defects and stay silent on clean code;
the engine's pilot block records at the reference's trace size, logs the
census as one entry (never its plain version's inner ops), allowlists
the block's deliberate float64 sites by name while any other float64 op
is still VET-J002, and tracks values through views, in-place writes and
aliased writes.  The reference's ``audit_cache_signature`` is copied as
a pure function and held to the reference's output.
"""
import pathlib

import pytest
import torch

from isotope_tpu.analysis import jaxpr_audit as jax_audit
from isotope_tpu_torch.analysis import op_audit, oplog
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.native import census as census_mod
from isotope_tpu_torch.sim.config import LoadModel
from isotope_tpu_torch.sim.engine import Simulator

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPEN = LoadModel(kind="open", qps=100.0)
CHAIN = {
    "services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b"},
    ]
}


def chain_sim():
    return Simulator(compile_graph(ServiceGraph.decode(CHAIN)),
                     device="cpu")


def example_sim(name):
    g = ServiceGraph.from_yaml_file(ROOT / "examples/topologies" / name)
    return Simulator(compile_graph(g), device="cpu")


def record(fn, *args):
    log = oplog.OpLog()
    with log.record():
        out = fn(*args)
    return log, out


@pytest.fixture(autouse=True)
def _no_inject(monkeypatch):
    monkeypatch.delenv("ISOTOPE_VET_INJECT", raising=False)


# -- the rules on recorded code -------------------------------------------------


def _defective(x):
    x.max().item()                                   # a host read
    y = (x.to(torch.float64) * 2.0).to(torch.float32)  # a wide dtype
    h = torch.zeros(4).index_add_(0, torch.tensor([0, 1, 1, 3]), y[:4])
    return h, x[x > 0.5]                             # data-dependent shape


def test_audit_flags_host_reads_wide_dtypes_and_float_scatter_adds():
    log, _ = record(_defective, torch.rand(8))
    by_rule = {}
    for f in op_audit.audit_log(log):
        by_rule.setdefault(f.rule, []).append(f)
    assert [f.path.split("@")[0] for f in by_rule["VET-J001"]] == [
        "aten._local_scalar_dense", "aten.index.Tensor"]
    assert {f.severity for f in by_rule["VET-J001"]} == {"error"}
    assert [f.path.split("@")[0] for f in by_rule["VET-J002"]] == [
        "aten._to_copy", "aten.mul.Tensor"]
    assert all(f.path.endswith("->float64") for f in by_rule["VET-J002"])
    (j3,) = by_rule["VET-J003"]
    assert j3.severity == "info" and j3.path.startswith("aten.index_add_@")


def test_clean_code_audits_clean():
    log, _ = record(lambda x: (x * 2.0).sum(), torch.rand(8))
    assert op_audit.audit_log(log) == []


def test_sites_fold_past_five_like_reference():
    def many(x):
        return [x.to(torch.float64) + i for i in range(7)]

    log, _ = record(many, torch.rand(4))
    j2 = [f for f in op_audit.audit_log(log) if f.rule == "VET-J002"]
    # two sites (the cast and the add), seven occurrences each
    assert [f.path.split("@")[0] for f in j2] == ["aten._to_copy",
                                                   "aten.add.Tensor"]
    sites = ["a", "b", "a", "c", "d", "e", "f", "g"]
    got = op_audit._fold_sites("VET-J002", "error", sites, "m")
    want = jax_audit._fold_sites("VET-J002", "error", sites, "m")
    assert [(f.rule, f.path, f.message) for f in got] == [
        (f.rule, f.path, f.message) for f in want]


def test_cache_signature_audit_matches_reference():
    class Opaque:
        pass

    opaque = repr(Opaque())
    for sig in (("engine-v1", ("scan", 0), opaque),
                ("engine-v1", ([1, 2],)),
                ("engine-v1", (3, "x"))):
        got = op_audit.audit_cache_signature(sig)
        want = jax_audit.audit_cache_signature(sig)
        assert [(f.rule, f.severity, f.path) for f in got] == [
            (f.rule, f.severity, f.path) for f in want]
    assert any(f.rule == "VET-J004"
               for f in op_audit.audit_cache_signature(
                   ("engine-v1", opaque)))


def test_unknown_inject_kind_raises_like_reference(monkeypatch):
    monkeypatch.setenv("ISOTOPE_VET_INJECT", "gradded")
    for mod in (op_audit, jax_audit):
        with pytest.raises(ValueError, match="unknown"):
            mod.inject_spec()


# -- the engine's pilot block ------------------------------------------------


def test_engine_pilot_audits_clean_at_the_trace_size():
    findings, pilot, n = op_audit.audit_simulator(chain_sim(), OPEN)
    assert [f for f in findings if f.severity == "error"] == []
    assert pilot is not None and n == 8 == pilot.n
    assert pilot.out.client_latency.shape == (8,)


def test_float64_clocks_are_allowlisted_by_site():
    """The block's float64 request clocks are named in the allowlist and
    not reported; the ``f64`` defect, at a site of its own, is."""
    pilot = oplog.run_pilot(chain_sim(), OPEN)
    wide = [op.site for op in pilot.log.ops
            if torch.float64 in op.out_dtypes]
    assert wide and set(wide) <= set(op_audit.F64_ALLOWED)
    assert "sim/engine.py:_clock_cumsum" in wide
    assert op_audit.audit_log(pilot.log) == []
    injected = oplog.run_pilot(chain_sim(), OPEN,
                               inject=op_audit._inject_f64)
    j2 = [f.path for f in op_audit.audit_log(injected.log)
          if f.rule == "VET-J002"]
    # the cast and the product, as the reference's convert and mul
    assert j2 == [f"{op}@analysis/op_audit.py:_inject_f64->float64"
                  for op in ("aten._to_copy", "aten.mul.Tensor")]


@pytest.mark.parametrize("kind,rule", [("callback", "VET-J001"),
                                       ("f64", "VET-J002")])
def test_injected_defects_are_found(kind, rule, monkeypatch):
    monkeypatch.setenv("ISOTOPE_VET_INJECT", kind)
    findings, _, _ = op_audit.audit_simulator(chain_sim(), OPEN)
    assert {f.rule for f in findings if f.severity == "error"} == {rule}


@pytest.mark.parametrize("name", ["canonical.yaml",
                                  "realistic-multitier-50.yaml",
                                  "realistic-powerlaw-100.yaml"])
def test_census_is_one_entry_with_its_named_inputs(name):
    """Each census call is one ``census`` entry, with the call's shapes
    (``Simulator.census_shapes`` at the pilot's size) and its outputs
    ``busy`` and ``excl``; the plain version's inner ops are not
    logged."""
    sim = example_sim(name)
    pilot = oplog.run_pilot(sim, OPEN)
    entries = [op for op in pilot.log.ops if op.name == oplog.CENSUS]
    shapes = sim.census_shapes(pilot.n)
    assert len(entries) == len(shapes) == pilot.log.census_calls
    for op, (n, b, p, fail, err) in zip(entries, shapes):
        assert op.out_shapes == ((n, b), (n, b, p))
        assert op.in_shapes[:3] == ((b, p), (b, p), (n, b, p))
        assert len(op.ins) == 3 + fail + err
    assert not any(op.site.startswith("native/census.py")
                   for op in pilot.log.ops)
    assert {op.site for op in entries} <= {
        "sim/engine.py:_simulate_core", "sim/engine.py:_tiled_sweep"}
    assert census_mod.AUDIT is None


def test_census_hook_is_off_outside_a_recording():
    """With no log recording the census takes no detour: the hook is
    ``None`` before, after, and after a recording that raised."""
    assert census_mod.AUDIT is None
    log = oplog.OpLog()
    with pytest.raises(RuntimeError, match="boom"):
        with log.record():
            assert census_mod.AUDIT is not None
            raise RuntimeError("boom")
    assert census_mod.AUDIT is None
    with log.record():
        with pytest.raises(RuntimeError, match="already recording"):
            with oplog.OpLog().record():
                pass
    assert census_mod.AUDIT is None


@pytest.mark.parametrize("conns", [4, 64])
def test_closed_loop_pilot_runs_one_request_per_connection(conns):
    load = LoadModel(kind="closed", qps=100.0, connections=conns)
    assert oplog.pilot_size(load) == max(8, conns)
    pilot = oplog.run_pilot(chain_sim(), load)
    assert pilot.n == max(8, conns)
    assert pilot.out.client_latency.shape == (pilot.n,)


def test_qps_max_pilot_is_the_plain_closed_loop(monkeypatch):
    """``-qps max`` is audited through the plain closed loop: its
    saturated tables come from pilot runs, which vet must not start."""
    def boom(*a, **k):  # pragma: no cover - must never run
        raise AssertionError("vet built the saturated tables")

    monkeypatch.setattr(Simulator, "_closed_tables", boom)
    monkeypatch.setattr(Simulator, "solve_closed_rate", boom)
    load = LoadModel(kind="closed", qps=None, connections=16)
    findings, pilot, n = op_audit.audit_simulator(chain_sim(), load)
    assert n == 16 and findings == []


# -- values and bytes ----------------------------------------------------------


def test_writes_through_a_view_reach_the_base():
    """A write through a view makes a new version of the base's value
    (an ``alias`` join), so a read of the base depends on the write."""
    def fn(x, y):
        base = torch.zeros(4)
        base[1:3].copy_(y)
        return base * x

    x, y = torch.ones(4), torch.rand(2)
    log = oplog.OpLog()
    vy = log.read(y)
    with log.record():
        out = fn(x, y)
    (mul,) = [op for op in log.ops if op.name == "aten.mul.Tensor"]
    reach = {vy}
    for op in log.ops:
        if reach & set(op.ins):
            reach |= set(op.outs)
    assert set(mul.outs) <= reach
    assert any(op.name == oplog.ALIAS for op in log.ops)
    assert out.shape == (4,)


def test_live_bytes_follow_the_storages():
    """The high-water counts the storages the span allocated while they
    live; a freed storage leaves the live total, and the inputs it read
    count apart as external bytes."""
    x = torch.zeros(1024)

    def fn(x):
        a = x + 1.0           # 4 KiB
        b = a * 2.0           # 4 KiB, a still live
        del a
        c = b.sum()
        del b
        return c

    log, _ = record(fn, x)
    assert log.external_bytes == 4096
    assert log.peak_bytes >= 8192
    assert log.live_bytes <= 16
