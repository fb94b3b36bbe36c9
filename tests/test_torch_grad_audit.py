"""The gradient audit (``analysis/grad_audit.py``, ``vet --grad``)
against the JAX package's.

The port's forward taint runs over the op log of a knob-armed pilot
block (``cpu_scale`` / ``err_scale`` passed, reduced to its
``RunSummary``); the reference's over the jaxpr of its member body.
Each knob's class, the objectives' live knobs and the vacuous
objectives must equal the reference's (run live through
``test_torch_vet.jax_core_alias``) and the vendored
``tests/data/grad_audit_canonical.json``.  Kill sites are aten names.
"""
import json
import pathlib

import pytest
import torch

from isotope_tpu.analysis import grad_audit as jax_grad
from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim.config import DESIGN_PARAMS as JAX_DESIGN_PARAMS
from isotope_tpu.sim.config import LoadModel as JaxLoad
from isotope_tpu.sim.engine import Simulator as JaxSimulator
from isotope_tpu_torch.analysis import grad_audit, oplog
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim.config import DESIGN_PARAMS, LoadModel
from isotope_tpu_torch.sim.engine import Simulator
from test_torch_vet import jax_core_alias  # noqa: F401  (fixture)

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
CASES = {
    "canonical": (ROOT / "examples/topologies/canonical.yaml").read_text(),
    "canonical-errors": (
        ROOT / "examples/topologies/canonical-errors.yaml"
    ).read_text(),
    "chain": CHAIN,
}


def audit_both(text, **load):
    load = load or OPEN
    jsim = JaxSimulator(jax_compile_graph(JaxGraph.from_yaml(text)))
    want = jax_grad.audit_grad(jsim, JaxLoad(**load))
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(text)),
                    device="cpu")
    got = grad_audit.audit_grad(sim, LoadModel(**load))
    return got, want


@pytest.fixture(autouse=True)
def _no_inject(monkeypatch):
    monkeypatch.delenv("ISOTOPE_VET_INJECT", raising=False)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kind", ["open", "closed"])
def test_classes_and_objectives_equal_reference(name, kind,
                                                jax_core_alias):
    load = dict(kind=kind, qps=100.0, connections=16)
    (finds, doc), (jfinds, jdoc) = audit_both(CASES[name], **load)
    assert doc["schema"] == jdoc["schema"] == grad_audit.SCHEMA
    assert doc["invars"] == jdoc["invars"]
    for key in ("classes", "objectives", "vacuous_objectives",
                "traced_requests"):
        assert doc[key] == jdoc[key], key
    assert sorted(f.rule for f in finds) == sorted(f.rule for f in jfinds)
    assert doc["eqns_walked"] > 0


def test_canonical_classification_is_pinned():
    """The port's classification against the vendored pin the
    reference's tier-1 test reads."""
    expected = json.loads(
        (ROOT / "tests/data/grad_audit_canonical.json").read_text()
    )
    sim = Simulator(compile_graph(ServiceGraph.from_yaml_file(
        ROOT / expected["topology"])), device="cpu")
    _, doc = grad_audit.audit_grad(sim, LoadModel(**OPEN))
    assert doc["classes"] == expected["classes"]
    assert doc["vacuous_objectives"] == expected["vacuous_objectives"]


def test_errors_example_names_the_coin_comparison():
    """On canonical-errors, the first killer of ``error_rate_scale`` is
    the 5xx coin's comparison: an ``aten.lt`` (the reference's
    ``scan/body/lt``)."""
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(
        CASES["canonical-errors"])), device="cpu")
    finds, doc = grad_audit.audit_grad(sim, LoadModel(**OPEN))
    (k,) = [k for k in doc["knobs"] if k["name"] == "error_rate_scale"]
    assert k["class"] == grad_audit.CLASS_DEAD
    assert k["kills"][0] == "aten.lt"
    (f,) = [f for f in finds if f.rule == "VET-G001"]
    assert "aten.lt" in f.message and f.path == "aten.lt"


def test_chain_error_rate_is_inert():
    """Zero error rates elide the 5xx coin: ``error_rate_scale`` never
    reaches an output (no kill), as in the reference."""
    sim = Simulator(compile_graph(ServiceGraph.from_yaml(CHAIN)),
                    device="cpu")
    finds, doc = grad_audit.audit_grad(sim, LoadModel(**OPEN))
    (k,) = [k for k in doc["knobs"] if k["name"] == "error_rate_scale"]
    assert k["class"] == grad_audit.CLASS_DEAD and k["kills"] == []
    (f,) = [f for f in finds if f.rule == "VET-G001"]
    assert f.path == "err_scale"


def test_graddead_injection_surfaces_g001(monkeypatch, jax_core_alias):
    monkeypatch.setenv("ISOTOPE_VET_INJECT", "graddead")
    (finds, doc), (jfinds, jdoc) = audit_both(CHAIN)
    assert doc["classes"] == jdoc["classes"]
    assert doc["classes"]["cpu_time_s"] == grad_audit.CLASS_DEAD
    (f,) = [f for f in finds
            if f.rule == "VET-G001" and "cpu_time_s" in f.message]
    assert "aten.floor" in f.message and f.path == "aten.floor"


def test_design_params_registry_is_the_reference_s():
    assert [vars(p) for p in DESIGN_PARAMS] == [
        vars(p) for p in JAX_DESIGN_PARAMS]
    assert grad_audit.GRAD_INVARS == jax_grad.GRAD_INVARS
    assert grad_audit.OBJECTIVE_LEAVES == jax_grad.OBJECTIVE_LEAVES
    for p in DESIGN_PARAMS:
        for invar in p.invars:
            assert invar in grad_audit.GRAD_INVARS, (p.name, invar)
        if not p.traced:
            assert p.constant_site, p.name


def test_grad_findings_equal_reference_on_one_document(jax_core_alias):
    """``grad_findings`` is the reference's: the same findings from the
    same document."""
    _, (_, jdoc) = audit_both(CASES["canonical-errors"])
    got = grad_audit.grad_findings(jdoc)
    want = jax_grad.grad_findings(jdoc)
    assert [(f.rule, f.severity, f.path, f.message) for f in got] == [
        (f.rule, f.severity, f.path, f.message) for f in want]


# -- the taint on recorded code --------------------------------------------------


def _taint(fn, *args):
    """Seed knob ``k`` at the first argument, record ``fn`` and run the
    taint: ``(taint of the output, state)``."""
    log = oplog.OpLog()
    v = log.read(args[0])
    with log.record():
        out = fn(*args)
    state = grad_audit._TaintState()
    env = grad_audit.analyze_log(log, {v: {"k": (True, None)}}, state)
    return env.get(log.read(out), {}), state


X = torch.tensor([0.5, 1.5, 2.5])
Y = torch.tensor([1.0, 1.0, 1.0])


def test_smooth_path_stays_live():
    out, _ = _taint(lambda x: torch.exp(x * 2.0).sum(), X)
    assert out == {"k": (True, None)}


def test_floor_kills_with_named_site():
    out, state = _taint(lambda x: torch.floor(x) * 2.0, X)
    assert out == {"k": (False, "aten.floor")}
    assert list(state.kills["k"]) == ["aten.floor"]


def test_comparison_dtype_kill_names_the_comparison():
    out, _ = _taint(lambda x: (x < 1.0).to(torch.float32), X)
    assert out == {"k": (False, "aten.lt")}


def test_predicate_only_where_names_the_feeder():
    out, state = _taint(lambda x: torch.where(x > 1.0, Y, 2.0 * Y), X)
    assert out == {"k": (False, "aten.where←aten.gt")}
    out, _ = _taint(lambda x: torch.where(x > 1.0, x, Y), X)
    assert out == {"k": (True, None)}


def test_integer_cast_and_detach_kill():
    out, _ = _taint(lambda x: x.to(torch.int64).to(torch.float32), X)
    assert out == {"k": (False, "aten._to_copy")}
    out, _ = _taint(lambda x: torch.ops.aten.detach(x) * 2.0, X)
    assert out == {"k": (False, "aten.detach")}


def test_shape_only_ops_carry_no_taint():
    """``ones_like`` reads its argument's shape, not its value (a jaxpr
    broadcasts a literal): a histogram of ones stays untainted."""
    out, _ = _taint(lambda x: torch.ones_like(x) * 3.0, X)
    assert out == {}


def test_float_scatter_add_records_g003_site():
    def fn(x):
        return torch.zeros(4).index_add_(0, torch.tensor([0, 1, 1]), x)

    out, state = _taint(fn, X)
    assert out == {"k": (True, None)}
    assert list(state.scatter["k"]) == ["aten.index_add_"]


def test_census_carries_its_float_inputs_taint():
    """The census entry carries the union of its float inputs' taint."""
    from isotope_tpu_torch.native.census import census

    base = torch.tensor([[0.1, 0.2]])
    mask = torch.ones(1, 2)

    def fn(x):
        agg = x[:2].reshape(1, 1, 2)
        busy, _ = census(base, mask, agg)
        return busy

    out, _ = _taint(fn, X)
    assert out == {"k": (True, None)}
    out, _ = _taint(lambda x: census(x[:2].reshape(1, 2), mask,
                                     torch.zeros(1, 1, 2),
                                     (x[:1] > 9).to(torch.int32)
                                     .reshape(1, 1))[1], X)
    assert out == {"k": (True, None)}
