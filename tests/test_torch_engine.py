"""The port's engine against the JAX package's, draw for draw.

Both engines run the same compiled tables (the JAX package's, carried
across with ``compiled_from_arrays``) on the same random numbers: the
port's draw source replays the JAX engine's own streams from its
``PRNGKey`` (``tests/test_torch_replay.py``).  The JAX side runs as its
own tests run it, on the CPU with its default parameters.

Tolerances: ``hop_sent``, ``hop_error``, ``client_error`` and
``unstable`` must be exactly equal; float fields agree within rtol
1e-5, atol 1e-9 s, because ``log``, ``erf``/``erfc``, ``cumsum`` and
the copula matmul round differently in XLA and torch by a few ULP.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.generators import tree_topology as jax_tree
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import queueing as jax_queueing
from isotope_tpu_torch.compiler import (
    compile_graph,
    compiled_from_arrays,
    compiled_to_arrays,
)
from isotope_tpu_torch.models.generators import tree_topology
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim import engine as engine_mod
from isotope_tpu_torch.sim import queueing
from test_torch_replay import (
    JaxReplayDraws,
    assert_results_match,
    port_compiled,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPOLOGIES = ROOT / "examples" / "topologies"

# the retry/timeout/error topology of tests/test_census_pallas.py
CENSUS_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 30ms, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  script:
  - - call: {service: leaf, timeout: 10ms, retries: 1}
    - call: {service: leaf2, probability: 60}
- name: leaf
  errorRate: 3%
- name: leaf2
  script:
  - call: deep
- name: deep
"""


def _flagship_doc():
    return dict(num_levels=5, num_branches=3, request_size=1024,
                response_size=1024)


def _graphs(name):
    """(JAX graph, port graph) of one named topology."""
    if name == "flagship":
        return (
            JaxGraph.decode(jax_tree(**_flagship_doc())),
            ServiceGraph.decode(tree_topology(**_flagship_doc())),
        )
    if name == "census":
        return JaxGraph.from_yaml(CENSUS_YAML), ServiceGraph.from_yaml(
            CENSUS_YAML
        )
    path = TOPOLOGIES / f"{name}.yaml"
    return JaxGraph.from_yaml_file(path), ServiceGraph.from_yaml_file(path)


_SIMS = {}


def _pair(name):
    """(JAX simulator, port simulator on the CPU) on the same tables."""
    if name not in _SIMS:
        jg, _ = _graphs(name)
        jc = jax_compile_graph(jg)
        _SIMS[name] = (
            JaxSimulator(jc),
            Simulator(port_compiled(jc), device="cpu"),
        )
    return _SIMS[name]


# -- compiled tables ---------------------------------------------------------


@pytest.mark.parametrize("name", ["flagship", "canonical", "census"])
def test_compile_graph_matches_reference(name):
    jg, pg = _graphs(name)
    want = compiled_to_arrays(jax_compile_graph(jg))
    got = compiled_to_arrays(compile_graph(pg))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_compiled_from_arrays_round_trips():
    _, pg = _graphs("census")
    compiled = compile_graph(pg)
    fields = compiled_to_arrays(compiled)
    again = compiled_to_arrays(compiled_from_arrays(fields))
    assert sorted(again) == sorted(fields)
    for key in fields:
        np.testing.assert_array_equal(again[key], fields[key], err_msg=key)
    back = compiled_from_arrays(fields)
    assert back.services.names == compiled.services.names
    assert back.num_hops == compiled.num_hops
    assert back.max_steps == compiled.max_steps


# -- the M/M/k wait law --------------------------------------------------------


def test_queueing_matches_reference():
    rng = np.random.default_rng(5)
    lam = rng.uniform(10.0, 40_000.0, 64).astype(np.float32)
    reps = rng.integers(1, 6, 64).astype(np.int32)
    mu = 13_000.0
    want = jax_queueing.mmk_params(
        jnp.asarray(lam), mu, jnp.asarray(reps), 5
    )
    got = queueing.mmk_params(
        torch.from_numpy(lam), mu, torch.from_numpy(reps), 5
    )
    for field in ("p_wait", "wait_rate", "utilization"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=1e-6, err_msg=field,
        )
    np.testing.assert_array_equal(
        got.unstable.numpy(), np.asarray(want.unstable)
    )
    u = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    w_want = jax_queueing.sample_wait_conditional(
        want.p_wait, want.wait_rate, jnp.asarray(u)
    )
    w_got = queueing.sample_wait_conditional(
        got.p_wait, got.wait_rate, torch.from_numpy(u)
    )
    np.testing.assert_allclose(
        w_got.numpy(), np.asarray(w_want), rtol=1e-5, atol=1e-9
    )


def test_ndtr_matches_reference_in_both_tails():
    """torch.special.ndtr returns 0 at -6 in float32; the port's ndtr
    keeps the reference's relative accuracy in the lower tail."""
    x = np.linspace(-7.0, 7.0, 2801).astype(np.float32)
    want = np.asarray(jax.scipy.special.ndtr(jnp.asarray(x)))
    got = engine_mod.ndtr(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# -- Simulator.run, same draws -------------------------------------------------


@pytest.mark.parametrize(
    "name,n,qps",
    [
        ("flagship", 2048, 1000.0),
        ("canonical", 2048, 1000.0),
        ("census", 2048, 500.0),
        ("1000-svc_2000-end", 256, 1000.0),
        # wide scripts: census steps P = 20 and 26 with error flags,
        # 3 and 46, 14 and 19
        ("realistic-powerlaw-100", 256, 200.0),
        ("realistic-star-50", 256, 200.0),
        ("realistic-star-auxiliary-50", 256, 200.0),
    ],
)
def test_open_loop_run_matches_reference(name, n, qps):
    jax_sim, sim = _pair(name)
    key = jax.random.PRNGKey(0)
    want = jax_sim.run(JaxLoad(kind="open", qps=qps), n, key)
    got = sim.run(LoadModel(kind="open", qps=qps), n,
                  JaxReplayDraws(key, jax_sim))
    assert_results_match(got, want)


def test_paced_closed_loop_run_matches_reference():
    """c=8 at 1000 qps on canonical.yaml: the solved rate is the JAX
    one, and 2003 requests exercise the n % c remainder requests."""
    jax_sim, sim = _pair("canonical")
    key = jax.random.PRNGKey(3)
    jload = JaxLoad(kind="closed", qps=1000.0, connections=8)
    load = LoadModel(kind="closed", qps=1000.0, connections=8)
    source = JaxReplayDraws(key, jax_sim)
    lam = jax_sim.solve_closed_rate(jload, 2003, key)
    assert sim.solve_closed_rate(load, 2003, source) == lam
    want = jax_sim.run(jload, 2003, key)
    got = sim.run(load, 2003, source)
    assert_results_match(got, want)


# -- device and unsupported features -------------------------------------------


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    _, pg = _graphs("canonical")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(compile_graph(pg))


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(rollouts=object()), "protected layers"),
        # the lb laws are ported (tests/test_torch_lb.py); the timeline
        # recorder is not
        (dict(params=SimParams(timeline=True)), "observability"),
        (dict(policies=object()), "protected layers"),
        (dict(params=SimParams(attribution=True)), "observability"),
        (dict(params=SimParams(ensemble=2)), "fleets"),
    ],
)
def test_unported_features_raise(kwargs, item):
    _, pg = _graphs("canonical")
    with pytest.raises(NotImplementedError, match=item):
        Simulator(compile_graph(pg), device="cpu", **kwargs)


def test_saturated_closed_loop_builds_under_phases():
    """The saturated closed loop (``qps=None``) composes with chaos
    phases: a phased ``-qps max`` Simulator builds one table row per
    phase (held to the reference in ``test_torch_closed_phased.py``);
    a phased mTLS tax keeps ``-qps max`` on the open-loop law, as in the
    reference."""
    from isotope_tpu_torch.sim.config import ChaosEvent, MtlsSchedule

    _, pg = _graphs("canonical")
    sat = LoadModel(kind="closed", qps=None)
    sim = Simulator(compile_graph(pg), device="cpu")
    assert sim._saturated(sat)
    assert sim.draw_spec(64, "closed", saturated=True).saturated
    phased = Simulator(
        compile_graph(pg), device="cpu",
        chaos=(ChaosEvent("b", 1.0, 2.0, replicas_down=1),),
    )
    assert phased._saturated(sat)
    thr = phased._closed_tables(8, TorchDraws(0, "cpu"))[0]
    assert thr.shape == (3,) and np.all(thr > 0)
    taxed = Simulator(compile_graph(pg), device="cpu",
                      mtls=MtlsSchedule(1.0, (0.0, 1e-3)))
    assert not taxed._saturated(sat)


def test_sparse_level_raises():
    """A skewed wide level leaves the dense encoding.  The port used to
    refuse it; it now lowers it as the reference does: tiled by default,
    sparse with tiling off (held to the reference in
    ``tests/test_torch_sparse.py``)."""
    doc = {
        "services": [
            {"name": "root", "isEntrypoint": True,
             "script": [[{"call": "wide"}]
                        + [{"call": f"n{i}"} for i in range(39)]]},
            {"name": "wide", "script": [{"call": "leaf"}] * 40},
            {"name": "leaf"},
        ] + [{"name": f"n{i}", "script": [{"call": "leaf"}]}
             for i in range(39)],
    }
    compiled = compile_graph(ServiceGraph.decode(doc))
    tiled = Simulator(compiled, SimParams(sparse_level_elems=1),
                      device="cpu")
    sparse = Simulator(
        compiled, SimParams(sparse_level_elems=1, sparse_tiling=False),
        device="cpu",
    )
    assert any(lvl.tiled is not None for lvl in tiled._levels)
    assert any(lvl.sparse is not None for lvl in sparse._levels)
    load = LoadModel(kind="open", qps=100.0)
    a = tiled.run(load, 64, TorchDraws(7, "cpu"))
    b = sparse.run(load, 64, TorchDraws(7, "cpu"))
    assert torch.equal(a.hop_sent, b.hop_sent)
    np.testing.assert_allclose(a.client_latency.numpy(),
                               b.client_latency.numpy(), rtol=1e-5)


# -- the port imports no JAX ----------------------------------------------------


def test_port_imports_no_jax():
    """Import every module of isotope_tpu_torch with jax and the JAX
    package made unimportable."""
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "isotope_tpu"):
                    raise ImportError(f"refused import of {name}")
                return None

        for mod in [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "isotope_tpu")]:
            del sys.modules[mod]
        sys.meta_path.insert(0, Refuse())
        import isotope_tpu_torch
        names = [isotope_tpu_torch.__name__] + [
            m.name for m in pkgutil.walk_packages(
                isotope_tpu_torch.__path__, "isotope_tpu_torch.")
        ]
        for name in names:
            if not name.endswith("__main__"):
                importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "isotope_tpu")]
        assert not bad, bad
        print(" ".join(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    # among them the modules of the tiled levels, the saturated closed
    # loop and the check command
    for name in ("sim.engine", "sim.closed", "sim.summary",
                 "models.generators", "metrics.prometheus",
                 "metrics.query", "metrics.alarms", "cli",
                 "sim.lb", "sim.oracle", "native.host"):
        assert f"isotope_tpu_torch.{name}" in names, name
    assert len(names) >= 25
