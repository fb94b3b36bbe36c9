"""The port's DES fidelity oracle (``sim/oracle.py`` over its own copy
of ``native/des_oracle.cpp``) against the JAX package's, and the port's
engine against the oracle.

1. The C++ source is a byte-for-byte copy and the port's
   ``OracleSimulator`` gives arrays identical to the reference's for the
   same graph, load and seed.
2. Interpreter parity (``tests/test_oracle.py:109-200``): under
   deterministic service times and a quiet load the port's engine and
   the oracle are both exact, so client latencies agree to rtol 1e-5,
   and errors and hop events are equal.
3. Station physics: the oracle's M/M/1 closed form (the reference's
   bands: p50 3%, p99 4%, utilization 2%).
4. Fidelity at a CPU size: the port's engine (40,000 requests) against
   the oracle (200,000), chain3 at rho 0.7, warm-up 0.5 s.  The
   reference's band is 5% at 200,000 / 1,000,000 requests; at 40,000
   the engine's own p99 carries a sampling error of ~1.1% (one standard
   error of the 0.99 quantile of an exponential-like tail), so the
   reference's 5% band still holds with margin and is kept.
5. The reference's remaining fidelity gates (``tests/test_oracle.py``
   :293-655: saturated throughput and fidelity per topology with star9's
   asymmetric band, probabilistic chain, mixed replicas, chaos phases,
   heavy tails, fork-join throughput, the retry-storm collapse with its
   feedback-blind twin, error-rate and call-probability fractions, the
   open high-rho envelope), each at the reference's own sizes and bands
   on the port's engine on the CPU: the same gate table
   (``chip_smoke.oracle_gates``) that ``chip_smoke.py`` phase 7 runs on
   the card.
"""
import pathlib

import numpy as np
import pytest

from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim.config import ChaosEvent as JaxChaos
from isotope_tpu.sim.oracle import OracleSimulator as JaxOracle
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim.config import ChaosEvent
from isotope_tpu_torch.sim.oracle import OracleSimulator, oracle_quantiles
from test_oracle import CHAIN3, STAR9, TREE13

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
DET = SimParams(service_time="deterministic")
QUIET = LoadModel(kind="open", qps=0.001, duration_s=1.0)
MU = 1.0 / SimParams().cpu_time_s

RETRY_TIMEOUT = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 3ms, retries: 2}
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


def test_des_source_is_a_copy():
    want = (ROOT / "isotope_tpu" / "native" / "des_oracle.cpp").read_bytes()
    got = (ROOT / "isotope_tpu_torch" / "native" / "des_oracle.cpp")
    assert got.read_bytes() == want


ORACLE_CASES = {
    "chain3-open": (CHAIN3, dict(kind="open", qps=0.7 * MU), ()),
    "tree13-closed": (TREE13,
                      dict(kind="closed", qps=0.5 * MU, connections=16), ()),
    "star9-max": (STAR9, dict(kind="closed", qps=None, connections=8), ()),
    "retries-chaos": (
        RETRY_TIMEOUT, dict(kind="open", qps=2000.0),
        (dict(service="mid", start_s=0.5, end_s=1.0, replicas_down=1),
         dict(service="leaf2", start_s=1.2, end_s=1.5, drain=False)),
    ),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracle_arrays_equal_reference(name):
    yaml_text, load, chaos = ORACLE_CASES[name]
    params = dict(service_time="lognormal", service_time_param=0.5)
    got = OracleSimulator(
        ServiceGraph.from_yaml(yaml_text), SimParams(**params),
        tuple(ChaosEvent(**c) for c in chaos),
    ).run(LoadModel(**load), 20_000, seed=7)
    want = JaxOracle(
        JaxGraph.from_yaml(yaml_text), JaxParams(**params),
        tuple(JaxChaos(**c) for c in chaos),
    ).run(JaxLoad(**load), 20_000, seed=7)
    for field in ("client_start", "client_latency", "client_error",
                  "busy_time", "arrivals"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.hop_events == want.hop_events > 0


# -- interpreter parity (tests/test_oracle.py:109-200) ------------------------

PARITY = {
    "sequential-sleeps-and-calls": """
services:
- name: entry
  isEntrypoint: true
  script:
  - sleep: 10ms
  - call: leaf
  - sleep: 5ms
- name: leaf
""",
    "concurrent-join-with-sleep": """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{sleep: 30ms}, {call: fast}, {call: slow}]
- name: fast
- name: slow
  script: [{sleep: 50ms}]
""",
    "error-rate-fast-500-skips-script": """
services:
- name: entry
  isEntrypoint: true
  script: [{call: flaky}]
- name: flaky
  errorRate: 100%
  script: [{sleep: 80ms}]
""",
    "retries-exhausted-by-500s": """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: flaky, retries: 2}
- name: flaky
  errorRate: 100%
""",
    "timeout-is-transport-and-truncates": """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: slow, timeout: 10ms}
  - sleep: 40ms
- name: slow
  script: [{sleep: 60ms}]
""",
    "chaos-total-outage": CHAIN3,
}


def parity_pair(name, yaml_text, seed=0):
    """(engine results, oracle results) of 32 quiet requests."""
    graph = ServiceGraph.from_yaml(yaml_text)
    chaos = (
        (ChaosEvent(service="b", start_s=0.0, end_s=1e9),)
        if name == "chaos-total-outage" else ()
    )
    engine = Simulator(compile_graph(graph), DET, chaos, device="cpu")
    res_e = engine.run(QUIET, 32, TorchDraws(seed, "cpu"))
    res_o = OracleSimulator(graph, DET, chaos).run(QUIET, 32, seed=seed)
    return res_e, res_o


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_with_the_engine(name):
    res_e, res_o = parity_pair(name, PARITY[name])
    np.testing.assert_allclose(
        res_o.client_latency,
        res_e.client_latency.numpy().astype(np.float64), rtol=1e-5,
    )
    np.testing.assert_array_equal(res_o.client_error,
                                  res_e.client_error.numpy())
    assert res_o.hop_events == int(res_e.hop_events)
    if name == "chaos-total-outage":
        assert res_o.client_error.all()


def test_oracle_matches_mm1_closed_form():
    p = SimParams()
    sim = OracleSimulator(
        ServiceGraph.from_yaml("services:\n- name: a\n  isEntrypoint: true\n"),
        p,
    )
    lam = 0.7 * MU
    res = sim.run(LoadModel(kind="open", qps=lam), 1_000_000, seed=1)
    root_net = p.network.one_way(0) + p.network.one_way(0)
    soj = res.client_latency[res.client_start > 0.5] - root_net
    rate = MU - lam
    # M/M/1 FIFO sojourn ~ Exp(mu - lambda)
    assert np.quantile(soj, 0.5) == pytest.approx(np.log(2) / rate, rel=0.03)
    assert np.quantile(soj, 0.99) == pytest.approx(
        -np.log(0.01) / rate, rel=0.04
    )
    dur = float(res.client_end.max())
    assert res.utilization(dur, sim.replicas)[0] == pytest.approx(
        0.7, rel=0.02
    )


def test_open_loop_fidelity_chain3_at_cpu_size():
    """p50 and p99 of the port's engine within 5% of the oracle's."""
    load = LoadModel(kind="open", qps=0.7 * MU)
    engine = Simulator(compile_graph(ServiceGraph.from_yaml(CHAIN3)),
                       device="cpu")
    lat_e = engine.run(load, 40_000, TorchDraws(0, "cpu")).client_latency
    lat_e = lat_e.numpy().astype(np.float64)
    want = oracle_quantiles(CHAIN3, load, 200_000, warmup_s=0.5)
    for q, o in zip((0.5, 0.99), want):
        rel = np.quantile(lat_e, q) / o - 1.0
        assert abs(rel) <= 0.05, (q, rel)


# -- the remaining fidelity gates (tests/test_oracle.py:293-655) --------------

GATES = {g.name: g for g in chip_smoke.oracle_gates()}


def _port():
    from types import SimpleNamespace

    return SimpleNamespace(
        compile_graph=compile_graph, ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, SimParams=SimParams, Simulator=Simulator,
        TorchDraws=TorchDraws, ChaosEvent=ChaosEvent,
    )


def test_gate_table_covers_the_reference_cases():
    """Every remaining case of the reference's fidelity axis, with its
    bands: star9's saturated band stays asymmetric."""
    assert len(GATES) == 19
    for name in ("saturated throughput chain3", "saturated fidelity star9",
                 "saturated chaos phases", "retry-storm collapse",
                 "error-rate fidelity", "call-probability fidelity",
                 "open high-rho tree13 rho 0.9",
                 "saturated fork-join throughput star9"):
        assert name in GATES, name


@pytest.mark.parametrize("name", sorted(GATES))
def test_fidelity_gate_on_the_cpu(name):
    """The port's engine, on the CPU, within the reference's band of the
    oracle (the gate raises out of band)."""
    gate = GATES[name]
    port = _port()
    line = gate.check(gate.engine(port, "cpu"), gate.oracle(port))
    assert line.startswith(f"oracle gate {name}:")
