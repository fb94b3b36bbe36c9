"""The port's traffic-split churn, mTLS schedule, sidecar environments
and TOML surface against the JAX package's.

Runs go through both engines on the same compiled tables and replayed
draws (``tests/test_torch_replay.py``): the square-wave and canary
churn of ``tests/test_churn.py`` (one schedule, and two at 16 combos),
churn combined with a chaos outage, the continuous block timeline under
churn, the mTLS phases of ``tests/test_mtls.py`` (also under retry
feedback, whose fixed point folds the time-averaged tax, and in a paced
closed loop placed by its nominal clock), and
``two-cluster-canonical.yaml`` under the ``ISTIO`` and ``ingress``
environments.  Tolerances are the engine tests': booleans exactly,
floats within rtol 1e-5, atol 1e-9 s; the host tables (churn entries,
combo multipliers, visits) exactly.  ``load_toml`` of the port's
``runner/config.py`` must give the JAX ``load_toml``'s schedules,
environments and parameters field for field.
"""
import dataclasses
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.runner import config as jax_runner
from isotope_tpu.runner.run import _label as jax_label
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import SimParams as JaxParams
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim.config import TrafficSplit as JaxSplit
from isotope_tpu_torch import cli
from isotope_tpu_torch.runner import config as port_runner
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
from isotope_tpu_torch.sim.config import TrafficSplit
from test_torch_replay import (
    port_compiled,
    run_both,
    scenario_pair,
    summaries_both,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPOLOGIES = ROOT / "examples" / "topologies"
MU = 1.0 / SimParams().cpu_time_s
DET = dict(service_time="deterministic")

CANARY = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: v1
  - call: v2
- name: v1
  script: [{sleep: 1ms}]
- name: v2
  script: [{sleep: 1ms}]
"""

SUBTREE = """
services:
- name: entry
  isEntrypoint: true
  script: [{call: mid}]
- name: mid
  script: [{call: leaf}]
- name: leaf
"""

CHAIN3 = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{call: c}]
- name: c
"""

# retries behind timeouts: the retry-storm fixed point is active
TIMEOUTS = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: mid, timeout: 5ms, retries: 2}
- name: mid
  script:
  - call: {service: leaf, timeout: 2ms, retries: 1}
- name: leaf
"""

ROTATION = (1.0, 0.7, 0.4, 0.2)


def _split(service, period, weights):
    return dict(service=service, period_s=period, weights=tuple(weights))


def _pair(yaml_text, params=None, **scenario):
    return scenario_pair(jax_compile_graph(JaxGraph.from_yaml(yaml_text)),
                         params, **scenario)


def assert_churn_tables_equal(jax_sim, sim):
    np.testing.assert_array_equal(
        sim._hop_churn_entry, jax_sim._hop_churn_entry
    )
    assert sim._num_combos == jax_sim._num_combos
    np.testing.assert_array_equal(sim._mult_pc, jax_sim._mult_pc)
    np.testing.assert_array_equal(sim._visits_pc_np, jax_sim._visits_pc_np)
    np.testing.assert_array_equal(
        sim._visits.numpy(), np.asarray(jax_sim._visits)
    )


# name: (topology, churn, chaos, requests, qps)
CHURN_CASES = {
    "square-wave": (CANARY, [_split("v1", 1.0, (1.0, 0.0))], [], 4000,
                    500.0),
    "canary-rotation": (
        CANARY,
        [_split("v1", 0.5, ROTATION),
         _split("v2", 0.5, (0.0, 0.3, 0.6, 0.8))],
        [], 20_000, 2000.0,
    ),
    "subtree": (SUBTREE, [_split("mid", 1.0, (0.5,))], [], 4000, 500.0),
    "with-chaos": (
        CANARY, [_split("v1", 1.0, ROTATION)],
        [dict(service="v2", start_s=2.0, end_s=5.0)], 4000, 500.0,
    ),
}


@pytest.mark.parametrize("name", list(CHURN_CASES))
def test_churn_matches_reference(name):
    yaml_text, churn, chaos, n, qps = CHURN_CASES[name]
    jax_sim, sim = _pair(yaml_text, churn=churn, chaos=chaos)
    assert_churn_tables_equal(jax_sim, sim)
    got = run_both(jax_sim, sim, n, jax.random.PRNGKey(7), kind="open",
                   qps=qps)
    if name == "square-wave":
        # v1 (hop 1) runs in the first second of every two, v2 always
        phase = np.floor(got.client_start.numpy()).astype(int) % 2
        sent = got.hop_sent.numpy()
        assert sent[phase == 0, 1].all() and not sent[phase == 1, 1].any()
        assert sent[:, 2].all()


def test_churn_blocks_share_one_timeline():
    """1 s on / 1 s off at 500 qps in blocks of 1024 (~2 s each): each
    block continues the previous one's clock."""
    jax_sim, sim = _pair(CANARY, churn=[_split("v1", 1.0, (1.0, 0.0))])
    got = summaries_both(jax_sim, sim, 4096, jax.random.PRNGKey(7), 1024,
                         kind="open", qps=500.0)
    assert float(got.hop_events) / 4096 == pytest.approx(2.5, abs=0.05)


@pytest.mark.parametrize(
    "churn,match",
    [
        ([_split("nosuch", 1.0, (1.0,))], "unknown service"),
        ([_split("v1", 1.0, (1.0,)), _split("v1", 2.0, (0.5,))],
         "multiple traffic splits"),
        ([_split("entry", 1.0, (0.5,))], "no callable edge"),
        ([_split("v1", 1.0, (0.5,) * 17), _split("v2", 1.0, (0.5,) * 17)],
         "combinations"),
    ],
)
def test_churn_validation_matches_reference(churn, match):
    """The same schedules are refused with the same messages."""
    jc = jax_compile_graph(JaxGraph.from_yaml(CANARY))
    with pytest.raises(ValueError, match=match) as want:
        JaxSimulator(jc, churn=[JaxSplit(**kw) for kw in churn])
    with pytest.raises(ValueError, match=match) as got:
        Simulator(port_compiled(jc), device="cpu",
                  churn=[TrafficSplit(**kw) for kw in churn])
    assert str(got.value) == str(want.value)


MTLS_CASES = {
    "alternating": (CHAIN3, DET, dict(period_s=5.0, taxes_s=(0.0, 1e-3)),
                    200, 10.0),
    "fractional": (CHAIN3, DET,
                   dict(period_s=2.0, taxes_s=(2e-4, 5e-4, 1e-3)), 240,
                   20.0),
    # the taxed phase's 3 ms round-trip tax fires the leaf's 2 ms
    # timeout on every attempt: the fixed point raises the leaf's visits
    # from 1 to 3.44 (time-averaged tax), the stations stay below the
    # clamp (rho 0.69)
    "retry-feedback": (TIMEOUTS, {},
                       dict(period_s=0.05, taxes_s=(0.0, 1.5e-3)), 4000,
                       0.2 * MU),
}


@pytest.mark.parametrize("name", list(MTLS_CASES))
def test_mtls_matches_reference(name):
    yaml_text, params, mtls, n, qps = MTLS_CASES[name]
    jax_sim, sim = _pair(yaml_text, params, mtls=mtls)
    np.testing.assert_array_equal(
        sim._vis_arg(qps).numpy(), np.asarray(jax_sim._vis_arg(qps))
    )
    got = run_both(jax_sim, sim, n, jax.random.PRNGKey(5), kind="open",
                   qps=qps)
    if name == "alternating":
        # deterministic and quiet: the taxed phase is 2 legs x 3 edges
        # x 1 ms slower
        lat = got.client_latency.numpy().astype(np.float64)
        on = np.floor(got.client_start.numpy() / 5.0).astype(int) % 2 == 1
        assert np.median(lat[on]) - np.median(lat[~on]) == pytest.approx(
            6e-3, rel=1e-4
        )


def test_clamped_station_waits_within_their_conditioning():
    """At 0.5 mu the retry storm pushes mid and leaf past capacity: the
    wait law clamps rho at 0.9999, so its rate is 1.3/s and a wait is
    ``-log(u / p) / 1.3``.  Near ``u = p`` that is ill-conditioned: one
    float32 spacing of ``u`` (a ULP of ``ndtr`` or ``log``, which XLA and
    torch round differently) moves a wait by 1.2e-7 / 1.3 = 9e-8 s, far
    past atol 1e-9 s on millisecond waits (measured: 4.6e-8 s on one
    hop of 40,000, with and without mTLS).  Booleans stay exact; floats
    are held to four such spacings."""
    jax_sim, sim = _pair(TIMEOUTS)
    qps = 0.5 * MU
    rate = sim._replicas_pc.float() * sim._mu * (1.0 - 0.9999)
    got = run_both(jax_sim, sim, 4000, jax.random.PRNGKey(5), kind="open",
                   qps=qps,
                   atol=4 * float(np.spacing(np.float32(1.0)))
                   / float(rate.min()))
    assert bool(got.unstable[1:].all())


def test_mtls_paced_closed_loop_matches_reference():
    """The paced closed loop places each request's tax by its nominal
    clock, carried across blocks; ``-qps max`` under a phased tax falls
    back to the open-loop law, as in the reference."""
    mtls = dict(period_s=0.5, taxes_s=(0.0, 1e-3))
    jax_sim, sim = _pair(CHAIN3, DET, mtls=mtls)
    key = jax.random.PRNGKey(3)
    summaries_both(jax_sim, sim, 3 * 512, key, 512, kind="closed",
                   qps=2000.0, connections=8)
    assert not sim._saturated(LoadModel(kind="closed", qps=None))
    assert not jax_sim._saturated(JaxLoad(kind="closed", qps=None))


@pytest.mark.parametrize("env", ["ISTIO", "ingress"])
def test_two_cluster_environment_matches_reference(env):
    """Sidecar passes on every edge (ISTIO) or on the callee side plus
    the ingress gateway (ingress), over the two clusters' edge
    classes."""
    jax_params = jax_runner.DEFAULT_ENVIRONMENTS[env].apply(JaxParams())
    port_params = port_runner.DEFAULT_ENVIRONMENTS[env].apply(SimParams())
    assert dataclasses.asdict(port_params) == dataclasses.asdict(
        jax_params
    )
    jc = jax_compile_graph(JaxGraph.from_yaml_file(
        TOPOLOGIES / "two-cluster-canonical.yaml"
    ))
    assert jc.services.num_clusters == 2
    jax_sim, sim = scenario_pair(jc, (jax_params, port_params))
    run_both(jax_sim, sim, 2048, jax.random.PRNGKey(1), kind="open",
             qps=1000.0)


def test_cli_simulate_environment_label():
    """``simulate --environment ISTIO`` prints the reference's label,
    ``<stem>_istio_<qps>qps_<c>c``, and refuses unknown environments."""
    path = TOPOLOGIES / "two-cluster-canonical.yaml"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["simulate", str(path), "--qps", "500", "--duration",
                       "2s", "--load-kind", "open", "--environment",
                       "ISTIO", "--device", "cpu"])
    assert rc == 0
    doc = json.loads(buf.getvalue())
    load = JaxLoad(kind="open", qps=500.0, connections=64)
    assert doc["Labels"] == jax_label(str(path), "ISTIO", load, "")
    assert doc["Labels"] == "two-cluster-canonical_istio_500qps_64c"
    with pytest.raises(ValueError, match="unknown environment"):
        cli.main(["simulate", str(path), "--environment", "MESH",
                  "--device", "cpu"])


TOML = """
topology_paths = ["{topo}"]
environments = ["NONE", "ISTIO", "ingress", "custom", "legacy"]
labels = "churny"

[environment.ISTIO]
proxy_latency = "400us"

[environment.custom]
client_proxy = true
extra_hop_latency = "50us"

[environment.legacy]
extra_hop_latency = "1ms"

[client]
qps = [100, "max"]
num_concurrent_connections = [4, 16]
duration = "60s"

[sim]
num_requests = 5000
seed = 3
cpu_time = "100us"
service_time = "pareto"
service_time_param = 2.5

[[chaos]]
service = "b"
start = "5s"
end = "7s"
period = "10s"
repeat = 3
replicas_down = 1

[[chaos]]
service = "c"
start = "55s"
end = "58s"
drain = false

[[churn]]
service = "c"
period = "30s"
weights = [1.0, 0.7, 0.4, 0.2]

[mtls]
period = "5s"
taxes = ["0ms", "1ms", 0.0005]
"""


def _as_plain(x):
    """A config value with each dataclass turned into its dict."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, tuple):
        return tuple(_as_plain(v) for v in x)
    return x


def test_load_toml_matches_reference(tmp_path):
    topo = tmp_path / "t.yaml"
    topo.write_text((TOPOLOGIES / "canonical.yaml").read_text())
    cfg = tmp_path / "exp.toml"
    cfg.write_text(TOML.format(topo=topo))
    want = jax_runner.load_toml(cfg)
    got = port_runner.load_toml(cfg)
    for field in dataclasses.fields(want):
        assert _as_plain(getattr(got, field.name)) == _as_plain(
            getattr(want, field.name)
        ), field.name
    assert len(got.chaos) == 4 and got.chaos[3].drain is False
    assert dataclasses.asdict(got.sim_params()) == dataclasses.asdict(
        want.sim_params()
    )
    assert [dataclasses.asdict(m) for m in got.load_models()] == [
        dataclasses.asdict(m) for m in want.load_models()
    ]
    for env_got, env_want in zip(got.environments, want.environments):
        assert dataclasses.asdict(
            env_got.apply(got.sim_params())
        ) == dataclasses.asdict(env_want.apply(want.sim_params()))
    # the schedules build a Simulator in both packages
    jc = jax_compile_graph(JaxGraph.from_yaml_file(topo))
    kw = lambda xs: [dataclasses.asdict(x) for x in xs]  # noqa: E731
    jax_sim, sim = scenario_pair(
        jc, chaos=kw(got.chaos), churn=kw(got.churn),
        mtls=dataclasses.asdict(got.mtls),
    )
    assert_churn_tables_equal(jax_sim, sim)


@pytest.mark.parametrize(
    "block",
    ['[sim]\nensemble_jitter = "qps=0.1"\n',
     '[sim]\nensemble_chaos_jitter = "time=0.2"\n',
     '[sim]\nensemble_split = "levels=4"\n',
     '[search]\ncandidates = 8\n'],
)
def test_load_toml_refuses_fleet_keys(tmp_path, block):
    """Every fleet key loads as the reference's: the jitter specs
    (ported with the fleets), ``ensemble_split`` and ``[search]``
    (ported with the splitting and search modules; the name is kept
    from when these keys raised)."""
    cfg = tmp_path / "exp.toml"
    cfg.write_text(block)
    got, want = port_runner.load_toml(cfg), jax_runner.load_toml(cfg)
    for f in ("ensemble", "ensemble_qps_jitter", "ensemble_cpu_jitter",
              "ensemble_error_jitter", "ensemble_jitter_seed",
              "ensemble_chaos_jitter", "ensemble_split",
              "search_candidates", "search_eta", "search_rungs"):
        assert getattr(got, f) == getattr(want, f), f
    if "split" in block:
        assert got.split_spec().to_dict() == want.split_spec().to_dict()
    if "search" in block:
        assert got.search_spec().to_dict() == want.search_spec().to_dict()


def test_load_toml_fleet_specs_match_reference(tmp_path):
    """``ensemble_spec()`` and ``chaos_jitter_spec()`` of a fleet sweep
    build the reference's specs (same seeds and scale tables)."""
    cfg = tmp_path / "exp.toml"
    cfg.write_text(
        '[sim]\nensemble = 5\n'
        'ensemble_jitter = "qps=0.1,cpu=0.05,error=0.2,seed=4"\n'
        'ensemble_slo = "250ms"\n'
        'ensemble_chaos_jitter = "time=0.2,mag=0.5,seed=7"\n'
        '[[chaos]]\nservice = "b"\nstart = "1s"\nend = "2s"\n'
    )
    got, want = port_runner.load_toml(cfg), jax_runner.load_toml(cfg)
    assert got.ensemble_slo_s == want.ensemble_slo_s == 0.25
    assert got.ensemble_spec().to_dict() == want.ensemble_spec().to_dict()
    assert got.chaos_jitter_spec().to_dict() == \
        want.chaos_jitter_spec().to_dict()
    cfg.write_text('[sim]\nensemble_chaos_jitter = "tim=1"\n')
    with pytest.raises(ValueError) as w:
        jax_runner.load_toml(cfg)
    with pytest.raises(ValueError) as g:
        port_runner.load_toml(cfg)
    assert str(g.value) == str(w.value)
