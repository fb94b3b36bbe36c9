"""The port's Prometheus series, queries and ``check`` against the JAX package's.

- ``MetricsCollector.collect`` on identical ``SimResults``: every count
  exactly (the port adds integers, the reference float32 ones, exact
  below 2^24), float sums within rtol 1e-5 (they add in another order).
- The two engines' own runs on the same replayed draws: their hop
  latencies agree within rtol 1e-5, so a hop that close to a duration
  bucket edge could land in the next bucket on one side.  The fixtures
  below have no sent hop within rtol 1e-5 of an edge (asserted), and
  there the histograms are compared exactly.
- The text exposition parsed back sample by sample, and the reference's
  query strings evaluated on it by the port's copy of ``query.py``.
- ``python -m isotope_tpu_torch check`` at ``--device cpu`` on
  ``canonical.yaml`` and ``canonical-errors.yaml``, its draws replayed
  from the JAX run's key: the same exit code and the same alarm and
  query lines as ``isotope-tpu check``, values within rtol 1e-5.
"""
import argparse
import pathlib
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.commands.simulate_cmd import run_check as jax_run_check
from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import query as jax_query
from isotope_tpu.metrics.alarms import requests_sanity as jax_sanity
from isotope_tpu.metrics.alarms import standard_queries as jax_standard
from isotope_tpu.metrics.prometheus import MetricsCollector as JaxCollector
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import summary as jax_summary
from isotope_tpu_torch import cli
from isotope_tpu_torch import sim as port_sim
from isotope_tpu_torch.metrics import query
from isotope_tpu_torch.metrics.alarms import (
    requests_sanity,
    standard_queries,
)
from isotope_tpu_torch.metrics.prometheus import (
    DURATION_BUCKETS,
    MetricsCollector,
)
from isotope_tpu_torch.sim import LoadModel, Simulator
from isotope_tpu_torch.sim import summary
from test_torch_replay import JaxReplayDraws, port_compiled

TOPOLOGIES = pathlib.Path(__file__).resolve().parents[1] / "examples" / (
    "topologies"
)
RTOL = 1e-5

# retries, timeouts that fire, error rates and a send probability
TIMEOUT_YAML = """
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

FIXTURES = {
    "canonical-errors": (TOPOLOGIES / "canonical-errors.yaml").read_text(),
    "timeouts": TIMEOUT_YAML,
}

SUM_FIELDS = ("outgoing_size_sum", "duration_sum", "response_size_sum")


def _runs(name, n=2048, qps=500.0, seed=1):
    """Both engines' runs of one fixture on the same draws, and their
    collectors."""
    jc = jax_compile_graph(JaxGraph.from_yaml(FIXTURES[name]))
    jax_sim = JaxSimulator(jc)
    pc = port_compiled(jc)
    key = jax.random.PRNGKey(seed)
    want = jax_sim.run(JaxLoad(kind="open", qps=qps), n, key)
    got = Simulator(pc, device="cpu").run(
        LoadModel(kind="open", qps=qps), n, JaxReplayDraws(key, jax_sim)
    )
    return want, got, JaxCollector(jc), MetricsCollector(pc)


def _assert_metrics(got, want):
    for name in got._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if name in SUM_FIELDS:
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_off_edges(res):
    """No sent hop lies within RTOL of a duration bucket edge."""
    lat = np.asarray(res.hop_latency, np.float64)[np.asarray(res.hop_sent)]
    edges = np.asarray(DURATION_BUCKETS, np.float32).astype(np.float64)
    near = np.abs(lat[:, None] - edges) <= RTOL * edges
    assert not near.any(), lat[near.any(1)]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_collect_matches_reference_on_identical_results(name):
    _, got, jax_col, col = _runs(name)
    same = SimpleNamespace(**{
        f: jnp.asarray(getattr(got, f).numpy())
        for f in ("hop_sent", "hop_error", "hop_latency")
    })
    m = col.collect(got)
    _assert_metrics(m, jax_col.collect(same))
    assert float(m.incoming_total.sum()) == float(got.hop_sent.sum())
    assert float(m.duration_hist.sum()) == float(got.hop_sent.sum())


@pytest.mark.parametrize("name", list(FIXTURES))
def test_collect_matches_reference_on_each_engines_run(name):
    want, got, jax_col, col = _runs(name)
    _assert_off_edges(want)
    _assert_metrics(col.collect(got), jax_col.collect(want))


def _texts(name):
    want, got, jax_col, col = _runs(name)
    _assert_off_edges(want)
    s_got = summary.summarize(got, col)
    s_want = jax_summary.summarize(want, jax_col)
    return (col.full_text(s_got), float(s_got.end_max),
            jax_col.full_text(s_want), float(s_want.end_max))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_full_text_parses_back_sample_by_sample(name):
    got_text, _, want_text, _ = _texts(name)
    got = query.parse_exposition(got_text)
    want = jax_query.parse_exposition(want_text)
    assert [(s.name, s.labels) for s in got] == [
        (s.name, s.labels) for s in want
    ]
    float_series = re.compile(
        r"_sum$|^service_cpu_usage_seconds_total$"
        r"|^service_memory_working_set_bytes$"
    )
    for g, w in zip(got, want):
        if float_series.search(g.name):
            np.testing.assert_allclose(g.value, w.value, rtol=RTOL,
                                       err_msg=g.name)
        else:  # counts: buckets, _count and the request counters
            assert g.value == w.value, (g.name, g.labels)


def _queries(label):
    return standard_queries(label) + [requests_sanity(label)] + [
        SimpleNamespace(query=q) for q in (
            "histogram_quantile(0.99, sum(rate("
            "service_request_duration_seconds_bucket[1m])) by (le))",
            "sum(rate(service_outgoing_requests_total[1m])) by "
            "(destination_service)",
            'max(service_request_duration_seconds_count{code!="200"})',
        )
    ]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_queries_match_reference(name):
    """The reference's alarm and analysis query strings give the same
    values through the port's copy of query.py as through the JAX
    package's, on the same exposition, and the copied alarm suite is
    the reference's."""
    got_text, duration, _, _ = _texts(name)
    store = query.MetricStore.from_text(got_text, duration)
    jax_store = jax_query.MetricStore.from_text(got_text, duration)
    assert [q.query for q in standard_queries(name)] == [
        q.query for q in jax_standard(name)
    ]
    assert requests_sanity(name).query == jax_sanity(name).query
    for q in _queries(name):
        assert store.query(q.query) == jax_store.query(q.query), q.query


def _check_lines(err: str):
    """(text, values) of the check's stderr lines, the numbers cut out."""
    number = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")
    lines = [line for line in err.splitlines() if line.strip()]
    return ([number.sub("#", line) for line in lines],
            [[float(x) for x in number.findall(line)] for line in lines])


@pytest.mark.parametrize("topology", ["canonical", "canonical-errors"])
def test_check_matches_reference(topology, capsys, monkeypatch):
    path = str(TOPOLOGIES / f"{topology}.yaml")
    argv = ["--max-requests", "20000", "--seed", "3", "--debug"]
    rc_want = jax_run_check(argparse.Namespace(
        topology=path, qps="1000", connections=64, duration="240s",
        load_kind="open", max_requests=20000, seed=3, cpu_limit=50.0,
        mem_limit=64.0, debug=True,
    ))
    want = capsys.readouterr().err
    # the port's check draws from the JAX run's key
    monkeypatch.setattr(
        port_sim, "TorchDraws",
        lambda seed, device: JaxReplayDraws(jax.random.PRNGKey(seed)),
    )
    rc_got = cli.main(["check", path, "--device", "cpu"] + argv)
    got = capsys.readouterr().err
    assert rc_got == rc_want
    assert ("There were 5xx errors" in got) == (topology == "canonical-errors")
    text_got, values_got = _check_lines(got)
    text_want, values_want = _check_lines(want)
    assert text_got == text_want
    assert any(line.startswith("ALARM:") for line in text_got) == (
        rc_got == 1
    )
    for a, b in zip(values_got, values_want):
        np.testing.assert_allclose(a, b, rtol=RTOL)


def test_summary_metrics_merge_over_blocks():
    """run_summary sums each block's series: the counts equal the
    reduced counters of the same run."""
    _, _, _, col = _runs("timeouts", n=8)
    sim = Simulator(col.compiled, device="cpu")
    s = sim.run_summary(LoadModel(kind="open", qps=500.0), 3 * 256,
                        port_sim.TorchDraws(0, "cpu"), block_size=256,
                        collector=col)
    m = s.metrics
    assert float(m.incoming_total.sum()) == float(s.hop_events)
    entry = int(col.compiled.hop_service[0])
    assert float(m.incoming_total[entry]) == float(s.count)
    assert float(m.duration_hist[entry, 1].sum()) == float(s.error_count)
    assert torch.equal(m.duration_hist.sum(-1), m.response_size_hist.sum(-1))
