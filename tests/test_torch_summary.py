"""The port's run summary, histogram, Fortio document and CLI against
the JAX package.

``run_summary`` runs three blocks through both engines on the same
draws (block ``b`` replays the JAX key ``fold_in(key, 1_000_000 + b)``).
Tolerances: ``count``, ``error_count`` and ``hop_events`` are exactly
equal; sum, min, max, m2 and the run end agree within rtol 1e-5 (the
per-request latencies carry the few-ULP XLA/torch differences of
tests/test_torch_engine.py, and the f32 block sums add in another
order); p50/p90/p99 agree within one histogram bucket (~0.6%), since a
latency within a few ULP of a bucket edge may land one bucket over.
"""
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.metrics import fortio as jax_fortio
from isotope_tpu.metrics import histogram as jax_histogram
from isotope_tpu.models.generators import tree_topology as jax_tree
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu.sim import summary as jax_summary
from isotope_tpu_torch import cli
from isotope_tpu_torch.metrics import fortio, histogram
from isotope_tpu_torch.sim import LoadModel, Simulator
from isotope_tpu_torch.sim import summary
from test_torch_replay import JaxReplayDraws, port_compiled

ROOT = pathlib.Path(__file__).resolve().parents[1]
CANONICAL = ROOT / "examples" / "topologies" / "canonical.yaml"

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

EXACT = ("count", "error_count", "hop_events", "win_count",
         "win_error_count")
CLOSE = ("latency_sum", "latency_m2", "latency_min", "latency_max",
         "end_max")


def _bucket(x):
    return np.searchsorted(histogram.EDGES, np.asarray(x), side="right") - 1


def _graph(name):
    if name == "flagship":
        return JaxGraph.decode(jax_tree(
            num_levels=5, num_branches=3, request_size=1024,
            response_size=1024,
        ))
    return JaxGraph.from_yaml(CENSUS_YAML)


@pytest.mark.parametrize("name,qps", [("flagship", 1000.0),
                                      ("census", 500.0)])
def test_run_summary_matches_reference(name, qps):
    jc = jax_compile_graph(_graph(name))
    jax_sim = JaxSimulator(jc)
    sim = Simulator(port_compiled(jc), device="cpu")
    key = jax.random.PRNGKey(7)
    want = jax_sim.run_summary(JaxLoad(kind="open", qps=qps), 3 * 1024,
                               key, block_size=1024, trim=True)
    got = sim.run_summary(LoadModel(kind="open", qps=qps), 3 * 1024,
                          JaxReplayDraws(key, jax_sim), block_size=1024,
                          trim=True)
    for field in EXACT:
        assert float(getattr(got, field)) == float(getattr(want, field)), (
            field
        )
    assert float(got.count) == 3 * 1024
    for field in CLOSE:
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=1e-5, err_msg=field,
        )
    qs = (0.5, 0.9, 0.99)
    assert np.all(np.abs(_bucket(got.quantiles_s(qs))
                         - _bucket(want.quantiles_s(qs))) <= 1)
    np.testing.assert_array_equal(
        got.unstable.numpy(), np.asarray(want.unstable)
    )
    np.testing.assert_allclose(
        got.utilization.numpy(), np.asarray(want.utilization), rtol=1e-5
    )


def test_histogram_matches_reference():
    rng = np.random.default_rng(2)
    lat = np.concatenate([
        rng.lognormal(-6.0, 1.5, 4000), [0.0, 1e-7, 50.0, np.nan],
    ]).astype(np.float32)
    want_idx = np.asarray(jax_histogram.bucket_index(jnp.asarray(lat)))
    got_idx = histogram.bucket_index(torch.from_numpy(lat)).numpy()
    # the float32 log may put a value within an ULP of an edge one
    # bucket over; everything else lands in the same bucket
    assert np.abs(got_idx - want_idx).max() <= 1
    assert (got_idx == want_idx).mean() > 0.999
    w = (rng.uniform(0, 1, lat.shape) > 0.5).astype(np.float32)
    got = histogram.latency_histogram(
        torch.from_numpy(lat), torch.from_numpy(w)
    ).numpy()
    assert got.sum() == w.sum()
    np.testing.assert_array_equal(
        got, np.bincount(got_idx, weights=w, minlength=2048)
    )
    qs = [0.5, 0.9, 0.99, 0.999]
    np.testing.assert_array_equal(
        histogram.quantile_from_histogram(torch.from_numpy(got), qs),
        jax_histogram.quantile_from_histogram(got, qs),
    )
    np.testing.assert_array_equal(
        histogram.bucket_centers(), jax_histogram.bucket_centers()
    )


def test_reduce_stacked_matches_reference():
    """Stacked per-block summaries reduce like the reference's."""
    rng = np.random.default_rng(4)
    blocks = []
    for b in range(3):
        lat = rng.lognormal(-6.0, 0.3, 500).astype(np.float32)
        start = np.sort(rng.uniform(0, 100, 500)).astype(np.float32)
        err = rng.uniform(0, 1, 500) < 0.05
        blocks.append((lat, start, err, 1000 + b))

    class Res:
        def __init__(self, lat, start, err, hops, xp):
            self.client_latency = xp(lat)
            self.client_start = xp(start)
            self.client_error = xp(err)
            self.client_end = self.client_start + self.client_latency
            self.hop_events = xp(np.int32(hops))
            self.utilization = xp(np.float32([0.5, 0.25]))
            self.unstable = xp(np.array([False, True]))

    got = summary.reduce_stacked(summary.stack([
        summary.summarize(
            Res(*blk, torch.as_tensor),
            window=(torch.tensor(20.0), torch.tensor(80.0)),
        )
        for blk in blocks
    ]))
    parts = [
        jax_summary.summarize(
            Res(*blk, jnp.asarray),
            window=(jnp.float32(20.0), jnp.float32(80.0)),
        )
        for blk in blocks
    ]
    want = jax_summary.reduce_stacked(
        jax.tree.map(lambda *x: jnp.stack(x), *parts)
    )
    for field in EXACT:
        assert float(getattr(got, field)) == float(getattr(want, field))
    for field in CLOSE:
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=1e-5, err_msg=field,
        )
    np.testing.assert_array_equal(
        got.win_latency_hist.numpy(), np.asarray(want.win_latency_hist)
    )


def test_trim_window_bounds_match_reference():
    for n, qps in [(1000, 10.0), (200_000, 1000.0), (10, 1e6)]:
        assert fortio.trim_window_bounds(n, qps) == (
            jax_fortio.trim_window_bounds(n, qps)
        )


def _jax_canonical_doc():
    graph = JaxGraph.from_yaml_file(CANONICAL)
    sim = JaxSimulator(jax_compile_graph(graph))
    load = JaxLoad(kind="open", qps=1000.0, duration_s=2.0)
    s = sim.run_summary(load, 2000, jax.random.PRNGKey(0), trim=True)
    return jax_fortio.fortio_result_from_summary(s, load, labels="x")


def _keys(doc):
    out = set()
    for k, v in doc.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk in _keys(v)}
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out |= {f"{k}[].{kk}" for kk in _keys(v[0])}
    return out


def test_cli_simulate_prints_the_reference_document():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "simulate", str(CANONICAL), "--qps", "1000", "--duration",
            "2s", "--load-kind", "open", "--device", "cpu",
        ])
    assert rc == 0
    doc = json.loads(buf.getvalue())
    assert _keys(doc) == _keys(_jax_canonical_doc())
    hist = doc["DurationHistogram"]
    assert hist["Count"] == 2000
    assert doc["RetCodes"] == {"200": 2000}
    assert doc["Labels"] == "canonical_none_1000qps_64c"
    assert 0.0 < hist["Percentiles"][0]["Value"] < hist["Max"]


def test_cli_defaults_match_reference():
    """The load flags and their defaults are the JAX command's."""
    from isotope_tpu.commands import simulate_cmd
    import argparse

    ref = argparse.ArgumentParser()
    simulate_cmd.register(ref.add_subparsers())
    want = vars(ref.parse_args(["simulate", "t.yaml"]))
    got = vars(cli.build_parser().parse_args(["simulate", "t.yaml"]))
    for flag in ("qps", "connections", "duration", "load_kind",
                 "max_requests", "service_time", "seed"):
        assert got[flag] == want[flag], flag
    assert got["device"] is None


def test_cli_refuses_qps_max():
    """``--qps max`` was refused before the saturated closed loop was
    ported; it now runs Fortio's saturated closed loop and prints its
    document (requests rounded up to whole blocks of 64 connections, as
    the reference's run_summary does)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["simulate", str(CANONICAL), "--qps", "max",
                       "--max-requests", "2000", "--device", "cpu"])
    assert rc == 0
    doc = json.loads(buf.getvalue())
    assert doc["RequestedQPS"] == "max"
    assert doc["Labels"] == "canonical_none_maxqps_64c"
    assert doc["DurationHistogram"]["Count"] == 2 * (2000 // 64 * 64)
    assert doc["ActualQPS"] > 1000.0


def test_cli_check_defaults_match_reference():
    """The check command's flags and defaults are the JAX command's,
    plus ``--device``."""
    from isotope_tpu.commands import simulate_cmd
    import argparse

    ref = argparse.ArgumentParser()
    simulate_cmd.register(ref.add_subparsers())
    want = vars(ref.parse_args(["check", "t.yaml"]))
    got = vars(cli.build_parser().parse_args(["check", "t.yaml"]))
    for args in (want, got):
        args.pop("func")
        args.pop("command", None)
    assert got.pop("device") is None
    assert got == want


def test_module_entry_point_runs(tmp_path):
    """``python -m isotope_tpu_torch`` reaches the same CLI."""
    import subprocess

    out = subprocess.run(
        [sys.executable, "-m", "isotope_tpu_torch", "simulate", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
