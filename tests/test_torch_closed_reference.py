"""The port's ``-qps max`` closed loop against the benchmark's plain
reference (``portbench/reference/closed.py``: the finite-population law
from its definition, in float64, importing nothing of the port), through
the benchmark's closed-loop entry on the CPU.

The twin is the cell's configuration with the multitier graph cut to 40
services, at 64 connections (the convolution path) and at 400 (the
log-space solve), two blocks of about 2,000 requests on seeded streams.
Each limit and its reason:

- ``requests``, ``errors`` 0: the reference runs the program's rows, and
  no hop can fail in this configuration;
- ``hop_events_gap`` 1e-5: every hop runs; the program sums its count in
  float32;
- ``util_gap`` 1e-5: both solve the same throughput, the program's
  utilization is float32;
- ``mean_gap`` 1e-5: the program draws in float32 and fits each wait
  quantile with a degree-10 polynomial, the reference reads the exact
  law from a fine table in float64 (measured: 1.2e-7);
- ``hist_moved`` 0.002: eight of 4,000 requests in another latency
  bucket, those within float32 rounding of an edge (measured: two);
- ``p50_gap``, ``p99_gap`` 0.02: two buckets.
"""
import time

import numpy as np
import pytest
import torch

from portbench.harness import bench, cells
from portbench.reference.closed import ClosedModel
from portbench.tests import closed_twin

LIMITS = {"requests": 0, "errors": 0, "hop_events_gap": 1e-5,
          "util_gap": 1e-5, "mean_gap": 1e-5, "hist_moved": 0.002,
          "p50_gap": 0.02, "p99_gap": 0.02}


@pytest.mark.parametrize("connections", [64, 400])
def test_the_closed_loop_agrees_with_the_plain_reference(tmp_path,
                                                         connections):
    base = closed_twin.base(tmp_path, connections=connections,
                            requests=4000)
    res = bench.run_cell(closed_twin.CELL, 2**35 + connections, 0.01, False,
                         time.perf_counter(), device="cpu",
                         bench=cells.load_bench(), base=base)
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert set(checks) == set(LIMITS)
    for name, limit in LIMITS.items():
        assert checks[name] <= limit, (name, checks)



def test_the_references_law_is_the_programs_at_the_cells_size():
    """The cell itself, 1,000 services at 10,000 connections: the
    reference's law (closed-form groups, direct log-space convolution,
    its own delay station from the configuration) against the program's
    tables (``Simulator._closed_tables``: the log-space solve one station
    at a time): the throughput, and each hop's zero-wait mass and copula
    centring, which the program keeps in float32."""
    cell = cells.load_cell(closed_twin.CELL, cells.load_bench())
    ctx = bench.Ctx(cell=cell, port=bench.program(),
                    device=torch.device("cpu"), seed=0)
    bench.build(ctx)
    C = cell.workload["connections"]
    lam = ctx.sim.solve_closed_rate(cell.entry.load(ctx), C,
                                    ctx.warm_source())
    _, p0, _, e, center, _ = ctx.sim._closed_tables(C)
    ref = ClosedModel(cell.config, C)
    np.testing.assert_allclose(lam, ref.throughput, rtol=1e-9)
    np.testing.assert_allclose(p0[0].numpy(), ref.p0_h.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(e[0].numpy(), ref.e.numpy(), rtol=1e-6)
    np.testing.assert_allclose(center[0], ref.center, rtol=1e-6)
