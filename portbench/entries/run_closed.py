"""One experiment is one ``Simulator.run_summary`` under Fortio's
``-qps max`` closed loop (``harness/closedloop.py``): the cell's
requests in blocks of the cell's size, every hop's wait drawn from the
finite-population law at the cell's connections, reduced to one summary
on the device and read back.  Set-up builds the law's tables
(``solve_closed_rate``), which the program keeps for every later run of
the same connections."""
from __future__ import annotations

from portbench.harness import closedloop
from portbench.harness.closedloop import load, traffic  # noqa: F401

#: the program's phase timer around the tables' build
TABLES_PHASE = "closed.tables"


def warm(ctx) -> None:
    """The finite-population tables, then the cell's block shape, a few
    blocks of it.  Sets ``ctx.closed_tables_s``: the host seconds the
    program's ``closed.tables`` phase took in the build (0 where the
    program has no such phase)."""
    from isotope_tpu_torch import telemetry

    w = ctx.workload
    before = telemetry.phase_seconds(TABLES_PHASE)
    ctx.sim.solve_closed_rate(ctx.load(), w["requests"], ctx.warm_source())
    ctx.closed_tables_s = telemetry.phase_seconds(TABLES_PHASE) - before
    ctx.host_runs(ctx.sim.run_summary(
        ctx.load(), w.get("warmup_requests", 2 * w["block"]),
        ctx.warm_source(), block_size=w["block"],
    ))


def run(ctx, source):
    w = ctx.workload
    return ctx.host_runs(ctx.sim.run_summary(
        ctx.load(), w["requests"], source, block_size=w["block"],
    ))


def prefixes(ctx):
    """The index prefix of each run's block loop: the solo run's own."""
    return [()]


def blocks(ctx) -> int:
    w = ctx.workload
    return w["requests"] // w["block"]


def reference(ctx, model, seed, path, judged=None):
    return closedloop.reference(ctx, model, seed, path)
