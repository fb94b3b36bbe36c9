"""One experiment is one ``Simulator.run_summary``: a simulated Fortio
run of the cell's requests, in blocks of the cell's size, reduced to
one summary on the device and read back."""
from __future__ import annotations

from portbench.harness import openloop
from portbench.harness.openloop import load, traffic  # noqa: F401


def warm(ctx) -> None:
    """The cell's block shape, a few blocks of it."""
    w = ctx.workload
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
    return -(-w["requests"] // w["block"])


def reference(ctx, model, seed, path, judged=None):
    return openloop.reference(ctx, model, seed, path)
