"""One experiment is one ``Simulator.run_ensemble``: a seeds-only fleet
of the cell's members (seeds 0 .. members - 1), each a simulated run of
the cell's requests, in the program's default mode (folded on CUDA)
with its automatic chunk.  Member ``m`` draws under the index prefix
``(m,)``."""
from __future__ import annotations

from portbench.harness import openloop
from portbench.harness.openloop import load  # noqa: F401


def traffic(name, t):
    t = openloop.traffic(name, t, {"members": (int,)})
    if t["members"] < 1:
        raise ValueError(f"traffic {name}: members must be positive")
    return t


def _spec(ctx):
    return ctx.port.EnsembleSpec.of(ctx.workload["members"])


def warm(ctx) -> None:
    """One whole fleet: its shapes, and the pilots that size its chunk
    (the program keeps them for later fleets of the same kind)."""
    w = ctx.workload
    ens = ctx.sim.run_ensemble(ctx.load(), w["requests"],
                               ctx.warm_source(), _spec(ctx),
                               block_size=w["block"])
    ctx.host_runs(ens.summaries, w["members"])


def run(ctx, source):
    w = ctx.workload
    ens = ctx.sim.run_ensemble(ctx.load(), w["requests"], source,
                               _spec(ctx), block_size=w["block"])
    return ctx.host_runs(ens.summaries, w["members"])


def prefixes(ctx):
    return [(int(s),) for s in _spec(ctx).seeds]


def blocks(ctx) -> int:
    """Blocks of one member's loop; a fold of all members counts once."""
    w = ctx.workload
    return -(-w["requests"] // w["block"])


def reference(ctx, model, seed, path, judged=None):
    return openloop.reference(ctx, model, seed, path)
