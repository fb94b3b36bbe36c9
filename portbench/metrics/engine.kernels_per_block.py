"""Kernels the profiler recorded over the profiled experiments, per
block (a fleet's fold counts as one block)."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    blocks = ctx.profiled_experiments * ctx.blocks()
    n = ctx.trace.count()
    return n / blocks if n else None
