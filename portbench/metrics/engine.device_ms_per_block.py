"""Summed device time of every activity the profiler recorded over the
profiled experiments, in ms per block."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    t = ctx.trace.device_s()
    if t <= 0:
        return None
    return 1e3 * t / (ctx.profiled_experiments * ctx.blocks())
