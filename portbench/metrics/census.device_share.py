"""Device time of the census kernels (names holding ``census``) over
all device time of the profiled experiments, in %."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    total = ctx.trace.device_s()
    census = ctx.trace.device_s("census")
    if total <= 0 or census <= 0:
        return None
    return 100.0 * census / total
