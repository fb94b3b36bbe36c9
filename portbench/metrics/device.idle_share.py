"""1 minus the union of device activity over the profiled window, in %:
the share of the traced wall in which nothing ran on the card."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    w = ctx.trace.window_s
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / w)
