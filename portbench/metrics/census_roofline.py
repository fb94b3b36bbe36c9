"""The census join's least time over the census kernels' device time,
in %: bytes and operations reckoned from the topology and the rows of
the profiled experiments (``harness/roofline.py``), each input read
once and each output written once, against the card's peaks."""


def read(ctx):
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    t = ctx.trace.device_s("census")
    if t <= 0:
        return None
    w = ctx.workload
    blocks = ctx.profiled_experiments * ctx.blocks()
    rows = blocks * min(w["block"], w["requests"]) * w.get("members", 1)
    least = ctx.census_work.least_seconds(rows, blocks, ctx.device_name)
    return None if least is None else 100.0 * least / t
