"""The card's idle time while the host ran the program's own code in
the block loop (a span ``engine.block``, ``summary.block`` or
``attribution.block`` open, ``engine.draws`` not), over the profiled
window (``harness/spans.py``), in %.  The rest of ``device.idle_share``
falls between blocks and experiments, or in the benchmark's streams."""
from portbench.harness import spans

LOOP = ("engine.block", "summary.block", "attribution.block")


def read(ctx):
    tr = spans.of(ctx)
    if tr is None or tr.window_s <= 0:
        return None
    if not any(tr.span_count(n) for n in LOOP):
        return None
    return 100.0 * tr.idle_in(LOOP, outside=("engine.draws",)) / tr.window_s
