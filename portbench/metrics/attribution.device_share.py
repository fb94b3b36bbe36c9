"""Device time launched while the program's span ``attribution.block``
was open, at any depth, over all device time of the profiled
experiments (``harness/spans.py``), in %: the attribution sweep of
each block (``attribute_block``, ``accumulate``)."""
from portbench.harness import spans


def read(ctx):
    tr = spans.of(ctx)
    return None if tr is None else tr.launched_share("attribution.block")
