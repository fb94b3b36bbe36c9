"""Device time launched while the program's span ``engine.draws`` was
open, at any depth, over all device time of the profiled experiments
(``harness/spans.py``), in %: each block's random streams, made by the
benchmark's source, moved and checked (``Simulator._draws``): work
that no change to the program removes."""
from portbench.harness import spans


def read(ctx):
    tr = spans.of(ctx)
    return None if tr is None else tr.launched_share("engine.draws")
