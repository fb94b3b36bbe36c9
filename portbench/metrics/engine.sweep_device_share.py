"""Device time launched while the program's span ``engine.sweep`` was
open, at any depth, over all device time of the profiled experiments
(``harness/spans.py``), in %: the upward level sweep of each block
with its census joins (``_simulate_core``)."""
from portbench.harness import spans


def read(ctx):
    tr = spans.of(ctx)
    return None if tr is None else tr.launched_share("engine.sweep")
