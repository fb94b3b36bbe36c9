"""Device time launched while the program's span ``engine.sat_wait`` was
open, at any depth, over all device time of the profiled experiments
(``harness/spans.py``), in %: each block's waits under the
finite-population law (``Simulator._saturated_wait``: the population
copula, ``ndtr``, ``log1p`` and the quantile polynomial)."""
from portbench.harness import spans


def read(ctx):
    tr = spans.of(ctx)
    return None if tr is None else tr.launched_share("engine.sat_wait")
