"""Device time launched while the program's span ``summary.block`` was
open, at any depth, over all device time of the profiled experiments
(``harness/spans.py``), in %: each block's reduction to a run summary
(``summarize``)."""
from portbench.harness import spans


def read(ctx):
    tr = spans.of(ctx)
    return None if tr is None else tr.launched_share("summary.block")
