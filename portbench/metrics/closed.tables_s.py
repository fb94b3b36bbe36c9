"""Host seconds of the finite-population tables' build in set-up: the
program's ``closed.tables`` phase timer (host clock, the build is numpy
on the host) over the entry's ``solve_closed_rate`` call
(``entries/run_closed.py``).  Nothing where the program has no such
phase."""


def read(ctx):
    t = getattr(ctx, "closed_tables_s", 0.0)
    return t if t > 0 else None
