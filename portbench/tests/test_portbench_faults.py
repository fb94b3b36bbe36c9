"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place), and a run whose timed path is broken
underneath (a block that hands back a state it did not advance, half of
a block left out of its summary, answers altered where they are made,
and where a run estimates a tail cut, the cut at the wrong quantile).
Each drives the rest of a run on the CPU at test size."""
import time

import pytest

from portbench import calibrate, faults
from portbench.harness import bench, cells, check
from portbench.tests import tiny

BENCH = cells.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    out = calibrate.readings(cell, [11, 12], [11, 12, 13], device="cpu",
                             bench_doc=BENCH,
                             base=tiny.base(tmp_path, cell))
    limits = cells.load_cell(cell, BENCH).workload["limits"]
    for reading in out["sound"].values():
        assert check.judge(reading, limits)[0], reading
    for reading in out["control"].values():
        assert not check.judge(reading, limits)[0], reading


def _faults(cell):
    if cell == tiny.FLEET:
        return sorted(faults.FAULTS)
    return sorted(faults.planted(cells.load_cell(cell, BENCH).workload))


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS + [tiny.FLEET] for f in _faults(c)])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    base = tiny.base(tmp_path, cell)
    bench_doc = tiny.fleet(base, BENCH) if cell == tiny.FLEET else BENCH
    with {**faults.FAULTS, **faults.TAIL_FAULTS}[fault]():
        res = bench.run_cell(cell, 2**32 + 3, 0.01, False,
                             time.perf_counter(), device="cpu",
                             bench=bench_doc, base=base)
    assert not res["correct"], res["checks"]
