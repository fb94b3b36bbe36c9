"""Each cell, briefly, on the card: the run the benchmark makes, with a
short window.  Skips where there is no CUDA device; run on the card with
``python -m pytest -m cuda portbench/tests/test_portbench_card.py``."""
import time

import pytest
import torch

from portbench.harness import bench, cells

CELLS = [w["name"] for w in cells.load_bench()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = bench.run_cell(cell, 2**31 + 101, 1.0, True, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    roof = res["metrics"].get("census_roofline")
    assert roof is None or 0 < roof["value"] <= 100
    assert res["device"]["busy_s"] > 0
