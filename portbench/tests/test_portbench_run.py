"""Whole runs on the CPU at test size: the program against the plain
reference, the result line, and the refusal without a card."""
import json
import time

import pytest
import torch

from portbench.harness import bench, cells
from portbench.tests import tiny

BENCH = cells.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(tmp_path, cell, traced=False, seed=2**31 + 5):
    return bench.run_cell(cell, seed, 0.01, traced, time.perf_counter(),
                          device="cpu", bench=BENCH,
                          base=tiny.base(tmp_path, cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(tmp_path, cell):
    res = run(tmp_path, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def test_a_fleet_entry_agrees_with_the_reference(tmp_path):
    base = tiny.base(tmp_path)
    bench_doc = tiny.fleet(base, BENCH)
    res = bench.run_cell(tiny.FLEET, 2**31 + 7, 0.01, False,
                         time.perf_counter(), device="cpu", bench=bench_doc,
                         base=base)
    assert res["correct"], res["checks"]
    assert res["attempted"] % 4 == 0   # every member of every fleet


def test_the_last_line_carries_the_contract_keys(tmp_path):
    res = run(tmp_path, "tree121.open")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"hop_events_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_a_traced_line_adds_the_trace_keys(tmp_path):
    res = run(tmp_path, "tree121.open", traced=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    assert "plan.build_s" in res["metrics"]
    # device readings come from a card only
    assert "census_roofline" not in res["metrics"]


def test_without_a_card_the_run_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", "tree121.open", "--seed", "1",
                     "--seconds", "1"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_run_shorter_than_its_block_agrees_with_the_reference(tmp_path):
    # one block of all the requests, as the program's loop takes them
    base = tiny.base(tmp_path, "tree121.open")
    path = base / "traffic" / "fortio-open-10400qps-240s.json"
    t = json.loads(path.read_text())
    t.update(requests=3000, block=4096)
    path.write_text(json.dumps(t))
    res = bench.run_cell("tree121.open", 2**31 + 9, 0.01, False,
                         time.perf_counter(), device="cpu", bench=BENCH,
                         base=base)
    assert res["correct"], res["checks"]
