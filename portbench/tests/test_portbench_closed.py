"""The closed-loop cell: its configuration, traffic and metrics load,
the mix refuses what the program's loop cannot run, the reference's wait
table is fine enough, and a twin of the cell at test size catches each
planted fault."""
import json
import time

import pytest
import torch

from isotope_tpu_torch.models.generators import realistic_topology
from portbench import faults
from portbench.harness import bench, cells, closedloop
from portbench.reference import closed as ref_closed
from portbench.tests import closed_twin

BENCH = cells.load_bench()
CELL = closed_twin.CELL


def test_the_cell_its_configuration_traffic_and_metrics_load():
    cell = cells.load_cell(CELL, BENCH)
    assert cell.entry.__name__.endswith("run_closed")
    w = cell.workload
    assert (w["kind"], w["qps"], w["connections"]) == ("closed", "max",
                                                       10_000)
    assert w["block"] == 30_000 and w["requests"] == 85 * 30_000
    per_layer = [m.name for m in cell.per_layer]
    assert {"closed.tables_s", "engine.sat_wait_device_share"} <= set(
        per_layer)
    unlisted = [m["name"] for m in BENCH["per_layer"]
                if "workloads" not in m]
    assert set(unlisted) <= set(per_layer)
    for other in ("tree121.open", "star10k.open"):
        names = [m.name for m in cells.load_cell(other, BENCH).per_layer]
        assert "closed.tables_s" not in names
        assert "engine.sat_wait_device_share" not in names
    # the generator's own multitier graph, star10k's model parameters
    c = cell.config
    assert c["topology"] == realistic_topology(1000, archetype="multitier",
                                               seed=0)
    assert c["params"] == cells.load_config("star10k")["params"]
    assert c["reduced"] == []


MIX = {"entry": "run_closed", "kind": "closed", "qps": "max",
       "connections": 64, "requests": 512, "block": 128}


@pytest.mark.parametrize("edit,match", [
    ({"kind": "open"}, "kind must be"),
    ({"qps": 1000}, "wrong type"),
    ({"qps": "1000"}, "qps 'max'"),
    ({"block": 100}, "multiple"),
    ({"requests": 500}, "multiple"),
    ({"connections": 0}, "positive"),
    ({"members": 4}, "unknown key"),
])
def test_the_mix_refuses_what_the_loop_cannot_run(edit, match):
    assert closedloop.traffic("t", dict(MIX)) == MIX
    with pytest.raises(ValueError, match=match):
        closedloop.traffic("t", {**MIX, **edit})


def test_the_references_wait_table_is_fine_enough():
    """The table read halfway between its points against exact
    quantiles there.  A nearly geometric census, as the cell's: under
    1e-6 of the wait everywhere.  A census with no mass below 40 stages
    rises from 0 as ``v^(1/40)``: there the error passes 1e-6 only where
    ``u' < 0.005``, and weighted by the draws that read it stays under
    1e-6 of the wait."""
    mu = 13_000.0
    m = torch.arange(1, 121, dtype=torch.float64)
    g = ref_closed.grid("cpu")
    # every interval near 0, one in 25 beyond, each weighed by the
    # intervals it stands for
    at = torch.cat([torch.arange(400), torch.arange(400, len(g) - 1, 25)])
    mid = 0.5 * (g[at] + g[at + 1])
    width = (g[at + 1] - g[at]) * torch.where(at < 400, 1.0, 25.0)
    for w, everywhere in ((0.7 ** m, True),
                          (torch.exp(-0.5 * ((m - 60) / 5) ** 2), False)):
        w = w / w.sum()
        table = ref_closed.quantile_table(w, mu)
        exact = ref_closed.quantile_table(w, mu, mid)
        got = ref_closed.read_table(table, torch.zeros_like(mid).long(), mid)
        err = (got - exact).abs() / exact
        if everywhere:
            assert float(err.max()) < 1e-6
        else:
            assert float(err[mid > 0.005].max()) < 1e-6
            # u' = 1 - e^-v: each point stands for its share of the draws
            share = torch.exp(-mid) * width
            assert float((err * share).sum() / share.sum()) < 1e-6


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_twin_of_the_cell_catches_each_planted_fault(tmp_path, fault):
    base = closed_twin.base(tmp_path, connections=400, requests=4000)
    with faults.FAULTS[fault]():
        res = bench.run_cell(CELL, 2**34 + 1, 0.01, False,
                             time.perf_counter(), device="cpu", bench=BENCH,
                             base=base)
    assert not res["correct"], res["checks"]


def test_the_twin_is_correct_and_reports_the_new_metrics(tmp_path):
    base = closed_twin.base(tmp_path, connections=400, requests=4000)
    res = bench.run_cell(CELL, 2**34 + 1, 0.01, True, time.perf_counter(),
                         device="cpu", bench=BENCH, base=base)
    assert res["correct"], res["checks"]
    assert res["metrics"]["closed.tables_s"]["value"] > 0
    # device readings come from a card only
    assert "engine.sat_wait_device_share" not in res["metrics"]
    json.dumps(res)
