"""Cells, configurations, entries and metrics load by name, and a new
one is a set of new files."""
import json
import re

import pytest

from portbench.harness import cells, check
from portbench.tests import tiny

REPO = cells.BASE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = cells.load_cell(name, BENCH)
    assert cell.config["name"] == cell.workload["config"]
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.workload["limits"]) <= set(check.names(cell.entry))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
    assert len(names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert (REPO / c["file"]).is_file()


def test_a_new_cell_config_traffic_and_metric_are_new_files(tmp_path):
    base = tiny.base(tmp_path)
    # a new configuration: a three-service chain
    (base / "configs" / "chain3.json").write_text(json.dumps({
        "name": "chain3", "source": "test", "deployment": "a chain",
        "assumed": {}, "reduced": [],
        "params": json.loads((base / "configs" / "tree121.json")
                             .read_text())["params"],
        "topology": {"services": [
            {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
            {"name": "b", "script": [{"call": "c"}]}, {"name": "c"}]},
    }))
    (base / "traffic" / "tiny-open.json").write_text(json.dumps({
        "entry": "run_summary", "kind": "open", "qps": 100,
        "requests": 512, "block": 256}))
    (base / "workloads" / "chain3.tiny.json").write_text(json.dumps({
        "config": "chain3", "traffic": "tiny-open",
        "limits": {"requests": 0}}))
    (base / "metrics" / "chain.dummy.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "chain3.tiny", "config": "chain3",
                               "traffic": "tiny-open", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "chain.dummy", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "host planning", "moves": "setup_s",
                               "workloads": ["chain3.tiny"]})
    cell = cells.load_cell("chain3.tiny", bench, base)
    assert cell.workload["qps"] == 100 and cell.workload["block"] == 256
    assert [m.name for m in cell.per_layer][-1] == "chain.dummy"
    assert cell.per_layer[-1].read(None) == 7.0
    # the metric stays out of the cells it does not list
    assert "chain.dummy" not in [
        m.name for m in cells.load_cell("tree121.open", bench,
                                        base).per_layer]
    for row in bench["workloads"]:
        assert cells.load_cell(row["name"], bench, base).name == row["name"]


CLOSED_ENTRY = '''
"""A dummy entry of a closed-loop mix: its own keys, its own number."""
CHECKS = ("queue_gap",)


def traffic(name, t):
    if set(t) != {"entry", "kind", "qps", "connections", "requests"}:
        raise ValueError(f"traffic {name}: bad keys")
    return t


def load(ctx):
    return ("closed", ctx.workload["connections"])


def warm(ctx): pass
def run(ctx, source): return []
def prefixes(ctx): return [()]
def blocks(ctx): return 1
def reference(ctx, model, seed, path, judged=None): return None
def gaps(prog, ref): return {"queue_gap": 0.0}
'''


def test_a_new_traffic_kind_is_a_mix_file_and_an_entry_file(tmp_path):
    base = tiny.base(tmp_path)
    (base / "entries" / "closed_dummy.py").write_text(CLOSED_ENTRY)
    (base / "traffic" / "fortio-closed64.json").write_text(json.dumps({
        "entry": "closed_dummy", "kind": "closed", "qps": 1000,
        "connections": 64, "requests": 240000}))
    (base / "workloads" / "tree121.closed64.json").write_text(json.dumps({
        "config": "tree121", "traffic": "fortio-closed64",
        "limits": {"requests": 0, "queue_gap": 0.01}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tree121.closed64",
                               "config": "tree121",
                               "traffic": "fortio-closed64", "chips": 1,
                               "why": "test"})
    cell = cells.load_cell("tree121.closed64", bench, base)
    assert cell.workload["connections"] == 64
    assert "queue_gap" in check.names(cell.entry)
    assert check.entry_gaps(cell.entry, *[tiny.RUN] * 2)["queue_gap"] == 0
    # the entry refuses a mix it cannot run
    (base / "traffic" / "fortio-closed64.json").write_text(json.dumps({
        "entry": "closed_dummy", "kind": "closed", "qps": 1000}))
    with pytest.raises(cells.CellError, match="bad keys"):
        cells.load_cell("tree121.closed64", bench, base)


@pytest.mark.parametrize("edit,match", [
    ({"limits": {"nonsense": 1}}, "bad limit"),
    ({"extra": 1}, "unknown key"),
    ({"traffic": "no-such-mix"}, "no such file"),
    ({"limits": {"crit_moved": 1}}, "bad limit"),
    ({"config": "bad name!"}, "bad config name"),
])
def test_a_broken_cell_is_refused(tmp_path, edit, match):
    base = tiny.base(tmp_path)
    path = base / "workloads" / "tree121.open.json"
    w = json.loads(path.read_text())
    w.update(edit)
    path.write_text(json.dumps(w))
    bench = json.loads(json.dumps(BENCH))
    for row in bench["workloads"]:
        if row["name"] == "tree121.open":
            row.update({k: v for k, v in edit.items()
                        if k in ("config", "traffic")})
    with pytest.raises(cells.CellError, match=match):
        cells.load_cell("tree121.open", bench, base)


def test_an_entry_missing_its_functions_is_refused(tmp_path):
    base = tiny.base(tmp_path)
    (base / "entries" / "run_summary.py").write_text("def warm(ctx): pass\n")
    with pytest.raises(cells.CellError, match="missing"):
        cells.load_cell("tree121.open", BENCH, base)
