"""Cells, configurations, entries and metric readers, found by name.

Everything that belongs to one cell, configuration, entry kind or metric
is a file of its own under the benchmark's directory:

- ``workloads/<cell>.json``: the configuration, the traffic, how much
  of the window is warmed, profiled and judged, and the limits of its
  comparison;
- ``traffic/<traffic>.json``: what the simulated client asks: the entry
  that drives it and the parameters of one experiment, which that entry
  checks (``traffic(name, doc)``), so a mix of a new kind is a data file
  and the entry that reads it;
- ``configs/<config>.json``: the topology and model parameters as run;
- ``entries/<kind>.py``: how an experiment drives the program and the
  reference, and any numbers of its own that the comparison reads;
- ``metrics/<metric>.py``: a reader, ``read(ctx) -> float | None``.

``BENCHMARK.json`` names the metrics and which cells report them; this
module loads and checks all of it, so a later change adds a cell, a
configuration, an entry kind or a metric by adding files.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import List, Optional

from portbench.harness import check

BASE = pathlib.Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")

_WORKLOAD_KEYS = {
    "config": str, "traffic": str, "warmup_requests": int,
    "profile_experiments": int, "check_experiments": int, "limits": dict,
}
_CONFIG_KEYS = {"name", "source", "deployment", "assumed", "reduced",
                "params", "topology"}
_ENTRY_API = ("traffic", "load", "warm", "run", "prefixes", "blocks",
              "reference")


class CellError(ValueError):
    """A cell, configuration, entry or metric that does not load."""


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise CellError(f"bad {kind} name {name!r}")
    return name


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise CellError(f"no such file: {path}")
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, tag: str) -> ModuleType:
    if not path.is_file():
        raise CellError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + tag + "_" + re.sub(r"\W", "_", path.stem), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    source: str
    read: object          # read(ctx) -> Optional[float]


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    entry: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _typed(what: str, d: dict, keys: dict, required) -> dict:
    for key, value in d.items():
        if key not in keys:
            raise CellError(f"{what}: unknown key {key!r}")
        if not isinstance(value, keys[key]) or isinstance(value, bool):
            raise CellError(f"{what}: {key} has the wrong type")
    for key in required:
        if key not in d:
            raise CellError(f"{what}: missing {key!r}")
    return d


def load_traffic(name: str, base: pathlib.Path = BASE):
    """``(mix, entry module)``: the mix file as its entry checked it."""
    t = _json(base / "traffic" / f"{_name('traffic', name)}.json")
    if not isinstance(t.get("entry"), str):
        raise CellError(f"traffic {name}: no entry named")
    entry = load_entry(t["entry"], base)
    try:
        return entry.traffic(name, t), entry
    except ValueError as e:
        raise CellError(str(e)) from None


def load_workload(name: str, base: pathlib.Path = BASE):
    """``(workload, entry module)``: the cell's file with its traffic's
    keys merged in."""
    w = _typed(name, _json(base / "workloads"
                           / f"{_name('cell', name)}.json"),
               _WORKLOAD_KEYS, ("config", "traffic", "limits"))
    t, entry = load_traffic(w["traffic"], base)
    known = check.names(entry)
    for key, limit in w["limits"].items():
        if key not in known or not isinstance(limit, (int, float)) \
                or isinstance(limit, bool):
            raise CellError(f"{name}: bad limit {key!r}")
    return {**w, **t}, entry


def load_config(name: str, base: pathlib.Path = BASE) -> dict:
    c = _json(base / "configs" / f"{_name('config', name)}.json")
    if set(c) != _CONFIG_KEYS or c["name"] != name:
        raise CellError(f"config {name}: keys must be {sorted(_CONFIG_KEYS)}")
    return c


def load_entry(kind: str, base: pathlib.Path = BASE) -> ModuleType:
    mod = _module(base / "entries" / f"{_name('entry', kind)}.py", "entry")
    missing = [f for f in _ENTRY_API if not callable(getattr(mod, f, None))]
    if missing:
        raise CellError(f"entry {kind}: missing {missing}")
    return mod


def load_metric(spec: dict, base: pathlib.Path = BASE) -> Metric:
    name = _name("metric", spec["name"])
    mod = _module(base / "metrics" / f"{name}.py", "metric")
    if not callable(getattr(mod, "read", None)):
        raise CellError(f"metric {name}: no read(ctx)")
    return Metric(name, spec["unit"], spec["source"], mod.read)


def _reports(spec: dict, cell: str) -> bool:
    return "workloads" not in spec or cell in spec["workloads"]


def load_cell(name: str, bench: dict, base: pathlib.Path = BASE) -> Cell:
    """The cell ``name`` of ``bench`` (a parsed ``BENCHMARK.json``)."""
    listed = {w["name"]: w for w in bench["workloads"]}
    if name not in listed:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    workload, entry = load_workload(name, base)
    for key in ("config", "traffic"):
        if workload[key] != listed[name][key]:
            raise CellError(f"{name}: its file and BENCHMARK.json name "
                            f"different {key}s")
    return Cell(
        name=name,
        workload=workload,
        config=load_config(workload["config"], base),
        entry=entry,
        end_to_end=[load_metric(m, base) for m in bench["end_to_end"]
                    if _reports(m, name)],
        per_layer=[load_metric(m, base) for m in bench["per_layer"]
                   if _reports(m, name)],
    )


def load_bench(path: Optional[pathlib.Path] = None) -> dict:
    return _json(path or BASE.parent / "BENCHMARK.json")

