"""A plain reading of an isotope topology document, unrolled into a hop tree.

This is the benchmark's own reading of the topology format
(``services`` with ``script`` commands: ``call``, ``sleep`` and lists of
concurrent commands), written from the format's definition and not from
the program under test.  It accepts the subset the benchmark's
configurations use and raises on anything else, so a configuration that
needs more cannot be judged by a reference that silently ignores it.

The unrolled tree lists every service invocation of one request (a hop)
breadth-first: the root, then each hop's calls in script order, one hop
per retry attempt.  Hop ``h``'s columns of the random streams belong to
it, so the order is part of the contract with the draw streams.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Tuple

import numpy as np

_DURATION = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_UNIT_S = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0,
           "m": 60.0, "h": 3600.0}
_SERVICE_KEYS = {"name", "isEntrypoint", "script", "numReplicas",
                 "errorRate", "responseSize"}
_DEFAULT_KEYS = {"requestSize", "responseSize", "numReplicas", "errorRate"}
_CALL_KEYS = {"service", "size", "timeout", "retries"}


def duration_s(text: str) -> float:
    """Seconds of a Go duration string such as ``30s`` or ``1m30s``."""
    if not isinstance(text, str) or not text:
        raise ValueError(f"not a duration: {text!r}")
    pos, total = 0, 0.0
    for m in _DURATION.finditer(text):
        if m.start() != pos:
            raise ValueError(f"not a duration: {text!r}")
        total += float(m.group(1)) * _UNIT_S[m.group(2)]
        pos = m.end()
    if pos != len(text):
        raise ValueError(f"not a duration: {text!r}")
    return total


def rate(value) -> float:
    """A probability given as ``"x%"`` or a number in [0, 1]."""
    if isinstance(value, str):
        if not value.endswith("%"):
            raise ValueError(f"not a percentage: {value!r}")
        value = float(value[:-1]) / 100.0
    value = float(value)
    if not 0.0 <= value <= 1.0:
        raise ValueError(f"rate out of [0, 1]: {value}")
    return value


@dataclasses.dataclass(frozen=True)
class Call:
    target: int
    size: float          # request bytes
    send_prob: float     # 1.0: always sent (no ``probability`` key)
    timeout: float       # seconds, inf when none
    attempts: int        # retries + 1


@dataclasses.dataclass(frozen=True)
class Step:
    sleep: float                 # seconds; a concurrent group's longest sleep
    calls: Tuple[Call, ...]


@dataclasses.dataclass(frozen=True)
class Topology:
    names: Tuple[str, ...]
    entry: int
    replicas: np.ndarray        # (S,) int
    error_rate: np.ndarray      # (S,) float
    response_size: np.ndarray   # (S,) float bytes
    scripts: Tuple[Tuple[Step, ...], ...]


def _call(value, names: Dict[str, int], request_size: float) -> Call:
    if isinstance(value, str):
        value = {"service": value}
    if not isinstance(value, dict) or set(value) - _CALL_KEYS:
        raise ValueError(f"unsupported call: {value!r}")
    return Call(
        target=names[value["service"]],
        size=float(int(value.get("size", request_size))),
        send_prob=1.0,
        timeout=(duration_s(value["timeout"]) if "timeout" in value
                 else math.inf),
        attempts=int(value.get("retries", 0)) + 1,
    )


def _step(cmd, names, request_size) -> Step:
    group = cmd if isinstance(cmd, list) else [cmd]
    sleeps, calls = [], []
    for c in group:
        if not isinstance(c, dict) or len(c) != 1:
            raise ValueError(f"unsupported command: {c!r}")
        (key, value), = c.items()
        if key == "sleep":
            sleeps.append(duration_s(value))
        elif key == "call":
            calls.append(_call(value, names, request_size))
        else:
            raise ValueError(f"unsupported command: {c!r}")
    return Step(sleep=max(sleeps, default=0.0), calls=tuple(calls))


def parse(doc: dict) -> Topology:
    """The topology of an isotope document (``defaults`` + ``services``)."""
    defaults = doc.get("defaults", {})
    if set(defaults) - _DEFAULT_KEYS or set(doc) - {"defaults", "services"}:
        raise ValueError("unsupported topology keys")
    services = doc["services"]
    names = {s["name"]: i for i, s in enumerate(services)}
    request_size = float(defaults.get("requestSize", 0))
    scripts, replicas, errors, sizes, entries = [], [], [], [], []
    for s in services:
        if set(s) - _SERVICE_KEYS:
            raise ValueError(f"unsupported service keys in {s['name']}")
        scripts.append(tuple(
            _step(c, names, request_size) for c in s.get("script", [])
        ))
        replicas.append(max(1, int(s.get("numReplicas",
                                         defaults.get("numReplicas", 1)))))
        errors.append(rate(s.get("errorRate", defaults.get("errorRate", 0))))
        sizes.append(float(int(s.get("responseSize",
                                     defaults.get("responseSize", 0)))))
        if s.get("isEntrypoint"):
            entries.append(names[s["name"]])
    if not entries:
        raise ValueError("topology has no entrypoint")
    return Topology(
        names=tuple(names), entry=entries[0],
        replicas=np.asarray(replicas, np.int64),
        error_rate=np.asarray(errors, np.float64),
        response_size=np.asarray(sizes, np.float64),
        scripts=tuple(scripts),
    )


@dataclasses.dataclass
class Tree:
    """The hop tree of one request, breadth first."""

    service: np.ndarray      # (H,) service of each hop
    parent: np.ndarray       # (H,) parent hop, -1 for the root
    step: np.ndarray         # (H,) step index in the parent's script
    attempt: np.ndarray      # (H,) retry attempt of its call
    depth: np.ndarray        # (H,)
    send_prob: np.ndarray    # (H,)
    request_size: np.ndarray  # (H,) bytes sent to the hop
    # per call id: (parent hop, step, timeout, child hops by attempt)
    calls: List[Tuple[int, int, float, Tuple[int, ...]]]
    # per hop: its script's steps (sleep, call ids)
    steps: List[List[Tuple[float, Tuple[int, ...]]]]

    @property
    def num_hops(self) -> int:
        return len(self.service)


def unroll(topo: Topology, max_hops: int = 2_000_000) -> Tree:
    """Breadth-first unroll from the entrypoint."""
    cols = {k: [] for k in ("service", "parent", "step", "attempt",
                            "depth", "send_prob", "request_size")}

    def add(**kw):
        for k, v in kw.items():
            cols[k].append(v)
        if len(cols["service"]) > max_hops:
            raise ValueError("unrolled tree exceeds max_hops")
        return len(cols["service"]) - 1

    add(service=topo.entry, parent=-1, step=-1, attempt=0, depth=0,
        send_prob=1.0, request_size=0.0)
    calls: List[Tuple[int, int, float, Tuple[int, ...]]] = []
    steps: List[List[Tuple[float, Tuple[int, ...]]]] = []
    h = 0
    while h < len(cols["service"]):
        hop_steps = []
        for s_idx, st in enumerate(topo.scripts[cols["service"][h]]):
            ids = []
            for c in st.calls:
                kids = tuple(
                    add(service=c.target, parent=h, step=s_idx, attempt=a,
                        depth=cols["depth"][h] + 1,
                        send_prob=c.send_prob, request_size=c.size)
                    for a in range(c.attempts)
                )
                ids.append(len(calls))
                calls.append((h, s_idx, c.timeout, kids))
            hop_steps.append((st.sleep, tuple(ids)))
        steps.append(hop_steps)
        h += 1
    arr = {k: np.asarray(v) for k, v in cols.items()}
    return Tree(calls=calls, steps=steps, **arr)
