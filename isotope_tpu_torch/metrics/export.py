"""Pluggable result exporters — the collector's upload hook.

The port of ``isotope_tpu.metrics.export`` (host code; summaries'
tensors are moved to the CPU where they are read).

The reference's collector optionally pushes results to BigQuery after
writing CSV: it dumps the raw per-run fortio JSON docs to an NDJSON
data file and shells out to ``bq insert <table> <datafile>``
(perf/benchmark/runner/fortio.py:215-242 write_table).  The simulator
keeps the same shape: exporters are small named plugins resolved from a
spec string (``name`` or ``name:arg``), and the built-in ``bigquery``
exporter writes the exact datafile ``bq insert`` consumes — in this
zero-egress environment it records the command instead of running it,
so the artifact is drop-in for a real ``bq`` invocation.
"""
from __future__ import annotations

import json
import pathlib
from typing import Callable, Dict, List, Sequence

import numpy as np

from isotope_tpu_torch.metrics.attribution import as_numpy


class ExportError(ValueError):
    pass


# name -> factory(arg: str | None) -> exporter; an exporter is a
# callable (results, out_dir) -> str describing what it produced
_REGISTRY: Dict[str, Callable] = {}


def register_exporter(name: str, factory: Callable) -> None:
    """Register a custom exporter factory under ``name``."""
    _REGISTRY[name] = factory


def resolve_exporter(spec: str):
    """``name`` or ``name:arg`` -> exporter callable."""
    name, _, arg = spec.partition(":")
    if name not in _REGISTRY:
        raise ExportError(
            f"unknown exporter {name!r}; available: "
            f"{sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](arg or None)


def _bigquery(table):
    if not table:
        raise ExportError(
            "bigquery exporter needs a table: --export "
            "bigquery:project.dataset.table (fortio.py:238)"
        )

    def export(results: Sequence, out_dir) -> str:
        out_dir = pathlib.Path(out_dir)
        datafile = out_dir / "bq_rows.json"
        with open(datafile, "w") as f:
            for r in results:
                f.write(json.dumps(r.fortio_json) + "\n")
        # the reference runs: bq insert <table> <datafile>
        # (fortio.py:236-242); record the exact command so the artifact
        # can be pushed from any machine with credentials
        cmd = f"bq insert {table} {datafile.name}"
        script = out_dir / "bq_insert.sh"
        script.write_text(
            "#!/bin/sh\n# generated by isotope-tpu (fortio.py:236-242 "
            f"parity)\ncd \"$(dirname \"$0\")\"\n{cmd}\n"
        )
        script.chmod(0o755)
        return f"{len(list(results))} rows -> {datafile} ({cmd})"

    return export


def _gcs(bucket_prefix):
    if not bucket_prefix:
        raise ExportError(
            "gcs exporter needs a destination: --export "
            "gcs:gs://bucket/path (run_benchmark_job.sh:92-100)"
        )

    def export(results: Sequence, out_dir) -> str:
        out_dir = pathlib.Path(out_dir)
        cmd = f"gsutil -m cp -r {out_dir} {bucket_prefix}/"
        script = out_dir / "gcs_upload.sh"
        script.write_text(
            "#!/bin/sh\n# generated by isotope-tpu "
            f"(run_benchmark_job.sh parity)\n{cmd}\n"
        )
        script.chmod(0o755)
        return f"upload script -> {script} ({cmd})"

    return export


register_exporter("bigquery", _bigquery)
register_exporter("gcs", _gcs)


def run_exporters(
    specs: Sequence[str], results: Sequence, out_dir
) -> List[str]:
    return [resolve_exporter(s)(results, out_dir) for s in specs]


# -- attribution artifacts (metrics/attribution.py) -------------------------
#
# The blame layer's two visual exports: a collapsed-stack flamegraph of
# the critical-path blame (Brendan Gregg's `flamegraph.pl` / speedscope
# input format — one "frame;frame;... value" line per stack, values in
# integer microseconds) and a Perfetto/Chrome counter-track file whose
# per-service tracks plot the blame distribution over the log-bucket
# axis (ts = bucket center in us, value = requests in the bucket).


def _hop_stacks(compiled) -> List[str]:
    """Per-hop ancestor-chain stack strings, root-first ("client;a;b").

    Hops are BFS-ordered, so every parent's stack exists before its
    children's.
    """
    names = compiled.services.names
    parent = compiled.hop_parent
    hs = compiled.hop_service
    stacks: List[str] = []
    for h in range(compiled.num_hops):
        base = "client" if parent[h] < 0 else stacks[parent[h]]
        stacks.append(f"{base};{names[hs[h]]}")
    return stacks


def flamegraph_collapsed(compiled, attr, tail: bool = False) -> str:
    """Collapsed-stack rendering of the blame vectors.

    Each hop's service-chain stack carries its self blame; synthetic
    ``[wait]`` / ``[net]`` / ``[timeout]`` leaf frames split out the
    queueing, wire, and timeout charges so the flame's width is exactly
    the total attributed latency.  ``tail=True`` renders the
    conditional-tail accumulators instead of the mean ones.
    """
    stacks = _hop_stacks(compiled)
    if tail:
        parts = (attr.tail_self_blame, attr.tail_wait_blame,
                 attr.tail_net_blame, attr.tail_timeout_blame)
    else:
        parts = (attr.self_blame, attr.wait_blame, attr.net_blame,
                 attr.timeout_blame)
    self_b, wait_b, net_b, tmo_b = (
        np.asarray(as_numpy(p), np.float64) for p in parts
    )
    agg: dict = {}

    def add(stack: str, seconds: float) -> None:
        us = int(round(seconds * 1e6))
        if us > 0:
            agg[stack] = agg.get(stack, 0) + us

    for h, stack in enumerate(stacks):
        add(stack, self_b[h])
        add(f"{stack};[wait]", wait_b[h])
        add(f"{stack};[net]", net_b[h])
        add(f"{stack};[timeout]", tmo_b[h])
    return "\n".join(
        f"{stack} {us}" for stack, us in sorted(agg.items())
    ) + ("\n" if agg else "")


def write_flamegraph(path, compiled, attr, tail: bool = False) -> int:
    """Write the collapsed-stack file; returns the line count."""
    text = flamegraph_collapsed(compiled, attr, tail=tail)
    pathlib.Path(path).write_text(text)
    return len(text.splitlines())


def perfetto_counters(compiled, attr, top: int = 24) -> dict:
    """Chrome/Perfetto counter-track JSON from the blame summary.

    One ``blame_share`` counter event carries the top services' mean
    (and tail, when armed) blame shares; per-service ``blame dist``
    tracks plot the per-hop blame histogram over the log-bucket axis.
    Loads in ui.perfetto.dev / chrome://tracing next to the exemplar
    trace.
    """
    from isotope_tpu_torch.metrics import attribution

    rows = attribution.service_blame(compiled, attr)[:top]
    tail_on = bool(np.isfinite(float(as_numpy(attr.tail_cut))))
    tail_rows = {
        r["service"]: r
        for r in (
            attribution.service_blame(compiled, attr, tail=True)[:top]
            if tail_on
            else []
        )
    }
    events: List[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "isotope-tpu blame"},
        },
        {
            "name": "blame_share_mean", "ph": "C", "ts": 0, "pid": 0,
            "args": {
                r["service"]: round(r["share"], 6) for r in rows
            },
        },
    ]
    if tail_rows:
        events.append(
            {
                "name": "blame_share_tail", "ph": "C", "ts": 0,
                "pid": 0,
                "args": {
                    s: round(r["share"], 6)
                    for s, r in tail_rows.items()
                },
            }
        )
    centers = attribution.blame_bucket_centers() * 1e6  # us
    hist = np.asarray(as_numpy(attr.hist), np.float64)
    name_to_idx = {
        n: i for i, n in enumerate(compiled.services.names)
    }
    for r in rows:
        s = name_to_idx[r["service"]]
        for b in np.nonzero(hist[s])[0]:
            events.append(
                {
                    "name": f"blame dist {r['service']}",
                    "ph": "C",
                    "ts": float(centers[b]),
                    "pid": 0,
                    "args": {"requests": float(hist[s, b])},
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "isotope-tpu attribution",
            "tail_cut_s": (
                float(as_numpy(attr.tail_cut)) if tail_on else None
            ),
        },
    }


def write_perfetto_counters(path, compiled, attr, top: int = 24) -> int:
    """Write the counter-track file; returns the event count."""
    doc = perfetto_counters(compiled, attr, top=top)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return len(doc["traceEvents"])


# -- timeline artifacts (metrics/timeline.py) --------------------------------
#
# The flight recorder's Perfetto surface: REAL sim-time counter tracks
# (ts = window start in us) — client qps/errors plus per-service
# utilization / queue-depth tracks for the most active services — so a
# run's windowed series loads in ui.perfetto.dev next to the exemplar
# trace and the blame counters on one shared time axis.


def timeline_perfetto(compiled, tl, top: int = 16) -> dict:
    """Chrome/Perfetto counter-track JSON from a TimelineSummary."""
    dt = float(tl.window_s)
    W = tl.num_windows
    arr = np.asarray(as_numpy(tl.arrivals), np.float64)
    errs = np.asarray(as_numpy(tl.errors), np.float64)
    events: List[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "isotope-tpu timeline"},
        }
    ]
    for w in range(W):
        ts = w * dt * 1e6
        events.append({
            "name": "client qps", "ph": "C", "ts": ts, "pid": 0,
            "args": {"qps": round(float(arr[w]) / dt, 4)},
        })
        events.append({
            "name": "client errors", "ph": "C", "ts": ts, "pid": 0,
            "args": {"errors": float(errs[w])},
        })
    names = compiled.services.names
    reps = np.asarray(compiled.services.replicas, np.float64)
    busy = np.asarray(as_numpy(tl.svc_busy_s), np.float64)
    queue = np.maximum(
        np.asarray(as_numpy(tl.svc_inflight_s), np.float64) - busy, 0.0
    )
    order = np.argsort(-busy.sum(1), kind="stable")[:top]
    for s in order:
        s = int(s)
        if busy[s].sum() <= 0:
            continue
        for w in range(W):
            ts = w * dt * 1e6
            events.append({
                "name": f"util {names[s]}", "ph": "C", "ts": ts,
                "pid": 0,
                "args": {
                    "utilization": round(
                        float(busy[s, w])
                        / (dt * max(float(reps[s]), 1.0)),
                        6,
                    )
                },
            })
            events.append({
                "name": f"queue {names[s]}", "ph": "C", "ts": ts,
                "pid": 0,
                "args": {
                    "depth": round(float(queue[s, w]) / dt, 6)
                },
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "isotope-tpu timeline",
            "window_s": dt,
        },
    }


def write_timeline_perfetto(path, compiled, tl, top: int = 16) -> int:
    """Write the timeline counter-track file; returns the event count."""
    doc = timeline_perfetto(compiled, tl, top=top)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return len(doc["traceEvents"])
