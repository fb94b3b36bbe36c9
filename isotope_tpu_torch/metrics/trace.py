"""Distributed-trace export from simulated runs.

The port of ``isotope_tpu.metrics.trace``: host formatting of a
:class:`~isotope_tpu_torch.sim.engine.SimResults` (its tensors are
moved to the CPU first).

The reference's mock service wraps every request handler and script
command in OpenTelemetry spans exported to Jaeger
(isotope/service/main.go:76-109: JAEGERADDR/JAEGERPORT/NOTRACING config;
srv/executable.go:49-74: per-command spans with error recording), with
B3 header forwarding stitching the per-pod spans into one distributed
trace per client request (srv/header.go:21-48).

The simulator holds the same span data densely — per-hop start times,
server-side durations, statuses, and the static parent pointers of the
unrolled call tree — so a trace is a formatting pass over SimResults:

- ``chrome_trace``: the Chrome/Perfetto trace-event format (one
  process per request, one thread per call depth, "X" complete events);
- ``jaeger_trace``: Jaeger's JSON wire shape (one traceID per request,
  CHILD_OF references along hop parents) as its UI's upload accepts.

Like the reference's samplers, traces are for *sampled* requests — the
product load path reduces to histograms; tracing re-runs a small dense
batch (``simulate --trace``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from isotope_tpu_torch.compiler.program import CompiledGraph
from isotope_tpu_torch.metrics.attribution import as_numpy
from isotope_tpu_torch.sim.engine import SimResults


def _as_host(res: SimResults):
    return (
        as_numpy(res.hop_sent),
        np.asarray(as_numpy(res.hop_start), np.float64),
        np.asarray(as_numpy(res.hop_latency), np.float64),
        as_numpy(res.hop_error),
    )


def chrome_trace(
    compiled: CompiledGraph,
    res: SimResults,
    max_requests: Optional[int] = None,
    annotations: Optional[List[dict]] = None,
) -> dict:
    """Render sampled requests as Chrome trace-event JSON.

    Layout: pid = request index, tid = call depth, one complete ("X")
    event per executed hop; timestamps in microseconds.
    ``annotations`` (one dict per request, e.g. the tail-exemplar
    ``tail_rank``/``tail_cut_s`` of metrics/attribution.py) merge into
    every event's ``args``.
    """
    sent, start, lat, err = _as_host(res)
    names = compiled.services.names
    depth = compiled.hop_depth
    parent = compiled.hop_parent
    n = sent.shape[0] if max_requests is None else min(
        max_requests, sent.shape[0]
    )
    events: List[dict] = []
    for r in range(n):
        extra = annotations[r] if annotations else {}
        for h in np.nonzero(sent[r])[0]:
            events.append(
                {
                    "name": names[compiled.hop_service[h]],
                    "cat": "hop",
                    "ph": "X",
                    "ts": start[r, h] * 1e6,
                    "dur": lat[r, h] * 1e6,
                    "pid": int(r),
                    "tid": int(depth[h]),
                    "args": {
                        "hop": int(h),
                        "parent_hop": int(parent[h]),
                        "status": 500 if err[r, h] else 200,
                        **extra,
                    },
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "isotope-tpu simulate --trace"},
    }


def _jaeger_tag(key: str, value):
    if isinstance(value, bool):
        return {"key": key, "type": "bool", "value": value}
    if isinstance(value, int):
        return {"key": key, "type": "int64", "value": value}
    if isinstance(value, float):
        return {"key": key, "type": "float64", "value": value}
    return {"key": key, "type": "string", "value": str(value)}


def jaeger_trace(
    compiled: CompiledGraph,
    res: SimResults,
    max_requests: Optional[int] = None,
    annotations: Optional[List[dict]] = None,
) -> dict:
    """Render sampled requests in Jaeger's JSON shape (one trace per
    request; spans reference their caller hop with CHILD_OF, the
    simulated B3 propagation of srv/header.go:21-48).  ``annotations``
    (one dict per request) become extra tags on every span."""
    sent, start, lat, err = _as_host(res)
    names = compiled.services.names
    parent = compiled.hop_parent
    H = compiled.num_hops
    data = []
    n = sent.shape[0] if max_requests is None else min(
        max_requests, sent.shape[0]
    )
    for r in range(n):
        trace_id = f"{r + 1:032x}"
        spans = []
        procs: Dict[str, dict] = {}
        extra_tags = [
            _jaeger_tag(k, v)
            for k, v in (annotations[r] if annotations else {}).items()
        ]
        for h in np.nonzero(sent[r])[0]:
            svc = names[compiled.hop_service[h]]
            pkey = f"p{compiled.hop_service[h]}"
            procs[pkey] = {"serviceName": svc}
            span = {
                "traceID": trace_id,
                "spanID": f"{r * H + int(h) + 1:016x}",
                "operationName": "execute-request-command",
                "references": [],
                "startTime": int(start[r, h] * 1e6),
                "duration": int(lat[r, h] * 1e6),
                "processID": pkey,
                "tags": [
                    {
                        "key": "http.status_code",
                        "type": "int64",
                        "value": 500 if err[r, h] else 200,
                    },
                    {"key": "hop", "type": "int64", "value": int(h)},
                ] + extra_tags,
            }
            if parent[h] >= 0 and sent[r, parent[h]]:
                span["references"].append(
                    {
                        "refType": "CHILD_OF",
                        "traceID": trace_id,
                        "spanID": f"{r * H + int(parent[h]) + 1:016x}",
                    }
                )
            spans.append(span)
        data.append(
            {"traceID": trace_id, "spans": spans, "processes": procs}
        )
    return {"data": data}


def exemplar_annotations(attr) -> List[dict]:
    """Per-request tail annotations for an exemplar batch: the rank
    among the mined slowest requests (0 = slowest) plus the tail cut
    the run used, carried in Chrome ``args`` / Jaeger ``tags``."""
    ex = attr.exemplars
    if ex is None:
        raise ValueError(
            "attribution summary carries no exemplars (run with "
            "attribution_top_k > 0)"
        )
    cut = float(as_numpy(attr.tail_cut))
    k = int(as_numpy(ex.latency).shape[0])
    out = []
    for r in range(k):
        ann = {"tail_rank": r}
        if np.isfinite(cut):
            ann["tail_cut_s"] = cut
        out.append(ann)
    return out


def write_trace(
    path: str,
    compiled: CompiledGraph,
    res: Optional[SimResults] = None,
    fmt: str = "chrome",
    max_requests: Optional[int] = None,
    exemplars=None,
) -> int:
    """Write a trace file; returns the number of requests traced.

    ``exemplars`` accepts an
    :class:`~isotope_tpu_torch.metrics.attribution.AttributionSummary` whose
    mined top-K batch is traced directly — no dense re-run — with
    ``tail_rank`` / ``tail_cut_s`` annotations on every span.
    """
    annotations = None
    if exemplars is not None:
        from isotope_tpu_torch.metrics import attribution

        res = attribution.exemplar_results(exemplars)
        annotations = exemplar_annotations(exemplars)
    if res is None:
        raise ValueError("write_trace needs res or exemplars")
    if fmt == "chrome":
        doc = chrome_trace(compiled, res, max_requests, annotations)
        count = len({e["pid"] for e in doc["traceEvents"]})
    elif fmt == "jaeger":
        doc = jaeger_trace(compiled, res, max_requests, annotations)
        count = len(doc["data"])
    else:
        raise ValueError(f"unknown trace format: {fmt!r}")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return count
