"""Telemetry readers: three formats, one Observation IR.

Every reader appends into a shared :class:`Observation` and records an
:class:`InputCoverage` row whose counters PARTITION the input — for the
text formats ``lines_total == blank + comment + parsed + malformed``
and ``parsed == used + ignored`` (for Envoy JSON the unit is stats
*entries* instead of physical lines).  The fidelity report surfaces
these rows verbatim, so a scrape with vendor series we don't model
shows up as ``ignored`` counts, never as silent truncation.

Formats:

- **Prometheus / OpenMetrics text** (:func:`read_prometheus`): the
  simulator's own exposition family (``service_*`` from
  metrics/prometheus.py, timestamped ``timeline_*`` from
  metrics/timeline.py).  Counter families are matched with and without
  the ``_total`` suffix; timestamped cumulative counters become
  per-window first differences.
- **Envoy cluster stats JSON** (:func:`read_envoy`): the
  ``/stats?format=json`` subset the reference's proxy dashboards read —
  ``cluster.<callee>.upstream_rq_total`` / ``upstream_rq_5xx`` /
  ``upstream_rq_time`` / ``upstream_cx_active``.  No timestamps, so the
  caller must supply an observation duration to turn counts into rates.
- **CSV span traces** (:func:`read_csv_trace`): the Alibaba
  cluster-trace / DeathStarBench shape — one row per call span with
  columns ``traceid`` (optional), ``caller``, ``callee``, ``timestamp``
  (s), ``rt`` (s), ``status``.  With trace ids the reader reconstructs
  parent/child span nesting: per-span self-time = rt minus the union of
  child span intervals (concurrency-safe), and sibling spans that
  overlap in time mark the caller for a concurrent call group.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from isotope_tpu_torch.metrics.query import Sample, parse_exposition_tolerant

# Caller names treated as the external load generator (entry traffic),
# not as mesh services.  "fortio-client" is our own exposition's client
# label (metrics/prometheus.py CLIENT_NAME); the rest are the aliases
# public trace dumps actually use.
CLIENT_ALIASES: Tuple[str, ...] = (
    "fortio-client", "client", "user", "USER", "(user)", "loadgen",
    "ingress", "",
)


@dataclasses.dataclass
class InputCoverage:
    """Accounting for one ingested input. Counters partition the input:
    ``lines_total == lines_blank + lines_comment + lines_parsed +
    lines_malformed`` and ``lines_parsed == samples_used +
    samples_ignored`` (Envoy JSON counts stats entries as 'lines')."""

    path: str
    format: str
    lines_total: int = 0
    lines_blank: int = 0
    lines_comment: int = 0
    lines_parsed: int = 0
    lines_malformed: int = 0
    samples_used: int = 0
    samples_ignored: int = 0
    # up to 5 (line_number, text) examples of malformed input
    malformed_examples: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list
    )
    notes: List[str] = dataclasses.field(default_factory=list)

    def note(self, msg: str) -> None:
        if msg not in self.notes:
            self.notes.append(msg)

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "format": self.format,
            "lines_total": self.lines_total,
            "lines_blank": self.lines_blank,
            "lines_comment": self.lines_comment,
            "lines_parsed": self.lines_parsed,
            "lines_malformed": self.lines_malformed,
            "samples_used": self.samples_used,
            "samples_ignored": self.samples_ignored,
            "malformed_examples": [
                [n, t] for n, t in self.malformed_examples
            ],
            "notes": list(self.notes),
        }


@dataclasses.dataclass
class ObservedService:
    """Everything the inputs told us about one service."""

    name: str
    incoming: float = 0.0          # total hops arriving
    errors: float = 0.0            # hops answered 500
    latency_sum_s: float = 0.0     # per-hop sojourn sum (duration hist)
    latency_count: float = 0.0
    # merged _bucket counts: upper bound (s) -> cumulative count
    latency_buckets: Dict[float, float] = dataclasses.field(
        default_factory=dict
    )
    cpu_seconds: Optional[float] = None    # station CPU (excl. sleeps)
    busy_seconds: Optional[float] = None   # occupancy [start+wait, end)
    wait_seconds: Optional[float] = None   # queue occupancy integral
    sojourn_seconds: Optional[float] = None  # occupancy [start, end)
    response_size_sum: float = 0.0
    response_size_count: float = 0.0
    replicas_hint: Optional[float] = None  # busy / (dt * utilization)
    # direct self-time observations (CSV span decomposition)
    self_time_sum_s: float = 0.0
    self_time_count: float = 0.0
    self_time_samples: List[float] = dataclasses.field(
        default_factory=list
    )


@dataclasses.dataclass
class Observation:
    """The merged IR all readers write into and the fitter reads."""

    services: Dict[str, ObservedService] = dataclasses.field(
        default_factory=dict
    )
    # (caller, callee) -> outgoing request count
    edges: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict
    )
    edge_size_sum: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict
    )
    edge_size_count: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict
    )
    # callers whose sibling spans overlap in time (CSV inference)
    concurrent_callers: Set[str] = dataclasses.field(default_factory=set)
    # external caller names seen in the inputs
    clients_seen: Set[str] = dataclasses.field(default_factory=set)
    # entry arrivals per window (first differences of the cumulative
    # timeline counter, or CSV timestamp bucketing)
    client_windows: Optional[List[float]] = None
    window_s: Optional[float] = None
    duration_s: Optional[float] = None
    inputs: List[InputCoverage] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

    def svc(self, name: str) -> ObservedService:
        s = self.services.get(name)
        if s is None:
            s = self.services[name] = ObservedService(name)
        return s

    def add_edge(self, src: str, dst: str, count: float) -> None:
        key = (src, dst)
        self.edges[key] = self.edges.get(key, 0.0) + count

    def note(self, msg: str) -> None:
        if msg not in self.notes:
            self.notes.append(msg)


# -- Prometheus / OpenMetrics ------------------------------------------


def _latest(samples: Sequence[Sample]) -> float:
    """Instant value of a (possibly timestamped) counter series: the
    sample with the greatest timestamp wins, matching
    query.MetricStore._select."""
    best = samples[0]
    for s in samples[1:]:
        a = -1 if best.timestamp_ms is None else best.timestamp_ms
        b = -1 if s.timestamp_ms is None else s.timestamp_ms
        if b >= a:
            best = s
    return best.value


def _window_diffs(samples: Sequence[Sample]) -> Tuple[List[int], List[float]]:
    """Cumulative timestamped counter -> (sorted ts_ms, per-window
    first differences). Non-monotone steps clamp at zero (counter
    resets in real scrapes)."""
    pts = sorted(
        ((s.timestamp_ms, s.value) for s in samples if s.timestamp_ms
         is not None),
        key=lambda p: p[0],
    )
    ts = [p[0] for p in pts]
    diffs: List[float] = []
    prev = 0.0
    for _, v in pts:
        diffs.append(max(v - prev, 0.0))
        prev = v
    return ts, diffs


# series the prometheus reader consumes; anything else parsed but not
# listed here counts as ignored (vendor series, engine telemetry, ...)
_PROM_HANDLED_PREFIXES = (
    "service_incoming_requests",
    "service_outgoing_requests",
    "service_request_duration_seconds",
    "service_response_size",
    "service_outgoing_request_size",
    "service_cpu_usage_seconds",
    "timeline_client_requests",
    "timeline_client_errors",
    "timeline_service_requests",
    "timeline_service_errors",
    "timeline_service_inflight",
    "timeline_service_queue_depth",
    "timeline_service_utilization",
)


def _family(name: str) -> str:
    """Base family name: strip counter/histogram sample suffixes so
    ``foo``, ``foo_total``, ``foo_bucket``, ``foo_sum``, ``foo_count``
    land in one family (OpenMetrics suffix tolerance)."""
    for suf in ("_total", "_bucket", "_sum", "_count"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def read_prometheus(
    text: str,
    path: str = "<prometheus>",
    obs: Optional[Observation] = None,
) -> Observation:
    """Parse one exposition (the simulator's full + timeline families,
    or any scrape containing them) into the Observation IR."""
    if obs is None:
        obs = Observation()
    parse = parse_exposition_tolerant(text)
    cov = InputCoverage(path=path, format="prometheus")
    cov.lines_total = parse.lines_total
    cov.lines_blank = parse.lines_blank
    cov.lines_comment = parse.lines_comment
    cov.lines_parsed = parse.lines_parsed
    cov.lines_malformed = parse.lines_malformed
    cov.malformed_examples = list(parse.malformed[:5])

    by_name: Dict[str, List[Sample]] = {}
    for s in parse.samples:
        by_name.setdefault(s.name, []).append(s)

    used = 0

    def take(name: str) -> List[Sample]:
        nonlocal used
        got = by_name.pop(name, [])
        used += len(got)
        return got

    def by_label(
        samples: Sequence[Sample], *keys: str
    ) -> Dict[Tuple[str, ...], List[Sample]]:
        out: Dict[Tuple[str, ...], List[Sample]] = {}
        for s in samples:
            out.setdefault(
                tuple(s.labels.get(k, "") for k in keys), []
            ).append(s)
        return out

    # ---- full exposition (untimestamped totals) ----
    incoming = take("service_incoming_requests_total") + take(
        "service_incoming_requests"
    )
    for (svc,), group in by_label(incoming, "service").items():
        obs.svc(svc).incoming += _latest(group)

    outgoing = take("service_outgoing_requests_total") + take(
        "service_outgoing_requests"
    )
    for (src, dst), group in by_label(
        outgoing, "service", "destination_service"
    ).items():
        if src in CLIENT_ALIASES:
            obs.clients_seen.add(src)
        obs.add_edge(src, dst, _latest(group))

    for (svc, _code), group in by_label(
        take("service_request_duration_seconds_sum"), "service", "code"
    ).items():
        obs.svc(svc).latency_sum_s += _latest(group)
    for (svc, code), group in by_label(
        take("service_request_duration_seconds_count"), "service", "code"
    ).items():
        v = _latest(group)
        obs.svc(svc).latency_count += v
        if code.startswith("5"):
            obs.svc(svc).errors += v
    for (svc, le), groups in by_label(
        take("service_request_duration_seconds_bucket"), "service", "le"
    ).items():
        try:
            bound = float(le)
        except ValueError:
            cov.note(f"unparseable le={le!r} bucket bound dropped")
            continue
        # codes merged: per-(svc, le) groups may span code labels
        per_code = by_label(groups, "code")
        b = obs.svc(svc).latency_buckets
        b[bound] = b.get(bound, 0.0) + sum(
            _latest(g) for g in per_code.values()
        )

    for (svc, _code), group in by_label(
        take("service_response_size_sum"), "service", "code"
    ).items():
        obs.svc(svc).response_size_sum += _latest(group)
    for (svc, _code), group in by_label(
        take("service_response_size_count"), "service", "code"
    ).items():
        obs.svc(svc).response_size_count += _latest(group)
    used += len(take("service_response_size_bucket"))

    for (src, dst), group in by_label(
        take("service_outgoing_request_size_sum"),
        "service", "destination_service",
    ).items():
        k = (src, dst)
        obs.edge_size_sum[k] = obs.edge_size_sum.get(k, 0.0) + _latest(
            group
        )
    for (src, dst), group in by_label(
        take("service_outgoing_request_size_count"),
        "service", "destination_service",
    ).items():
        k = (src, dst)
        obs.edge_size_count[k] = obs.edge_size_count.get(
            k, 0.0
        ) + _latest(group)
    used += len(take("service_outgoing_request_size_bucket"))

    cpu = take("service_cpu_usage_seconds_total") + take(
        "service_cpu_usage_seconds"
    )
    for (svc,), group in by_label(cpu, "service").items():
        s = obs.svc(svc)
        s.cpu_seconds = (s.cpu_seconds or 0.0) + _latest(group)

    # ---- timestamped timeline exposition ----
    cli_req = take("timeline_client_requests_total") + take(
        "timeline_client_requests"
    )
    if cli_req:
        ts, diffs = _window_diffs(cli_req)
        if len(ts) >= 2:
            steps = [(b - a) / 1e3 for a, b in zip(ts, ts[1:])]
            steps = [s for s in steps if s > 0]
            window_s = sorted(steps)[len(steps) // 2] if steps else None
        else:
            window_s = None
        if window_s is None and len(ts) == 1:
            window_s = ts[0] / 1e3
        if obs.client_windows is None:
            obs.client_windows = diffs
            obs.window_s = window_s
            obs.duration_s = ts[-1] / 1e3 if ts else None
        else:
            obs.note(
                f"{path}: second client window series ignored "
                "(schedule already set)"
            )
    used += len(take("timeline_client_errors_total"))

    # per-service timeline: totals fall back to / cross-check the full
    # exposition; occupancy gauges feed the self-time decomposition
    tl_req = by_label(
        take("timeline_service_requests_total"), "service"
    )
    tl_err = by_label(take("timeline_service_errors_total"), "service")
    tl_inf = by_label(take("timeline_service_inflight"), "service")
    tl_q = by_label(take("timeline_service_queue_depth"), "service")
    tl_util = by_label(take("timeline_service_utilization"), "service")

    for (svc,), group in tl_req.items():
        s = obs.svc(svc)
        if s.incoming == 0.0:
            s.incoming = _latest(group)
    for (svc,), group in tl_err.items():
        s = obs.svc(svc)
        if s.errors == 0.0 and s.latency_count == 0.0:
            s.errors = _latest(group)

    dt = obs.window_s
    if dt:
        for (svc,), group in tl_inf.items():
            s = obs.svc(svc)
            inf_pts = sorted(
                (g.timestamp_ms, g.value) for g in group
                if g.timestamp_ms is not None
            )
            q_pts = dict(
                (g.timestamp_ms, g.value)
                for g in tl_q.get((svc,), [])
                if g.timestamp_ms is not None
            )
            u_pts = dict(
                (g.timestamp_ms, g.value)
                for g in tl_util.get((svc,), [])
                if g.timestamp_ms is not None
            )
            sojourn = busy = wait = 0.0
            rep_samples: List[float] = []
            for t, inflight in inf_pts:
                queue = q_pts.get(t, 0.0)
                util = u_pts.get(t, 0.0)
                busy_n = max(inflight - queue, 0.0)
                sojourn += inflight * dt
                busy += busy_n * dt
                wait += queue * dt
                if util > 1e-9 and busy_n > 1e-9:
                    rep_samples.append(busy_n / util)
            s.sojourn_seconds = (s.sojourn_seconds or 0.0) + sojourn
            s.busy_seconds = (s.busy_seconds or 0.0) + busy
            s.wait_seconds = (s.wait_seconds or 0.0) + wait
            if rep_samples:
                rep_samples.sort()
                s.replicas_hint = rep_samples[len(rep_samples) // 2]
    elif tl_inf:
        cov.note(
            "timeline gauges present but window length unknown "
            "(no timeline_client_requests_total): occupancy ignored"
        )

    ignored = sum(len(v) for v in by_name.values())
    families = sorted({_family(n) for n in by_name})
    if families:
        cov.note(
            "ignored series families: " + ", ".join(families[:8])
            + ("..." if len(families) > 8 else "")
        )
    cov.samples_used = used
    cov.samples_ignored = ignored
    assert cov.samples_used + cov.samples_ignored == cov.lines_parsed, (
        cov.samples_used, cov.samples_ignored, cov.lines_parsed,
    )
    obs.inputs.append(cov)
    return obs


# -- Envoy /stats cluster JSON -----------------------------------------

# the stat suffixes we model; matched from the END of the stat name so
# callee cluster names may themselves contain dots
_ENVOY_SUFFIXES = (
    "upstream_rq_total",
    "upstream_rq_5xx",
    "upstream_rq_time",
    "upstream_cx_active",
    "upstream_rq_active",
)


def read_envoy(
    text: str,
    path: str = "<envoy>",
    obs: Optional[Observation] = None,
    default_caller: str = "ingress",
) -> Observation:
    """Parse Envoy ``/stats?format=json`` cluster stats.

    Accepted shapes::

        {"services": {"<caller>": {"stats": [{"name":..., "value":...}]}}}
        {"stats": [{"name":..., "value":...}]}          # one caller

    Consumed stats: ``cluster.<callee>.upstream_rq_total`` (edge +
    callee arrivals), ``...upstream_rq_5xx`` (callee errors),
    ``...upstream_rq_time`` (mean ms -> latency sum),
    ``...upstream_cx_active`` / ``upstream_rq_active`` (concurrency
    hint).  Coverage counts stats ENTRIES (not physical lines); there
    are no timestamps, so rates require an externally supplied
    observation duration.
    """
    if obs is None:
        obs = Observation()
    cov = InputCoverage(path=path, format="envoy")
    try:
        doc = json.loads(text)
    except ValueError as e:
        cov.lines_total = 1
        cov.lines_malformed = 1
        cov.malformed_examples = [(1, f"invalid JSON: {e}")]
        obs.inputs.append(cov)
        return obs

    if isinstance(doc, dict) and isinstance(doc.get("services"), dict):
        callers = doc["services"]
    elif isinstance(doc, dict) and "stats" in doc:
        callers = {default_caller: doc}
    else:
        cov.lines_total = 1
        cov.lines_malformed = 1
        cov.malformed_examples = [
            (1, "unrecognized Envoy stats document shape")
        ]
        obs.inputs.append(cov)
        return obs

    rq_time: Dict[Tuple[str, str], float] = {}
    for caller, body in callers.items():
        stats = body.get("stats") if isinstance(body, dict) else None
        if not isinstance(stats, list):
            cov.lines_total += 1
            cov.lines_malformed += 1
            if len(cov.malformed_examples) < 5:
                cov.malformed_examples.append(
                    (cov.lines_total, f"service {caller!r}: no stats list")
                )
            continue
        if caller in CLIENT_ALIASES:
            obs.clients_seen.add(caller)
        for entry in stats:
            cov.lines_total += 1
            name = entry.get("name") if isinstance(entry, dict) else None
            value = entry.get("value") if isinstance(entry, dict) else None
            if not isinstance(name, str) or not isinstance(
                value, (int, float)
            ):
                cov.lines_malformed += 1
                if len(cov.malformed_examples) < 5:
                    cov.malformed_examples.append(
                        (cov.lines_total, repr(entry)[:120])
                    )
                continue
            cov.lines_parsed += 1
            if not name.startswith("cluster."):
                cov.samples_ignored += 1
                continue
            rest = name[len("cluster."):]
            matched = None
            for suf in _ENVOY_SUFFIXES:
                if rest.endswith("." + suf):
                    matched = suf
                    callee = rest[: -(len(suf) + 1)]
                    break
            if matched is None:
                cov.samples_ignored += 1
                continue
            cov.samples_used += 1
            v = float(value)
            if matched == "upstream_rq_total":
                obs.add_edge(caller, callee, v)
                obs.svc(callee).incoming += v
            elif matched == "upstream_rq_5xx":
                obs.svc(callee).errors += v
            elif matched == "upstream_rq_time":
                # Envoy renders this histogram as a mean in ms in the
                # JSON stats dump; defer to rq_total for the weight
                rq_time[(caller, callee)] = v / 1e3
            else:  # *_active gauges: replica/concurrency hint
                s = obs.svc(callee)
                s.replicas_hint = max(s.replicas_hint or 0.0, v)
    for (caller, callee), mean_s in rq_time.items():
        n = obs.edges.get((caller, callee), 0.0)
        if n > 0:
            s = obs.svc(callee)
            s.latency_sum_s += mean_s * n
            s.latency_count += n
    cov.note(
        "no timestamps in Envoy stats: qps schedule requires "
        "--duration; latency from upstream_rq_time means"
    )
    assert (
        cov.lines_total
        == cov.lines_parsed + cov.lines_malformed + cov.lines_blank
        + cov.lines_comment
    )
    assert cov.samples_used + cov.samples_ignored == cov.lines_parsed
    obs.inputs.append(cov)
    return obs


# -- CSV span traces ---------------------------------------------------

_CSV_COLUMNS = ("caller", "callee", "timestamp", "rt", "status")


def _union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by a set of [start, end) intervals —
    concurrency-safe child-time subtraction."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total


def read_csv_trace(
    text: str,
    path: str = "<csv>",
    obs: Optional[Observation] = None,
    window_s: float = 1.0,
) -> Observation:
    """Parse a span-per-row CSV trace (see README "Trace-driven ingest"
    for the schema).  Required columns: caller, callee, timestamp (s),
    rt (s), status (HTTP code, or ok/error).  Optional: traceid —
    enables self-time decomposition and concurrent-group inference.
    Callers never observed as callees are treated as external clients.
    """
    if obs is None:
        obs = Observation()
    cov = InputCoverage(path=path, format="csv")
    reader = csv.reader(io.StringIO(text))
    header: Optional[List[str]] = None
    col: Dict[str, int] = {}
    rows: List[tuple] = []  # (traceid, caller, callee, ts, rt, err)
    lineno = 0
    for raw in reader:
        lineno += 1
        cov.lines_total += 1
        if not raw or all(not c.strip() for c in raw):
            cov.lines_blank += 1
            continue
        if raw[0].lstrip().startswith("#"):
            cov.lines_comment += 1
            continue
        if header is None:
            header = [c.strip().lower() for c in raw]
            col = {name: i for i, name in enumerate(header)}
            missing = [c for c in _CSV_COLUMNS if c not in col]
            if missing:
                cov.lines_malformed += 1
                cov.malformed_examples.append(
                    (lineno, f"header missing columns: {missing}")
                )
                header = None
                col = {}
            else:
                cov.lines_comment += 1  # header is schema, not data
            continue
        try:
            caller = raw[col["caller"]].strip()
            callee = raw[col["callee"]].strip()
            ts = float(raw[col["timestamp"]])
            rt = float(raw[col["rt"]])
            status = raw[col["status"]].strip().lower()
        except (IndexError, ValueError):
            cov.lines_malformed += 1
            if len(cov.malformed_examples) < 5:
                cov.malformed_examples.append(
                    (lineno, ",".join(raw)[:120])
                )
            continue
        if not callee or rt < 0 or not math.isfinite(ts):
            cov.lines_malformed += 1
            if len(cov.malformed_examples) < 5:
                cov.malformed_examples.append(
                    (lineno, ",".join(raw)[:120])
                )
            continue
        cov.lines_parsed += 1
        cov.samples_used += 1
        err = status.startswith("5") or status in ("error", "err", "fail")
        tid = raw[col["traceid"]].strip() if "traceid" in col else ""
        rows.append((tid, caller, callee, ts, rt, err))

    if header is None and cov.lines_parsed == 0:
        cov.note("no valid header row: expected columns "
                 + ", ".join(_CSV_COLUMNS))
        obs.inputs.append(cov)
        return obs

    callees = {r[2] for r in rows}
    for tid, caller, callee, ts, rt, err in rows:
        if caller in CLIENT_ALIASES or caller not in callees:
            obs.clients_seen.add(caller)
        obs.add_edge(caller, callee, 1.0)
        s = obs.svc(callee)
        s.incoming += 1.0
        s.latency_sum_s += rt
        s.latency_count += 1.0
        if err:
            s.errors += 1.0

    # entry arrival windows from external-caller spans
    entry_ts = [
        r[3] for r in rows
        if r[1] in CLIENT_ALIASES or r[1] not in callees
    ]
    if entry_ts:
        t0, t1 = min(entry_ts), max(entry_ts)
        n_windows = max(1, int(math.ceil((t1 - t0) / window_s + 1e-9)))
        n_windows = max(n_windows, 1)
        windows = [0.0] * n_windows
        for t in entry_ts:
            w = min(int((t - t0) / window_s), n_windows - 1)
            windows[w] += 1.0
        if obs.client_windows is None:
            obs.client_windows = windows
            obs.window_s = window_s
            obs.duration_s = max(n_windows * window_s, t1 - t0)
    else:
        cov.note("no external-caller rows: qps schedule not inferred")

    # span nesting: self-time + concurrent-group inference (traceid)
    with_tid = [r for r in rows if r[0]]
    if with_tid:
        by_trace: Dict[str, Dict[str, List[tuple]]] = {}
        for r in with_tid:
            by_trace.setdefault(r[0], {}).setdefault(r[1], []).append(r)
        overlap_pairs: Dict[str, List[int]] = {}
        for callers_in_trace in by_trace.values():
            for spans in callers_in_trace.values():
                for _tid, _caller, callee, ts, rt, _err in spans:
                    # children: spans whose caller == this callee,
                    # starting inside this span's interval
                    kids = [
                        k for k in callers_in_trace.get(callee, [])
                        if ts - 1e-9 <= k[3] <= ts + rt + 1e-9
                    ]
                    child_iv = [
                        (k[3], min(k[3] + k[4], ts + rt)) for k in kids
                    ]
                    self_t = max(rt - _union_length(child_iv), 0.0)
                    s = obs.svc(callee)
                    s.self_time_sum_s += self_t
                    s.self_time_count += 1.0
                    if len(s.self_time_samples) < 10_000:
                        s.self_time_samples.append(self_t)
                    # sibling overlap among this span's children
                    if len(kids) >= 2:
                        kids.sort(key=lambda k: k[3])
                        tally = overlap_pairs.setdefault(callee, [0, 0])
                        for a, b in zip(kids, kids[1:]):
                            tally[1] += 1
                            if b[3] < a[3] + a[4] - 1e-9:
                                tally[0] += 1
        for svc, (hits, pairs) in overlap_pairs.items():
            if pairs > 0 and hits / pairs > 0.5:
                obs.concurrent_callers.add(svc)
    elif rows:
        cov.note(
            "no traceid column: self-time and concurrency not "
            "inferred; sojourn used as self-time upper bound"
        )

    assert (
        cov.lines_total
        == cov.lines_blank + cov.lines_comment + cov.lines_parsed
        + cov.lines_malformed
    )
    assert cov.samples_used + cov.samples_ignored == cov.lines_parsed
    obs.inputs.append(cov)
    return obs


# -- dispatch ----------------------------------------------------------


def read_path(
    path: str,
    obs: Optional[Observation] = None,
    fmt: Optional[str] = None,
    window_s: float = 1.0,
) -> Observation:
    """Read one input file, sniffing the format from the extension
    (``.json`` -> envoy, ``.csv`` -> csv, else prometheus) unless
    ``fmt`` pins it."""
    with open(path) as f:
        text = f.read()
    if fmt is None:
        low = path.lower()
        if low.endswith(".json"):
            fmt = "envoy"
        elif low.endswith(".csv"):
            fmt = "csv"
        else:
            fmt = "prometheus"
    if fmt == "envoy":
        return read_envoy(text, path=path, obs=obs)
    if fmt == "csv":
        return read_csv_trace(text, path=path, obs=obs, window_s=window_s)
    if fmt == "prometheus":
        return read_prometheus(text, path=path, obs=obs)
    raise ValueError(f"unknown ingest format: {fmt!r}")
