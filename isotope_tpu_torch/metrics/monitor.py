"""Monitor-status sink: the alert-webhook analogue.

A copy of ``isotope_tpu.metrics.monitor`` (host only).

The reference's release-qual path wires Alertmanager to a webhook
(perf/stability/alertmanager/webhook.go:26-56) that re-queries
Prometheus to confirm each alert and writes MonitorStatus rows to Cloud
Spanner for the eng.istio.io dashboard.  The simulation analogue:
evaluate the alarm queries against a run's metric store and append one
MonitorStatus row per check — confirmed by re-evaluating the query the
way the webhook re-queries before writing (a flapping source read
between evaluations is recorded as INCONCLUSIVE, not ALARM) — to a
JSONL sink any dashboard can ingest.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, List, Optional, Sequence, Tuple

from isotope_tpu_torch.metrics.alarms import Query
from isotope_tpu_torch.metrics.query import MetricStore

STATUS_OK = "OK"
STATUS_ALARM = "ALARM"
STATUS_INCONCLUSIVE = "INCONCLUSIVE"


@dataclasses.dataclass(frozen=True)
class MonitorStatus:
    """One check outcome (webhook.go's Spanner row shape: monitor name,
    status, detail, and the observed value).

    ``window_index`` / ``sim_time_s`` localize a per-window evaluation
    (the timeline recorder's scrape sequence) on the sim-time axis —
    an SLO breach gets an ONSET, not just a run-level verdict.  Legacy
    run-level rows leave both ``None``; JSONL rows written before the
    fields existed read back with the same defaults.
    """

    monitor: str
    status: str
    value: float
    detail: str
    run_label: str = ""
    window_index: Optional[int] = None
    sim_time_s: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def evaluate(
    queries: Sequence[Query],
    store: MetricStore,
    run_label: str = "",
    window_index: Optional[int] = None,
    sim_time_s: Optional[float] = None,
) -> List[MonitorStatus]:
    """Evaluate every check, re-querying to confirm alarms.

    ``window_index`` / ``sim_time_s`` stamp every produced row when the
    store covers one timeline window instead of a whole run."""
    rows: List[MonitorStatus] = []
    for q in queries:
        if q.running_query is not None and (
            store.query_value(q.running_query) <= 0
        ):
            continue
        value = store.query_value(q.query)
        if not q.alarm.in_alarm(value):
            rows.append(
                MonitorStatus(q.description, STATUS_OK, float(value), "",
                              run_label, window_index, sim_time_s)
            )
            continue
        # the webhook re-queries before writing an alarm row; a source
        # that stopped alarming between reads is flapping, not firing
        confirm = store.query_value(q.query)
        if q.alarm.in_alarm(confirm):
            rows.append(
                MonitorStatus(
                    q.description, STATUS_ALARM, float(confirm),
                    q.alarm.error_message, run_label,
                    window_index, sim_time_s,
                )
            )
        else:
            rows.append(
                MonitorStatus(
                    q.description, STATUS_INCONCLUSIVE, float(confirm),
                    "alarm did not confirm on re-query", run_label,
                    window_index, sim_time_s,
                )
            )
    return rows


def evaluate_windows(
    queries: Sequence[Query],
    window_stores: Iterable[Tuple[int, float, MetricStore]],
    run_label: str = "",
) -> List[MonitorStatus]:
    """Evaluate the checks once per timeline window.

    ``window_stores`` yields ``(window_index, sim_time_s, store)``
    (the shape :func:`isotope_tpu_torch.metrics.timeline.window_stores`
    produces); every returned row carries its window's sim-time stamp,
    so ``first_alarm_onset`` can report when a breach STARTED."""
    rows: List[MonitorStatus] = []
    for w, t, store in window_stores:
        rows.extend(
            evaluate(queries, store, run_label,
                     window_index=int(w), sim_time_s=float(t))
        )
    return rows


def first_alarm_onset(
    rows: Sequence[MonitorStatus],
) -> Optional[MonitorStatus]:
    """The earliest-window ALARM row, or None — the sim-time onset of
    the first SLO breach."""
    alarms = [
        r for r in rows
        if r.status == STATUS_ALARM and r.window_index is not None
    ]
    return min(alarms, key=lambda r: r.window_index) if alarms else None


class MonitorSink:
    """Append-only JSONL sink (the Spanner-table stand-in)."""

    def __init__(self, path):
        self.path = pathlib.Path(path)

    def write(self, rows: Sequence[MonitorStatus]) -> None:
        with open(self.path, "a") as f:
            for row in rows:
                f.write(row.to_json() + "\n")

    def read(self) -> List[MonitorStatus]:
        if not self.path.exists():
            return []
        out = []
        for line in self.path.read_text().splitlines():
            if line.strip():
                out.append(MonitorStatus(**json.loads(line)))
        return out

    def alarms(self) -> List[MonitorStatus]:
        return [r for r in self.read() if r.status == STATUS_ALARM]


def monitor_run(
    store: MetricStore,
    sink: MonitorSink,
    queries: Sequence[Query],
    run_label: str = "",
) -> List[MonitorStatus]:
    """Evaluate + persist; returns the rows written."""
    rows = evaluate(queries, store, run_label)
    sink.write(rows)
    return rows
