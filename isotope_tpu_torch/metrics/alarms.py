"""Alarm assertions over simulated runs — evaluated as Prometheus queries.

The reference's stability gate is ``metrics/check_metrics.py``: a unittest
suite where each check is a PromQL ``Query`` paired with an ``Alarm``
predicate (metrics/prometheus.py:21-29), with standard checks — zero 5xx,
proxy CPU below 50 milli-cores (250 for the service-graph load test,
check_metrics.py:61-102,170-174), memory below limits — run against a
long-lived cluster's Prometheus.

Here the same Query/Alarm shape carries a real query *string*, evaluated
by :class:`~isotope_tpu_torch.metrics.query.MetricStore` against the run's own
text exposition (the five service series plus the sim-side resource
series of ``MetricsCollector.resource_text``) — the alarm layer consumes
exactly what a Prometheus scraper would see, instead of bypassing the
metrics with Python callables.

A copy of ``isotope_tpu.metrics.alarms`` (pure Python) for the port's
``check`` command.
"""
from __future__ import annotations

import collections
from typing import Callable, List, Sequence

from isotope_tpu_torch.metrics.query import MetricStore

# Same tuple shapes as the reference (metrics/prometheus.py:21-29).
Query = collections.namedtuple(
    "Query", ["description", "query", "alarm", "running_query"]
)
Alarm = collections.namedtuple("Alarm", ["in_alarm", "error_message"])

# check_metrics.py's unit conversions, applied inside the query string
# exactly like the reference's ``... * %f`` formatting (:73-84)
CPU_MILLI = 1000.0
MEM_MB = 1.0 / 2**20


def store_from_summary(collector, summary) -> MetricStore:
    """Build the queryable store for a run: the five service series plus
    the resource series, parsed back from the text exposition."""
    if summary.metrics is None:
        raise ValueError(
            "summary has no metrics; run with a MetricsCollector"
        )
    return MetricStore.from_text(
        collector.full_text(summary), float(summary.end_max)
    )


def standard_queries(
    label: str = "sim",
    cpu_lim: float = 50,
    mem_lim: float = 64,
) -> List[Query]:
    """The reference's standard checks (check_metrics.py:61-102), phrased
    against the sim's series the way the reference phrases them against
    istio/cadvisor series.

    ``cpu_lim`` is in milli-cores, ``mem_lim`` in MiB; the service-graph
    load test overrides them to 250/100 (check_metrics.py:170-174).
    """
    return [
        Query(
            f"{label}: 5xx Requests/s",
            # ≙ sum(rate(istio_requests_total{response_code=~"5.."}[1m]))
            'sum(rate(service_request_duration_seconds_count'
            '{code=~"5.."}[1m]))',
            Alarm(lambda r: r > 0, "There were 5xx errors."),
            None,
        ),
        Query(
            f"{label}: Service CPU",
            # ≙ rate(container_cpu_usage_seconds_total{...}[1m]) * 1000
            "max(sum(rate(service_cpu_usage_seconds_total[1m])) "
            f"by (service)) * {CPU_MILLI!r}",
            Alarm(lambda c: c > cpu_lim, "Service CPU is unexpectedly high."),
            None,
        ),
        Query(
            f"{label}: Service Memory",
            # ≙ max(max_over_time(container_memory_usage_bytes[1m])) * MB
            "max(max_over_time(service_memory_working_set_bytes[1m])) "
            f"* {MEM_MB!r}",
            Alarm(
                lambda m: m > mem_lim, "Service memory is unexpectedly high."
            ),
            None,
        ),
    ]


def requests_sanity(label: str = "sim") -> Query:
    """There must be *some* traffic (check_metrics.py istio_requests_sanity)."""
    return Query(
        f"{label}: Total Requests/s (sanity check)",
        "sum(rate(service_incoming_requests_total[1m]))",
        Alarm(lambda r: r <= 0, "No requests were recorded."),
        None,
    )


def run_queries(
    queries: Sequence[Query],
    store: MetricStore,
    debug: bool = False,
    log: Callable[[str], None] = print,
) -> List[str]:
    """Evaluate queries; return alarm messages (prometheus.py:63-71).

    A ``running_query`` gates the check: evaluate it first and skip the
    check when it returns <= 0 — the scenario isn't deployed
    (check_metrics.py:196-206).
    """
    errors: List[str] = []
    for q in queries:
        if q.running_query is not None and (
            store.query_value(q.running_query) <= 0
        ):
            continue
        value = store.query_value(q.query)
        if q.alarm.in_alarm(value):
            errors.append(f"{q.alarm.error_message} Response: {value}")
        if debug:
            log(f"Testing: {q.description}. Result: {value:f}.")
    return errors
