"""Background stability-scenario metrics: the shared series contract.

A copy of ``isotope_tpu.metrics.stability`` (numpy only).

The reference's long-running stability scenarios (redis, rabbitmq,
mysql, http10, gateway-bouncer, graceful-shutdown, ...) all report
through ONE metric surface, ``perf/docker/prom_client.py:1-40``: a
``stability_outgoing_requests`` counter labeled
``{source, destination, succeeded}`` incremented per attempted request
(``attempt_request``), plus a ``stability_test_instances{test}`` gauge
pinned to 1 while the scenario runs.  The alarm layer then asserts on
those series for every deployed scenario.

The backing services themselves (a real redis cluster, a rabbitmq
broker) are out of simulation scope — they exercise third-party
software, not the mesh.  What IS in scope is the metric contract: a
:class:`StabilityScenario` models the client loop (request cadence,
success probability, optional failure windows matching a
gateway-bouncer schedule), and :func:`stability_text` emits the exact
text exposition ``prom_client.py`` would serve, so
``metrics.alarms``/``metrics.query`` can assert reference-style
stability alarms (e.g. "zero failed scenario requests") against
simulated background scenarios.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from isotope_tpu_torch.metrics.alarms import Alarm, Query


@dataclasses.dataclass(frozen=True)
class StabilityScenario:
    """One background client loop (prom_client.py's attempt_request).

    ``period_s`` is the request cadence (the reference clients loop
    with a sleep); ``success_prob`` the per-request success chance
    outside failure windows; ``fail_windows`` are [start, end) spans of
    run time where every request fails — the shape of the
    gateway-bouncer coupling, where requests through a bouncing
    gateway fail while the gateway is down.
    """

    name: str                     # the {test} label / metric source
    destination: str              # e.g. "redis-master", "rabbitmq"
    period_s: float = 1.0
    success_prob: float = 1.0
    fail_windows: Tuple[Tuple[float, float], ...] = ()

    def __post_init__(self):
        if self.period_s <= 0:
            raise ValueError("period_s must be positive")
        if not 0.0 <= self.success_prob <= 1.0:
            raise ValueError("success_prob must be in [0, 1]")
        for lo, hi in self.fail_windows:
            if hi <= lo:
                raise ValueError("fail window must have end > start")

    def counts(self, duration_s: float, seed: int = 0) -> Tuple[int, int]:
        """(succeeded, failed) requests over ``duration_s`` seconds."""
        times = np.arange(0.0, duration_s, self.period_s)
        n = len(times)
        if n == 0:
            return 0, 0
        in_window = np.zeros(n, bool)
        for lo, hi in self.fail_windows:
            in_window |= (times >= lo) & (times < hi)
        # zlib.crc32 is process-stable; builtin hash() is salted per
        # interpreter, which would make (seed, name) irreproducible
        rng = np.random.default_rng(
            np.random.SeedSequence(
                [seed, zlib.crc32(self.name.encode())]
            )
        )
        ok = (rng.random(n) < self.success_prob) & ~in_window
        return int(ok.sum()), int(n - ok.sum())


def stability_text(
    scenarios: Sequence[StabilityScenario],
    duration_s: float,
    seed: int = 0,
) -> str:
    """Text exposition of the shared stability series
    (prom_client.py's Counter + Gauge as a Prometheus scraper sees
    them; the client library appends ``_total`` to counters)."""
    out: List[str] = [
        "# HELP stability_outgoing_requests_total Number of requests "
        "from this service.",
        "# TYPE stability_outgoing_requests_total counter",
    ]
    for sc in scenarios:
        ok, fail = sc.counts(duration_s, seed)
        for succeeded, count in (("True", ok), ("False", fail)):
            out.append(
                "stability_outgoing_requests_total{"
                f'source="{sc.name}",destination="{sc.destination}",'
                f'succeeded="{succeeded}"}} {count}'
            )
    out.append(
        "# HELP stability_test_instances Is this test running"
    )
    out.append("# TYPE stability_test_instances gauge")
    for sc in scenarios:
        out.append(
            f'stability_test_instances{{test="{sc.name}"}} 1'
        )
    return "\n".join(out) + "\n"


def stability_queries(
    scenarios: Sequence[StabilityScenario],
    max_failed: float = 0.0,
) -> List[Query]:
    """Reference-style per-scenario alarms: no failed requests (beyond
    ``max_failed``) while the scenario's instance gauge is up — the
    ``running_query`` gate mirrors check_metrics.py:196-206 (a check is
    skipped when its scenario isn't deployed)."""
    queries = []
    for sc in scenarios:
        queries.append(
            Query(
                f"stability: {sc.name} failed requests",
                'sum(rate(stability_outgoing_requests_total{'
                f'source="{sc.name}",succeeded="False"}}[1m]))',
                Alarm(
                    (lambda lim: lambda r: r > lim)(max_failed),
                    f"{sc.name}: background scenario requests failed.",
                ),
                f'sum(stability_test_instances{{test="{sc.name}"}})',
            )
        )
    return queries


def scenario_from_bounce(
    name: str,
    destination: str,
    bounce_schedule: Sequence[Tuple[float, float]],
    period_s: float = 1.0,
    success_prob: float = 1.0,
) -> StabilityScenario:
    """Couple a scenario's failure windows to a gateway-bouncer
    schedule (sim.config ChaosEvent bounce windows): requests issued
    while the gateway is down fail, exactly like the reference's
    istio-gateway-bouncer scenario observed through prom_client."""
    return StabilityScenario(
        name=name,
        destination=destination,
        period_s=period_s,
        success_prob=success_prob,
        fail_windows=tuple((float(lo), float(hi))
                           for lo, hi in bounce_schedule),
    )
