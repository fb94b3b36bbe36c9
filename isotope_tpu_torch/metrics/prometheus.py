"""Prometheus-compatible service metrics, collected in torch.

The port of ``isotope_tpu.metrics.prometheus``: the reference mock
service's five series with identical names, labels and bucket layouts
(isotope/service/pkg/srv/prometheus/handler.go:27-69):

- ``service_incoming_requests_total``            counter
- ``service_outgoing_requests_total``            counter, by destination
- ``service_outgoing_request_size``              histogram, by destination
- ``service_request_duration_seconds``           histogram, by code
- ``service_response_size``                      histogram, by code

Every series carries an explicit ``service`` label (the simulator has no
pods for Prometheus to label at scrape time).

:meth:`MetricsCollector.collect` reduces one block's ``SimResults`` on
the block's device.  Counts accumulate as integers, so they are exact
and do not depend on the order of the scatter-adds (the reference adds
float32 ones, exact up to 2^24); float sums are reduced per hop first
and then scattered per service, so on the card only the last bits of a
sum depend on the order of its few atomic adds.  The text exposition
(``to_text``, ``resource_text``, ``full_text``) is host code, copied.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from isotope_tpu_torch.compiler.program import CompiledGraph

F32 = torch.float32

# srv/prometheus/handler.go:27-31 — 32 buckets, 7ms..500ms.
DURATION_BUCKETS = np.asarray(
    [
        0.007, 0.008, 0.009, 0.01, 0.011, 0.012, 0.014, 0.016, 0.018, 0.02,
        0.025, 0.03, 0.035, 0.04, 0.045, 0.05, 0.06, 0.07, 0.08, 0.09, 0.1,
        0.12, 0.14, 0.16, 0.18, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5,
    ],
    np.float64,
)

# srv/prometheus/handler.go:32-35 — decade buckets 1B..1GB.
SIZE_BUCKETS = np.asarray([10.0 ** e for e in range(10)], np.float64)

# The client that drives the entrypoint (fortio_client.go:28-78).
CLIENT_NAME = "fortio-client"

_NB = len(DURATION_BUCKETS) + 1  # +overflow (+Inf)
_NSB = len(SIZE_BUCKETS) + 1


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline — the exposition-format spec's three escapes)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def render_labels(labels: Dict[str, str]) -> str:
    """``{a="x",b="y"}`` with escaped values; empty dict renders
    nothing."""
    if not labels:
        return ""
    body = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + body + "}"


def timestamped_series(
    out: List[str],
    name: str,
    help_text: str,
    type_: str,
    rows,
) -> None:
    """Append one metric family of TIMESTAMPED samples to ``out``.

    ``rows`` is an iterable of ``(labels: dict, value, timestamp_ms)``
    — the exposition-format's optional trailing timestamp, which lets
    one scrape carry a whole time series (each sim-time window renders
    as the sample a scrape at that instant would have returned).  Rows
    render in the given order; keep them (labels, then window) sorted
    so the exposition is deterministic.
    """
    out.append(f"# HELP {name} {help_text}")
    out.append(f"# TYPE {name} {type_}")
    for labels, value, ts_ms in rows:
        out.append(
            f"{name}{render_labels(labels)} {value:.10g} {int(ts_ms)}"
        )


def _np(x) -> np.ndarray:
    """A tensor on any device (or an array) as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ServiceMetrics(NamedTuple):
    """Per-run accumulators, float32 tensors like the reference's."""

    incoming_total: torch.Tensor        # (S,)
    outgoing_total: torch.Tensor        # (E,) per static call edge
    outgoing_size_hist: torch.Tensor    # (E, len(SIZE_BUCKETS)+1)
    outgoing_size_sum: torch.Tensor     # (E,)
    duration_hist: torch.Tensor         # (S, 2, _NB) code axis: 0=200, 1=500
    duration_sum: torch.Tensor          # (S, 2)
    response_size_hist: torch.Tensor    # (S, 2, len(SIZE_BUCKETS)+1)
    response_size_sum: torch.Tensor     # (S, 2)

    def __add__(self, other: "ServiceMetrics") -> "ServiceMetrics":
        return ServiceMetrics(*(a + b for a, b in zip(self, other)))


class MetricsCollector:
    """Compiled-topology-specific metric reduction.

    The hop -> (source, destination) edge map is static; edge 0 is
    always the client -> entrypoint edge.  The device tables are built
    on first use on the device of the results collected.
    """

    def __init__(self, compiled: CompiledGraph):
        self.compiled = compiled
        src = np.where(
            compiled.hop_parent >= 0,
            compiled.hop_service[np.maximum(compiled.hop_parent, 0)],
            -1,  # client
        )
        dst = compiled.hop_service
        pairs: List[Tuple[int, int]] = []
        pair_idx: Dict[Tuple[int, int], int] = {}
        hop_edge = np.zeros(compiled.num_hops, np.int64)
        for h in range(compiled.num_hops):
            p = (int(src[h]), int(dst[h]))
            if p not in pair_idx:
                pair_idx[p] = len(pairs)
                pairs.append(p)
            hop_edge[h] = pair_idx[p]
        self.edges: List[Tuple[int, int]] = pairs
        self._hop_edge_np = hop_edge
        # static per-hop byte sizes -> static size-bucket index
        self._hop_size_bucket_np = np.searchsorted(
            SIZE_BUCKETS, compiled.hop_request_size, "left"
        ).astype(np.int64)
        resp = compiled.services.response_size.astype(np.float64)
        self._svc_resp_bucket_np = np.searchsorted(
            SIZE_BUCKETS, resp, "left"
        ).astype(np.int64)
        self._svc_resp_size_np = resp.astype(np.float32)
        self._tables: Dict[torch.device, dict] = {}

    def _device_tables(self, dev: torch.device) -> dict:
        if dev not in self._tables:
            c = self.compiled
            hs = c.hop_service.astype(np.int64)

            def t(x, dtype):
                return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

            self._tables[dev] = dict(
                hop_service=t(hs, torch.int64),
                hop_edge=t(self._hop_edge_np, torch.int64),
                out_size_slot=t(
                    self._hop_edge_np * _NSB + self._hop_size_bucket_np,
                    torch.int64,
                ),
                req_size=t(c.hop_request_size, F32),
                # (svc, code) slot of a hop that returned 200, and the
                # first duration bucket of it (code 500 adds _NB)
                dur_base=t(hs * 2 * _NB, torch.int32),
                resp_slot=t(
                    hs * 2 * _NSB + self._svc_resp_bucket_np[hs],
                    torch.int64,
                ),
                resp_size=t(self._svc_resp_size_np[hs], F32),
                edges=t(DURATION_BUCKETS, F32),
            )
        return self._tables[dev]

    # -- device-side collection -----------------------------------------

    def zeros(self, device="cpu") -> ServiceMetrics:
        """An all-zero ServiceMetrics with this topology's shapes — the
        identity of the ``+`` merge."""
        S, E = self.compiled.num_services, len(self.edges)

        def z(*shape):
            return torch.zeros(shape, dtype=F32, device=device)

        return ServiceMetrics(
            incoming_total=z(S),
            outgoing_total=z(E),
            outgoing_size_hist=z(E, _NSB),
            outgoing_size_sum=z(E),
            duration_hist=z(S, 2, _NB),
            duration_sum=z(S, 2),
            response_size_hist=z(S, 2, _NSB),
            response_size_sum=z(S, 2),
        )

    def collect(self, res) -> ServiceMetrics:
        """One block's series, on the device of ``res``."""
        S, E = self.compiled.num_services, len(self.edges)
        sent = res.hop_sent
        dev = sent.device
        tb = self._device_tables(dev)
        err = res.hop_error  # already False where not sent

        # per-hop counts by code, exact integers
        n_all = sent.sum(0)
        n_err = err.sum(0)
        n_ok = n_all - n_err
        by_code = torch.stack([n_ok, n_err], 1)  # (H, 2)

        def scatter(size, index, values):
            return torch.zeros(
                size, dtype=values.dtype, device=dev
            ).index_add_(0, index, values)

        incoming = scatter(S, tb["hop_service"], n_all)
        outgoing = scatter(E, tb["hop_edge"], n_all)
        out_size = scatter(E * _NSB, tb["out_size_slot"], n_all)
        out_size_sum = scatter(E, tb["hop_edge"], n_all.to(F32) * tb["req_size"])

        # duration histogram: every sent hop into (svc, code, bucket);
        # the bucket counts the edges strictly below the latency, as the
        # reference's ``(lat > edges).sum(-1)``
        bucket = torch.bucketize(res.hop_latency, tb["edges"], right=False)
        slot = tb["dur_base"] + err.to(torch.int32) * _NB + bucket.to(
            torch.int32
        )
        dur_hist = scatter(
            S * 2 * _NB, slot.reshape(-1), sent.reshape(-1).to(torch.int32)
        )
        lat_by_code = torch.stack([
            torch.where(sent & ~err, res.hop_latency, 0.0).sum(0),
            torch.where(err, res.hop_latency, 0.0).sum(0),
        ], 1)
        svc_code = (tb["hop_service"][:, None] * 2
                    + torch.arange(2, device=dev)).reshape(-1)
        dur_sum = scatter(S * 2, svc_code, lat_by_code.reshape(-1))

        code_off = torch.arange(2, device=dev) * _NSB
        resp_hist = scatter(
            S * 2 * _NSB, (tb["resp_slot"][:, None] + code_off).reshape(-1),
            by_code.reshape(-1),
        )
        resp_sum = scatter(
            S * 2, svc_code,
            (by_code.to(F32) * tb["resp_size"][:, None]).reshape(-1),
        )
        return ServiceMetrics(
            incoming_total=incoming.to(F32),
            outgoing_total=outgoing.to(F32),
            outgoing_size_hist=out_size.to(F32).reshape(E, _NSB),
            outgoing_size_sum=out_size_sum,
            duration_hist=dur_hist.to(F32).reshape(S, 2, _NB),
            duration_sum=dur_sum.reshape(S, 2),
            response_size_hist=resp_hist.to(F32).reshape(S, 2, _NSB),
            response_size_sum=resp_sum.reshape(S, 2),
        )

    # -- host-side exposition ----------------------------------------------

    def full_text(self, summary) -> str:
        """The complete exposition for a run summary: the five service
        series plus the sim-side resource series — what a scraper (and
        the alarm queries) should see.  A summary without collector
        metrics renders the resource series only."""
        if summary.metrics is None:
            return self.resource_text(
                None, summary.utilization, float(summary.end_max)
            )
        return self.to_text(summary.metrics) + self.resource_text(
            summary.metrics, summary.utilization, float(summary.end_max)
        )

    def resource_text(self, m, utilization, duration_s: float) -> str:
        """Render the sim-side resource series — the counterpart of the
        cadvisor metrics the reference's analysis queries
        (prom.py:116-126: ``container_cpu_usage_seconds_total``,
        ``container_memory_usage_bytes``):

        - ``service_cpu_usage_seconds_total``: CPU-seconds consumed per
          service over the run = utilization x replicas x duration;
        - ``service_memory_working_set_bytes``: Little's-law resident
          payload estimate — in-flight requests (arrival rate x mean
          sojourn) each holding request + response buffers.
        """
        names = self.compiled.services.names
        reps = np.asarray(self.compiled.services.replicas, np.float64)
        util = np.asarray(_np(utilization), np.float64)
        cpu_s = util * reps * float(duration_s)

        if m is None:
            # no collector series: the memory estimate's rate/latency
            # inputs are unavailable
            rate = np.zeros(len(names))
            mean_lat = np.zeros(len(names))
        else:
            inc = np.asarray(_np(m.incoming_total), np.float64)
            lat_sum = np.asarray(_np(m.duration_sum), np.float64).sum(1)
            rate = (
                inc / duration_s if duration_s > 0
                else np.zeros_like(inc)
            )
            mean_lat = np.where(
                inc > 0, lat_sum / np.maximum(inc, 1.0), 0.0
            )
        # mean request payload arriving at each service (static per hop)
        req_sum = np.zeros(len(names))
        req_cnt = np.zeros(len(names))
        np.add.at(req_sum, self.compiled.hop_service,
                  self.compiled.hop_request_size)
        np.add.at(req_cnt, self.compiled.hop_service, 1.0)
        payload = (
            self.compiled.services.response_size.astype(np.float64)
            + req_sum / np.maximum(req_cnt, 1.0)
        )
        mem = rate * mean_lat * payload

        out: List[str] = []
        out.append(
            "# HELP service_cpu_usage_seconds_total Simulated CPU seconds"
            " consumed by this service."
        )
        out.append("# TYPE service_cpu_usage_seconds_total counter")
        for s, name in enumerate(names):
            out.append(
                f'service_cpu_usage_seconds_total{{service="{name}"}}'
                f" {cpu_s[s]:.10g}"
            )
        out.append(
            "# HELP service_memory_working_set_bytes Estimated resident"
            " payload bytes held by in-flight requests."
        )
        out.append("# TYPE service_memory_working_set_bytes gauge")
        for s, name in enumerate(names):
            out.append(
                f'service_memory_working_set_bytes{{service="{name}"}}'
                f" {mem[s]:.10g}"
            )
        return "\n".join(out) + "\n"

    def to_text(self, m: ServiceMetrics) -> str:
        """Render the Prometheus text exposition format."""
        names = self.compiled.services.names

        def ename(i: int) -> str:
            return CLIENT_NAME if i < 0 else names[i]

        out: List[str] = []

        out.append(
            "# HELP service_incoming_requests_total Number of requests sent"
            " to this service."
        )
        out.append("# TYPE service_incoming_requests_total counter")
        inc = _np(m.incoming_total)
        for s, name in enumerate(names):
            out.append(
                f'service_incoming_requests_total{{service="{name}"}}'
                f" {inc[s]:.10g}"
            )

        out.append(
            "# HELP service_outgoing_requests_total Number of requests sent"
            " from this service."
        )
        out.append("# TYPE service_outgoing_requests_total counter")
        outc = _np(m.outgoing_total)
        for e, (src, dst) in enumerate(self.edges):
            out.append(
                "service_outgoing_requests_total{"
                f'service="{ename(src)}",destination_service="{ename(dst)}"'
                f"}} {outc[e]:.10g}"
            )

        self._histogram(
            out,
            "service_outgoing_request_size",
            "Size in bytes of requests sent from this service.",
            SIZE_BUCKETS,
            _np(m.outgoing_size_hist),
            _np(m.outgoing_size_sum),
            [
                (
                    f'service="{ename(src)}",'
                    f'destination_service="{ename(dst)}"'
                )
                for src, dst in self.edges
            ],
        )

        labels, rows, sums = self._by_code(
            names, _np(m.duration_hist), _np(m.duration_sum)
        )
        self._histogram(
            out,
            "service_request_duration_seconds",
            "Duration in seconds it took to serve requests to this service.",
            DURATION_BUCKETS,
            rows,
            sums,
            labels,
        )

        labels, rows, sums = self._by_code(
            names, _np(m.response_size_hist), _np(m.response_size_sum)
        )
        self._histogram(
            out,
            "service_response_size",
            "Size in bytes of responses sent from this service.",
            SIZE_BUCKETS,
            rows,
            sums,
            labels,
        )
        return "\n".join(out) + "\n"

    @staticmethod
    def _by_code(names, hist, sums):
        labels, rows, row_sums = [], [], []
        for s, name in enumerate(names):
            for ci, code in enumerate(("200", "500")):
                labels.append(f'service="{name}",code="{code}"')
                rows.append(hist[s, ci])
                row_sums.append(sums[s, ci])
        return labels, np.asarray(rows), np.asarray(row_sums)

    @staticmethod
    def _histogram(out, name, help_text, buckets, rows, sums, labels):
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} histogram")
        rows = np.asarray(rows)
        for row, s, label in zip(rows, np.asarray(sums), labels):
            cum = np.cumsum(row)
            for le, c in zip(buckets, cum[:-1]):
                out.append(f'{name}_bucket{{{label},le="{le:g}"}} {c:.10g}')
            out.append(f'{name}_bucket{{{label},le="+Inf"}} {cum[-1]:.10g}')
            out.append(f"{name}_sum{{{label}}} {s:.10g}")
            out.append(f"{name}_count{{{label}}} {cum[-1]:.10g}")
