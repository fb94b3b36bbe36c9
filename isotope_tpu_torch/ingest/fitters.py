"""Fitters: Observation IR -> topology YAML + experiment TOML.

The estimators invert the engine's forward model
(PAPER.md service semantics; sim/engine.py):

- **station CPU**: ``service_cpu_usage_seconds_total`` counts station
  CPU only (utilization x replicas x duration), so
  ``cpu_seconds / incoming`` is the per-request ``cpu_time`` exactly;
  the global ``[sim] cpu_time`` is the median across services.
- **self-time / sleep**: with the timeline's occupancy gauges,
  per-request busy time (occupancy over [start+wait, end)) decomposes
  as ``busy = cpu_time + sleeps + sum_children r * (sojourn(child) +
  wire)`` — the fitted sleep is the residual after subtracting station
  CPU and downstream segments, wire estimated from NetworkModel's
  defaults (2 x 250us + bytes / 1.25 GB/s).  CSV traces with span ids
  skip the inversion: self-time is measured directly as rt minus the
  union of child span intervals.
- **fan-out**: the engine skips a service's calls when its own error
  coin fires, so the observed edge ratio under-counts by the caller's
  error share; the corrected ratio is ``edges / incoming / (1 - p)``.
  Integer part -> repeated calls, fractional part -> one
  ``probability`` call (the script grammar's int-percent knob).
- **errorRate**: without timeouts/retries a service's 500s are its own
  error coin only, so the observed per-service 500 share IS the
  intrinsic rate — no deconvolution needed.
- **qps schedule**: first differences of the cumulative
  ``timeline_client_requests_total`` counter (or CSV arrival
  bucketing); ``[client] qps`` is the mean (a TOML list would decode
  as a sweep grid, not a schedule), the full windowed schedule rides
  in the ``isotope-ingest/v1`` report and an informational
  ``[ingest]`` TOML table (load_toml ignores unknown tables).

Everything dropped — unreachable services, cycle-closing edges,
zero-ratio edges, empty lead/tail windows — lands in
``FitResult.dropped`` with a reason, never on the floor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

from isotope_tpu_torch.ingest.readers import CLIENT_ALIASES, Observation
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim.config import DEFAULT_CPU_TIME_S, NetworkModel

# log-bucket histogram bounds for the fitted self-time distribution:
# powers of ~2 from 10us to ~10s (engine sleep model is a point sleep;
# the histogram records the observed spread the point estimate loses)
_LOG_BUCKETS_S: Tuple[float, ...] = tuple(
    1e-5 * (2.0 ** k) for k in range(21)
)


def _median(xs: List[float]) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    n = len(xs)
    if n % 2:
        return xs[n // 2]
    return 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _fmt_us(seconds: float) -> str:
    return f"{int(round(seconds * 1e6))}us"


def log_bucket_hist(samples: List[float]) -> List[List[float]]:
    """[[upper_bound_s, count], ...] over the fixed log-bucket grid;
    only non-empty buckets are emitted (+Inf bound as the last catch-
    all when needed)."""
    counts = [0] * (len(_LOG_BUCKETS_S) + 1)
    for x in samples:
        for i, b in enumerate(_LOG_BUCKETS_S):
            if x <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    out: List[List[float]] = []
    for i, c in enumerate(counts[:-1]):
        if c:
            out.append([_LOG_BUCKETS_S[i], c])
    if counts[-1]:
        out.append([math.inf, counts[-1]])
    return out


@dataclasses.dataclass
class FitOptions:
    label: str = "ingested"
    entry: Optional[str] = None
    # fallback observation duration (needed for rate fits when the
    # inputs carry no timestamps, e.g. Envoy stats)
    duration_s: Optional[float] = None
    window_s: float = 1.0
    cpu_time_s: Optional[float] = None  # override the station estimate
    connections: int = 64
    seed: int = 0
    max_calls_per_edge: int = 64
    # sleeps below this floor are measurement noise, not structure
    min_sleep_s: float = 1e-5


@dataclasses.dataclass
class FittedService:
    name: str
    incoming: float = 0.0
    error_rate: float = 0.0
    station_cpu_s: Optional[float] = None
    self_time_s: float = 0.0       # cpu + sleep point estimate
    sleep_s: float = 0.0
    sojourn_s: Optional[float] = None
    response_size: Optional[int] = None
    replicas: int = 1
    out_degree: int = 0
    concurrent: bool = False
    samples: float = 0.0           # observations backing the fit
    self_hist: List[List[float]] = dataclasses.field(
        default_factory=list
    )
    flags: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FitResult:
    label: str
    entry: str
    topology_doc: dict
    graph: ServiceGraph
    toml_text: str
    services: Dict[str, FittedService]
    # (caller, callee) -> corrected call ratio actually emitted
    edges: Dict[Tuple[str, str], float]
    qps_schedule: List[float]
    qps_mean: float
    window_s: float
    duration_s: float
    cpu_time_s: float
    dropped: Dict[str, List[dict]]
    notes: List[str]


def fit(obs: Observation, opts: Optional[FitOptions] = None) -> FitResult:
    opts = opts or FitOptions()
    notes: List[str] = list(obs.notes)
    dropped: Dict[str, List[dict]] = {
        "services": [], "edges": [], "windows": [],
    }
    clients = set(CLIENT_ALIASES) | set(obs.clients_seen)

    # -- per-service totals (with fallbacks) --
    incoming: Dict[str, float] = {}
    for name, s in obs.services.items():
        if name in clients:
            continue
        inc = s.incoming or s.latency_count or sum(
            c for (src, dst), c in obs.edges.items() if dst == name
        )
        incoming[name] = inc
    # callers that only ever appear as edge sources still need a node
    for (src, dst) in obs.edges:
        if src not in clients and src not in incoming:
            incoming[src] = 0.0
        if dst not in clients and dst not in incoming:
            incoming[dst] = obs.edges[(src, dst)]

    err_rate = {
        n: (obs.services[n].errors / incoming[n]
            if n in obs.services and incoming[n] > 0 else 0.0)
        for n in incoming
    }

    # -- edges: split client vs service, correct for error skipping --
    entry_votes: Dict[str, float] = {}
    svc_edges: Dict[Tuple[str, str], float] = {}
    for (src, dst), c in obs.edges.items():
        if dst in clients:
            dropped["edges"].append({
                "edge": [src, dst], "count": c,
                "reason": "destination is an external client",
            })
            continue
        if src in clients:
            entry_votes[dst] = entry_votes.get(dst, 0.0) + c
        elif src == dst:
            dropped["edges"].append({
                "edge": [src, dst], "count": c,
                "reason": "self-call not expressible in the script grammar",
            })
        else:
            svc_edges[(src, dst)] = c

    ratios: Dict[Tuple[str, str], float] = {}
    for (src, dst), c in svc_edges.items():
        inc = incoming.get(src, 0.0)
        if inc <= 0:
            dropped["edges"].append({
                "edge": [src, dst], "count": c,
                "reason": f"caller {src!r} has zero observed arrivals",
            })
            continue
        p = min(err_rate.get(src, 0.0), 0.95)
        ratios[(src, dst)] = (c / inc) / (1.0 - p)

    # -- entrypoint --
    if opts.entry:
        entry = opts.entry
        if entry not in incoming:
            raise ValueError(
                f"--entry {entry!r} not among observed services"
            )
    elif entry_votes:
        entry = max(sorted(entry_votes), key=lambda k: entry_votes[k])
    else:
        called = {dst for (_, dst) in ratios}
        roots = [n for n in incoming if n not in called]
        if not roots:
            roots = list(incoming)
        if not roots:
            raise ValueError("no services observed: nothing to fit")
        entry = max(sorted(roots), key=lambda n: incoming[n])
        notes.append(
            f"no external-client edges: entrypoint inferred as {entry!r}"
            " (max-arrival root)"
        )

    # -- reachability + cycle breaking (DFS from entry) --
    out_adj: Dict[str, List[str]] = {}
    for (src, dst) in sorted(ratios):
        out_adj.setdefault(src, []).append(dst)
    kept_edges: Dict[Tuple[str, str], float] = {}
    state: Dict[str, int] = {}  # 1=on stack, 2=done
    # iterative DFS (CSV chains can exceed the recursion limit): each
    # stack frame is (node, iterator over its sorted out-neighbors)
    state[entry] = 1
    stack: List[Tuple[str, int]] = [(entry, 0)]
    while stack:
        node, i = stack.pop()
        kids = out_adj.get(node, [])
        advanced = False
        while i < len(kids):
            dst = kids[i]
            i += 1
            if state.get(dst) == 1:
                dropped["edges"].append({
                    "edge": [node, dst], "count": svc_edges[(node, dst)],
                    "reason": "breaks a call-graph cycle "
                              "(engine unrolls acyclic graphs only)",
                })
                continue
            kept_edges[(node, dst)] = ratios[(node, dst)]
            if state.get(dst) != 2:
                stack.append((node, i))
                state[dst] = 1
                stack.append((dst, 0))
                advanced = True
                break
        if not advanced:
            state[node] = 2
    reachable = set(state)
    for n in sorted(incoming):
        if n not in reachable:
            dropped["services"].append({
                "service": n, "incoming": incoming[n],
                "reason": "unreachable from fitted entrypoint",
            })
    for (src, dst), c in sorted(svc_edges.items()):
        if (src, dst) in ratios and (src, dst) not in kept_edges and (
            src not in reachable or dst not in reachable
        ):
            dropped["edges"].append({
                "edge": [src, dst], "count": c,
                "reason": "endpoint unreachable from fitted entrypoint",
            })

    # -- global station cpu_time --
    cpu_samples = [
        obs.services[n].cpu_seconds / incoming[n]
        for n in sorted(reachable)
        if n in obs.services
        and obs.services[n].cpu_seconds is not None
        and incoming[n] > 0
    ]
    if opts.cpu_time_s is not None:
        cpu_time = opts.cpu_time_s
    else:
        cpu_time = _median(cpu_samples) or DEFAULT_CPU_TIME_S
        if not cpu_samples:
            notes.append(
                "no service_cpu_usage_seconds_total observed: "
                f"[sim] cpu_time defaulted to {_fmt_us(DEFAULT_CPU_TIME_S)}"
            )

    # -- per-service timing decomposition --
    net = NetworkModel()
    fitted: Dict[str, FittedService] = {}

    def sojourn_mean(n: str) -> Optional[float]:
        s = obs.services.get(n)
        if s is None:
            return None
        if s.sojourn_seconds is not None and incoming[n] > 0:
            return s.sojourn_seconds / incoming[n]
        if s.latency_count > 0:
            return s.latency_sum_s / s.latency_count
        return None

    def edge_req_size(src: str, dst: str) -> Optional[int]:
        cnt = obs.edge_size_count.get((src, dst), 0.0)
        if cnt > 0:
            return int(round(obs.edge_size_sum[(src, dst)] / cnt))
        return None

    for n in sorted(reachable):
        s = obs.services.get(n)
        f = FittedService(name=n, incoming=incoming[n])
        f.error_rate = round(err_rate.get(n, 0.0), 6)
        f.samples = incoming[n]
        if s is not None and s.cpu_seconds is not None and incoming[n] > 0:
            f.station_cpu_s = s.cpu_seconds / incoming[n]
        f.sojourn_s = sojourn_mean(n)
        if s is not None and s.response_size_count > 0:
            f.response_size = int(
                round(s.response_size_sum / s.response_size_count)
            )
        if s is not None and s.replicas_hint is not None:
            f.replicas = max(1, int(round(s.replicas_hint)))

        children = [
            (dst, r) for (src, dst), r in kept_edges.items() if src == n
        ]
        downstream = 0.0
        for dst, r in children:
            child_sojourn = sojourn_mean(dst) or 0.0
            req = edge_req_size(n, dst) or 0
            resp = (
                obs.services[dst].response_size_sum
                / obs.services[dst].response_size_count
                if dst in obs.services
                and obs.services[dst].response_size_count > 0
                else 0.0
            )
            wire = 2.0 * net.base_latency_s + (req + resp) / (
                net.bytes_per_second
            )
            downstream += r * (child_sojourn + wire)

        if s is not None and s.self_time_count > 0:
            # CSV span decomposition: direct measurement
            f.self_time_s = s.self_time_sum_s / s.self_time_count
            f.self_hist = log_bucket_hist(s.self_time_samples)
        elif s is not None and s.busy_seconds is not None and (
            incoming[n] > 0
        ):
            busy = s.busy_seconds / incoming[n]
            f.self_time_s = max(busy - downstream, 0.0)
        elif f.sojourn_s is not None:
            f.self_time_s = max(f.sojourn_s - downstream, 0.0)
            f.flags.append(
                "self-time from sojourn (no busy/occupancy data): "
                "queueing wait folds into the fitted sleep"
            )
        else:
            f.self_time_s = 0.0
        station = f.station_cpu_s if f.station_cpu_s is not None else (
            cpu_time
        )
        f.sleep_s = max(f.self_time_s - station, 0.0)
        if f.sleep_s < opts.min_sleep_s:
            f.sleep_s = 0.0
        # provisional: re-set to the emitted call-command count below
        # (repeated calls count once per command, matching a source
        # script's flattened degree)
        f.out_degree = len(children)
        f.concurrent = n in obs.concurrent_callers and len(children) > 1
        if f.samples <= 0:
            f.flags.append("zero observed samples (degenerate fit)")
        fitted[n] = f

    # -- qps schedule --
    window_s = obs.window_s or opts.window_s
    schedule: List[float] = []
    if obs.client_windows:
        arr = list(obs.client_windows)
        lead = 0
        while arr and arr[0] == 0.0:
            dropped["windows"].append({
                "index": lead, "reason": "empty leading window",
            })
            arr.pop(0)
            lead += 1
        tail_idx = lead + len(arr) - 1
        while arr and arr[-1] == 0.0:
            dropped["windows"].append({
                "index": tail_idx, "reason": "empty trailing window",
            })
            arr.pop()
            tail_idx -= 1
        schedule = [a / window_s for a in arr]
    if schedule:
        qps_mean = sum(schedule) / len(schedule)
        duration_s = opts.duration_s or len(schedule) * window_s
    else:
        entry_total = sum(entry_votes.values()) or incoming.get(
            entry, 0.0
        )
        if opts.duration_s:
            duration_s = opts.duration_s
            qps_mean = entry_total / duration_s
            schedule = [qps_mean]
            window_s = duration_s
            notes.append(
                "no timestamped windows: flat schedule from totals "
                "over --duration"
            )
        else:
            duration_s = 60.0
            qps_mean = 100.0
            schedule = [qps_mean]
            window_s = duration_s
            notes.append(
                "no timestamps and no --duration: qps defaulted to "
                "100 over 60s (UNCALIBRATED — pass --duration)"
            )

    # -- topology YAML doc --
    resp_sizes = [
        f.response_size for f in fitted.values()
        if f.response_size is not None
    ]
    req_sizes = [
        edge_req_size(src, dst) for (src, dst) in kept_edges
        if edge_req_size(src, dst) is not None
    ]
    default_resp = _median([float(x) for x in resp_sizes])
    default_req = _median([float(x) for x in req_sizes])
    defaults: dict = {"type": "http"}
    if default_resp is not None:
        defaults["responseSize"] = int(default_resp)
    if default_req is not None:
        defaults["requestSize"] = int(default_req)

    services_out: List[dict] = []
    zero_edges: Set[Tuple[str, str]] = set()
    for n in sorted(reachable, key=lambda x: (x != entry, x)):
        f = fitted[n]
        doc: dict = {"name": n}
        if n == entry:
            doc["isEntrypoint"] = True
        if f.error_rate >= 1e-6:
            doc["errorRate"] = f.error_rate
        if f.response_size is not None and (
            default_resp is None or f.response_size != int(default_resp)
        ):
            doc["responseSize"] = f.response_size
        if f.replicas > 1:
            doc["numReplicas"] = f.replicas
        script: List = []
        if f.sleep_s > 0:
            script.append({"sleep": _fmt_us(f.sleep_s)})
        calls: List[dict] = []
        for (src, dst), r in sorted(kept_edges.items()):
            if src != n:
                continue
            k = int(math.floor(r + 1e-9))
            frac = r - k
            if frac >= 0.95:
                k, frac = k + 1, 0.0
            elif frac <= 0.05:
                frac = 0.0
            if k > opts.max_calls_per_edge:
                f.flags.append(
                    f"call ratio to {dst!r} capped at "
                    f"{opts.max_calls_per_edge} (fitted {r:.1f})"
                )
                k = opts.max_calls_per_edge
                frac = 0.0
            if k == 0 and frac == 0.0:
                dropped["edges"].append({
                    "edge": [src, dst],
                    "count": svc_edges.get((src, dst), 0.0),
                    "reason": f"fitted ratio {r:.4f} rounds to zero",
                })
                zero_edges.add((src, dst))
                continue
            size = edge_req_size(src, dst)
            base: dict = {"service": dst}
            if size is not None and (
                default_req is None or size != int(default_req)
            ):
                base["size"] = size
            for _i in range(k):
                calls.append({"call": dict(base) if len(base) > 1 else dst})
            if frac > 0.0:
                prob = min(max(int(round(frac * 100)), 1), 99)
                calls.append({"call": {**base, "probability": prob}})
        f.out_degree = len(calls)
        if calls:
            if f.concurrent:
                script.append([dict(c) for c in calls])
            else:
                script.extend(calls)
        if script:
            doc["script"] = script
        services_out.append(doc)

    for e in zero_edges:
        kept_edges.pop(e, None)

    topo_doc = {"defaults": defaults, "services": services_out}
    graph = ServiceGraph.decode(topo_doc)  # validation gate

    # -- experiment TOML --
    toml_text = _emit_toml(
        opts, entry, cpu_time, qps_mean, duration_s, window_s, schedule,
    )

    return FitResult(
        label=opts.label,
        entry=entry,
        topology_doc=topo_doc,
        graph=graph,
        toml_text=toml_text,
        services=fitted,
        edges=dict(kept_edges),
        qps_schedule=schedule,
        qps_mean=qps_mean,
        window_s=window_s,
        duration_s=duration_s,
        cpu_time_s=cpu_time,
        dropped=dropped,
        notes=notes,
    )


def _fmt_duration(seconds: float) -> str:
    if seconds >= 1.0 and abs(seconds - round(seconds)) < 1e-9:
        return f"{int(round(seconds))}s"
    return _fmt_us(seconds)


def _emit_toml(
    opts: FitOptions,
    entry: str,
    cpu_time: float,
    qps_mean: float,
    duration_s: float,
    window_s: float,
    schedule: List[float],
) -> str:
    """The runnable `[client]`/`[sim]` schedule.  `qps` is the schedule
    MEAN — a TOML list would decode as a sweep grid, not a schedule —
    and the full windowed schedule rides in the `[ingest]` table
    (ignored by load_toml) plus the .ingest.json report."""
    lines = [
        f"# generated by `isotope-tpu ingest` — label {opts.label!r}",
        f'topology_paths = ["{opts.label}.yaml"]',
        'environments = ["NONE"]',
        "",
        "[client]",
        f"qps = {qps_mean:.6g}",
        f'duration = "{_fmt_duration(duration_s)}"',
        f"num_concurrent_connections = {opts.connections}",
        'load_kind = "open"',
        "",
        "[sim]",
        f"seed = {opts.seed}",
        f'cpu_time = "{_fmt_us(cpu_time)}"',
        "timeline = true",
        f'timeline_window = "{_fmt_duration(window_s)}"',
        "",
        "# informational: full fitted qps schedule (load_toml ignores",
        "# unknown tables; machine-readable copy in <label>.ingest.json)",
        "[ingest]",
        f'label = "{opts.label}"',
        f'entry = "{entry}"',
        f"windows = {len(schedule)}",
        f"window_s = {window_s:.6g}",
        f"qps_min = {min(schedule):.6g}",
        f"qps_max = {max(schedule):.6g}",
    ]
    return "\n".join(lines) + "\n"
