"""Simulation flight recorder: on-device windowed time series, in torch.

The port of ``isotope_tpu.metrics.timeline``.  Inside the block loop
every hop event is binned into fixed sim-time windows and accumulated
into per-service x per-window series:

- client arrival / completion / error counts and latency sums per
  window, plus a coarse per-window latency histogram
  (``attribution.blame_bucket_index``);
- per-service hop arrivals / completions / errors per window;
- per-service **in-flight** and **busy** occupancy integrals per
  window (exact interval-overlap seconds via a prefix-sum identity — no
  O(N x H x W) tensor ever materializes).

The occupancy integral: for events ``[s_i, e_i)`` truncated to the
horizon ``T = W * dt``, the cumulative busy-seconds before time ``t`` is
``F(t) = sum_i min(t, e_i) - min(t, s_i)``.  With per-window sums of
start/end counts and clamped start/end times, ``F`` at every window
boundary is a cumulative sum —

    F(t) = Esum(<t) - Ssum(<t) + t * (A(<t) - B(<t))

(``A``/``B`` = starts/ends before ``t``) — and the per-window busy
seconds are first differences of ``F``.

Every series is a sum of integers: counts, and event times rounded to
fixed-point multiples of ``TIME_UNIT`` (2^-28 s), binned with
``index_add_`` into int64 bins and turned into seconds at the end
(``bin_sums``).  Integer sums are exact in any order, so the card's
atomic adds, the CPU's loop and every repeat of a run give the same
bits, and the control laws that read them (``sim/policies.py``,
``sim/rollout.py``) take the same decisions; the occupancy differences
are taken in float64.  The reference sums float32 instead (a dense
boundary contraction for W <= 64 windows, a scatter above); the tests
hold the port to both within the float32 error of those sums.
Counts are int32 when ``packed`` (the ``SimParams.packed_carries``
default), as the reference's are; the occupancy integrals and latency
sums are float32.

Not ported: ``merge_host`` (the sharded runs' host merge, ROADMAP item
11).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from isotope_tpu_torch.compiler.program import CompiledGraph
from isotope_tpu_torch.metrics.attribution import (
    NUM_BLAME_BUCKETS,
    blame_bucket_centers,
    blame_bucket_index,
)

F32 = torch.float32

#: soft cap on S x W elements per (S, W) series (the reference's)
ELEM_BUDGET = 2_097_152

class TimelineSummary(NamedTuple):
    """Device-reduced windowed series for one run.

    Window ``w`` covers sim time ``[w * window_s, (w+1) * window_s)``;
    the final window also absorbs any overflow past the planned horizon
    (clamped index), so ``arrivals.sum() == count``.
    """

    window_s: torch.Tensor        # scalar f32 — the window width used
    count: torch.Tensor           # scalar — requests recorded
    arrivals: torch.Tensor        # (W,) client requests by start window
    completions: torch.Tensor     # (W,) client requests by end window
    errors: torch.Tensor          # (W,) client 500s by start window
    latency_sum: torch.Tensor     # (W,) client latency sum by start window
    latency_hist: torch.Tensor    # (W, NUM_BLAME_BUCKETS) coarse log-bucket
    svc_arrivals: torch.Tensor    # (S, W) executed hops by hop start
    svc_completions: torch.Tensor  # (S, W) executed hops by hop end
    svc_errors: torch.Tensor      # (S, W) hop 500s by hop start
    svc_inflight_s: torch.Tensor  # (S, W) occupancy integral [start, end)
    svc_busy_s: torch.Tensor      # (S, W) occupancy integral [start+wait, end)

    @property
    def num_windows(self) -> int:
        return int(self.arrivals.shape[0])


@dataclasses.dataclass(frozen=True)
class TimelineSpec:
    """Static recorder tables: the window grid + the hop -> service map."""

    num_windows: int
    window_s: float
    num_services: int
    hop_service: torch.Tensor     # (H,) int64


def plan_windows(
    expected_duration_s: float,
    window_s: float,
    max_windows: int,
    num_services: int,
    elem_budget: int = ELEM_BUDGET,
    log=None,
) -> Tuple[int, float, bool]:
    """Resolve the static window grid for a run.

    Returns ``(num_windows, effective_window_s, clamped)``.  The window
    count is ``ceil(duration / window_s)`` clamped by ``max_windows``
    AND by the per-series element budget (``S * W <= elem_budget``) —
    when clamped, ``window_s`` widens so the grid still covers the
    expected duration (a warning instead of an out-of-memory)."""
    if window_s <= 0:
        raise ValueError("timeline window_s must be positive")
    duration = max(float(expected_duration_s), window_s)
    want = max(1, int(np.ceil(duration / window_s)))
    cap = max(1, min(int(max_windows), elem_budget // max(num_services, 1)))
    if want <= cap:
        return want, float(window_s), False
    eff = duration / cap
    msg = (
        f"timeline: {want} windows of {window_s:g}s exceed the cap "
        f"({cap}); widening to {cap} windows of {eff:g}s"
    )
    (log or (lambda m: print(m, file=sys.stderr)))(msg)
    return cap, float(eff), True


def build_spec(
    compiled: CompiledGraph, num_windows: int, window_s: float,
    device="cpu",
) -> TimelineSpec:
    return TimelineSpec(
        num_windows=int(num_windows),
        window_s=float(window_s),
        num_services=compiled.num_services,
        hop_service=torch.as_tensor(
            np.asarray(compiled.hop_service), dtype=torch.int64
        ).to(device),
    )


# -- the on-device recorder --------------------------------------------------


def _window_index(spec: TimelineSpec, t: torch.Tensor) -> torch.Tensor:
    """Clamped window index (the final window absorbs overflow)."""
    idx = torch.floor(t * (1.0 / spec.window_s)).to(torch.int64)
    return torch.clamp(idx, 0, spec.num_windows - 1)


#: fixed-point unit of the recorder's time sums: each event time (or
#: latency) in seconds is rounded to a multiple of 2^-28 s (3.7e-9 s)
#: and summed as an int64, exactly and so in any order; 2^35 s of
#: summed time fit a bin
TIME_UNIT = 2.0 ** -28


def fixed_point(t: torch.Tensor) -> torch.Tensor:
    """``t`` (seconds) as int64 multiples of ``TIME_UNIT``."""
    return torch.round(t.to(torch.float64) * (1.0 / TIME_UNIT)).to(
        torch.int64
    )


def bin_sums(idx: torch.Tensor, vals: Sequence[torch.Tensor], bins: int
             ) -> torch.Tensor:
    """(bins, V) int64 sums of the int64 channels ``vals`` (each shaped
    like ``idx``) by bin ``idx``.  Integer sums are exact whatever the
    order of their additions, so the card (atomic adds) and the CPU
    give the same bits from run to run: the control laws that read them
    (``sim/policies.py``, ``sim/rollout.py``) take the same decisions."""
    flat = idx.reshape(-1)
    return torch.stack([
        torch.zeros(bins, dtype=torch.int64, device=flat.device)
        .index_add_(0, flat, v.reshape(-1))
        for v in vals
    ], dim=-1)


def _service_window_bins(
    spec: TimelineSpec,
    t: torch.Tensor,             # (N, H) f32 — clamped event times, [0, T]
    vals: Sequence[torch.Tensor],  # V int64 channels (N, H) to window-sum
    groups: Optional[torch.Tensor] = None,  # (N, H) int — extra axis
    num_groups: int = 1,
) -> torch.Tensor:
    """(S, G, W, V) int64 per-service (per-group) window sums of one
    time family; ``groups`` splits each service's events along an extra
    axis of ``num_groups`` (the rollouts' version coin)."""
    W = spec.num_windows
    S = spec.num_services
    key = spec.hop_service[None, :].expand(t.shape)
    if groups is not None:
        key = key * num_groups + groups
    key = key * W + _window_index(spec, t)
    return bin_sums(key, vals, S * num_groups * W).reshape(
        S, num_groups, W, len(vals)
    )


def _service_boundary_prefixes(
    spec: TimelineSpec,
    t: torch.Tensor,             # (N, H) f32 — clamped event times, [0, T]
    vals: Sequence[torch.Tensor],  # V int64 channels (N, H) to prefix-sum
) -> torch.Tensor:
    """(S, W+1, V) int64 per-service boundary prefixes of one time
    family: ``out[s, j, v]`` sums ``vals[v]`` over service-``s`` events
    with time before the boundary ``j * window_s`` (column ``W``: the
    family total, the clamped final window included).  Every series the
    recorder reports is a first difference of these prefixes."""
    bins = _service_window_bins(spec, t, vals)[:, 0]  # (S, W, V)
    return torch.nn.functional.pad(torch.cumsum(bins, dim=1), (0, 0, 1, 0))


def versioned_service_windows(
    spec: TimelineSpec,
    t: torch.Tensor,             # (N, H) f32 — clamped event times, [0, T]
    version: torch.Tensor,       # (N, H) bool — per-hop version coin
    vals: Sequence[torch.Tensor],  # V int64 channels (N, H) to window-sum
) -> torch.Tensor:
    """(S, 2, W, V) int64 per-service, per-VERSION window sums of one
    time family — the recorder's (S, W) observation channel extended
    along a two-arm deployment axis (axis 1: 0 = baseline, 1 = canary);
    additive across blocks like every recorder series."""
    return _service_window_bins(
        spec, t, vals, groups=version.to(torch.int64), num_groups=2
    )


def _count_dtype(packed: bool):
    return torch.int32 if packed else F32


def timeline_block(
    res, spec: TimelineSpec, packed: bool = False
) -> TimelineSummary:
    """Reduce one block's SimResults to a TimelineSummary (the block's
    clocks are absolute sim time, so windows align across blocks).

    ``packed`` (SimParams.packed_carries) accumulates the COUNT series
    as int32 (exact past 2^24 where f32 loses integers); the occupancy
    integrals stay f32.
    """
    if res.hop_wait is None:
        raise ValueError(
            "timeline needs SimResults.hop_wait (produced by Simulator "
            "runs with SimParams.timeline=True; synthetic SimResults "
            "must fill it)"
        )
    dev = res.client_latency.device
    n = res.client_latency.shape[0]
    W = spec.num_windows
    cd = _count_dtype(packed)
    i64 = torch.int64

    # -- client-level series --------------------------------------------
    start_w = _window_index(spec, res.client_start)
    ones = torch.ones(n, dtype=i64, device=dev)
    by_start = bin_sums(start_w, (
        ones, res.client_error.to(i64), fixed_point(res.client_latency),
    ), W)
    completions = bin_sums(_window_index(spec, res.client_end), (ones,),
                           W)[:, 0]
    hist_idx = start_w * NUM_BLAME_BUCKETS + blame_bucket_index(
        torch.clamp(res.client_latency, min=0.0)
    )
    hist = bin_sums(hist_idx, (ones,), W * NUM_BLAME_BUCKETS).reshape(
        W, NUM_BLAME_BUCKETS
    )

    # -- per-service series ---------------------------------------------
    # Three time families (hop start, hop end, busy start = start +
    # queueing wait), each reduced to per-service boundary prefixes of
    # exact integer sums; every reported series is a first difference of
    # those (module docstring's occupancy identity), taken in float64.
    dt = spec.window_s
    T = W * dt
    sent = res.hop_sent.to(i64)
    s_c = torch.clamp(res.hop_start, 0.0, T)
    e_c = torch.clamp(torch.maximum(res.hop_start + res.hop_latency, s_c),
                      max=T)
    b_c = torch.minimum(torch.maximum(res.hop_start + res.hop_wait, s_c),
                        e_c)
    p_start = _service_boundary_prefixes(spec, s_c, (
        sent, sent * fixed_point(s_c), (res.hop_sent & res.hop_error).to(i64),
    ))
    p_end = _service_boundary_prefixes(spec, e_c,
                                       (sent, sent * fixed_point(e_c)))
    p_busy = _service_boundary_prefixes(spec, b_c,
                                        (sent, sent * fixed_point(b_c)))
    a_pref, ssum = p_start[..., 0], p_start[..., 1]
    err_pref = p_start[..., 2]
    b_pref, esum = p_end[..., 0], p_end[..., 1]
    ab_pref, bsum = p_busy[..., 0], p_busy[..., 1]

    def diff(x):
        return x[:, 1:] - x[:, :-1]

    def seconds(x):
        return x.to(torch.float64) * TIME_UNIT

    bounds = (torch.arange(W + 1, dtype=F32, device=dev) * dt).to(
        torch.float64
    )[None, :]
    inflight = diff(
        seconds(esum - ssum) + bounds * (a_pref - b_pref).to(torch.float64)
    )
    busy = diff(
        seconds(esum - bsum) + bounds * (ab_pref - b_pref).to(torch.float64)
    )
    return TimelineSummary(
        window_s=torch.full((), spec.window_s, dtype=F32, device=dev),
        count=torch.full((), n, dtype=cd, device=dev),
        arrivals=by_start[:, 0].to(cd),
        completions=completions.to(cd),
        errors=by_start[:, 1].to(cd),
        latency_sum=seconds(by_start[:, 2]).to(F32),
        latency_hist=hist.to(cd),
        svc_arrivals=diff(a_pref).to(cd),
        svc_completions=diff(b_pref).to(cd),
        svc_errors=diff(err_pref).to(cd),
        svc_inflight_s=inflight.to(F32),
        svc_busy_s=busy.to(F32),
    )


def zeros_summary(spec: TimelineSpec, packed: bool = False,
                  device="cpu") -> TimelineSummary:
    """An all-zero TimelineSummary shaped for ``spec``: the block loop's
    accumulator, so memory stays O(S x W) whatever the block count."""
    W = spec.num_windows
    S = spec.num_services
    cd = _count_dtype(packed)

    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TimelineSummary(
        window_s=torch.full((), spec.window_s, dtype=F32, device=device),
        count=torch.zeros((), dtype=cd, device=device),
        arrivals=z(W, dtype=cd),
        completions=z(W, dtype=cd),
        errors=z(W, dtype=cd),
        latency_sum=z(W),
        latency_hist=z(W, NUM_BLAME_BUCKETS, dtype=cd),
        svc_arrivals=z(S, W, dtype=cd),
        svc_completions=z(S, W, dtype=cd),
        svc_errors=z(S, W, dtype=cd),
        svc_inflight_s=z(S, W),
        svc_busy_s=z(S, W),
    )


def accumulate(
    acc: TimelineSummary, block: TimelineSummary
) -> TimelineSummary:
    """Fold one block's summary into the accumulator (element sums;
    ``window_s`` is an identical constant, kept)."""
    return TimelineSummary(
        acc.window_s, *(a + b for a, b in zip(acc[1:], block[1:]))
    )


# -- host-side derivations ---------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def window_quantile(tl: TimelineSummary, w: int, q: float) -> float:
    """One window's client-latency quantile off the coarse log-bucket
    histogram (bucket centers)."""
    hist = _np(tl.latency_hist)[w]
    total = hist.sum()
    if total <= 0:
        return 0.0
    idx = int(np.searchsorted(np.cumsum(hist), q * total, side="left"))
    return float(blame_bucket_centers()[min(idx, NUM_BLAME_BUCKETS - 1)])


def leaf_services(compiled: CompiledGraph) -> List[int]:
    """Service ids that never call anyone (no hop of theirs is a
    parent) — the spokes whose joint busy windows a convoy correlates
    with the entry's wait."""
    callers = set()
    parent = compiled.hop_parent
    hs = compiled.hop_service
    for h in range(1, compiled.num_hops):
        callers.add(int(hs[parent[h]]))
    return [s for s in range(compiled.num_services) if s not in callers]


def convoy(compiled: CompiledGraph, tl: TimelineSummary) -> dict:
    """Convoy detector: cross-correlation of the entry's wait share vs
    the leaves' busy share, per window."""
    entry = int(compiled.entry_service)
    leaves = leaf_services(compiled)
    dt = float(tl.window_s)
    inflight = _np(tl.svc_inflight_s)
    busy = _np(tl.svc_busy_s)
    queue = np.maximum(inflight - busy, 0.0)
    reps = np.asarray(compiled.services.replicas, np.float64)

    entry_occ = inflight[entry]
    wait_share = np.where(
        entry_occ > 1e-12, queue[entry] / np.maximum(entry_occ, 1e-12), 0.0
    )
    leaf_cap = max(float(reps[leaves].sum()), 1.0) * dt
    leaf_busy_share = busy[leaves].sum(0) / leaf_cap

    active = entry_occ > 1e-12
    r = 0.0
    if active.sum() >= 3:
        a = wait_share[active]
        b = leaf_busy_share[active]
        if a.std() > 1e-12 and b.std() > 1e-12:
            r = float(np.corrcoef(a, b)[0, 1])
    return {
        "entry": compiled.services.names[entry],
        "num_leaf_services": len(leaves),
        "windows_active": int(active.sum()),
        "entry_wait_share": [round(float(v), 6) for v in wait_share],
        "leaf_busy_share": [
            round(float(v), 6) for v in leaf_busy_share
        ],
        "correlation": round(r, 4),
        "convoy_suspected": bool(r > 0.5 and active.sum() >= 3),
    }


def controlplane_windows(
    ack_times_s: np.ndarray, window_s: float, num_windows: int
) -> dict:
    """Project control-plane convergence events (per-proxy push-ACK
    times, ``sim/controlplane.py``) onto the data-plane window axis, so
    a config-push timeline composes with the recorder's series."""
    acks = np.asarray(ack_times_s, np.float64)
    W = int(num_windows)
    idx = np.clip(
        np.floor(acks / float(window_s)).astype(np.int64), 0, W - 1
    )
    per = np.bincount(idx, minlength=W).astype(np.float64)
    frac = np.cumsum(per) / max(len(acks), 1)
    return {
        "proxies": int(len(acks)),
        "acks": [int(v) for v in per],
        "converged_fraction": [round(float(v), 6) for v in frac],
        "converged_window": (
            int(np.argmax(frac >= 1.0)) if len(acks) else 0
        ),
    }


def to_doc(
    compiled: CompiledGraph,
    tl: TimelineSummary,
    top_services: int = 64,
    controlplane: Optional[dict] = None,
) -> dict:
    """The ``timeline.json`` artifact (``isotope-timeline/v1``):
    per-window client rows, the most-active services' series, and the
    convoy verdict, and the control-plane projection when given."""
    W = tl.num_windows
    dt = float(tl.window_s)
    arr = _np(tl.arrivals)
    comp = _np(tl.completions)
    errs = _np(tl.errors)
    lat = _np(tl.latency_sum)
    windows = []
    for w in range(W):
        a = arr[w]
        windows.append(
            {
                "index": w,
                "t_start_s": round(w * dt, 6),
                "t_end_s": round((w + 1) * dt, 6),
                "arrivals": float(a),
                "completions": float(comp[w]),
                "errors": float(errs[w]),
                "qps": round(a / dt, 4),
                "mean_latency_s": (
                    round(lat[w] / a, 9) if a > 0 else 0.0
                ),
                "p99_s": round(window_quantile(tl, w, 0.99), 9),
            }
        )

    names = compiled.services.names
    reps = np.asarray(compiled.services.replicas, np.float64)
    inflight = _np(tl.svc_inflight_s)
    busy = _np(tl.svc_busy_s)
    queue = np.maximum(inflight - busy, 0.0)
    svc_arr = _np(tl.svc_arrivals)
    svc_err = _np(tl.svc_errors)
    order = np.argsort(-busy.sum(1), kind="stable")
    services: Dict[str, dict] = {}
    for s in order[: top_services or None]:
        s = int(s)
        if svc_arr[s].sum() <= 0 and busy[s].sum() <= 0:
            continue
        util = busy[s] / (dt * max(float(reps[s]), 1.0))
        peak_w = int(np.argmax(util))
        services[names[s]] = {
            "requests": float(svc_arr[s].sum()),
            "errors": float(svc_err[s].sum()),
            "utilization": [round(float(v), 6) for v in util],
            "queue_depth": [
                round(float(v) / dt, 6) for v in queue[s]
            ],
            "in_flight": [
                round(float(v) / dt, 6) for v in inflight[s]
            ],
            "peak_utilization": round(float(util[peak_w]), 6),
            "peak_window": peak_w,
        }
    doc = {
        "schema": "isotope-timeline/v1",
        "window_s": dt,
        "num_windows": W,
        "count": float(tl.count),
        "windows": windows,
        "services": services,
        "services_truncated": max(
            0, compiled.num_services - len(services)
        ),
        "convoy": convoy(compiled, tl),
    }
    if controlplane is not None:
        doc["controlplane"] = controlplane
    return doc


def format_table(doc: dict, top: int = 24) -> str:
    """Human-readable per-window table with a per-service sparkline
    block (the ``timeline`` CLI / ``simulate --timeline`` rendering)."""
    lines = [
        f"timeline: {doc['num_windows']} windows x "
        f"{doc['window_s']:g}s ({doc['count']:.0f} requests)"
    ]
    lines.append(
        f"{'win':>4} {'t (s)':>9} {'qps':>9} {'errors':>7} "
        f"{'mean (ms)':>10} {'p99 (ms)':>9}"
    )
    for row in doc["windows"][:top]:
        lines.append(
            f"{row['index']:>4} {row['t_start_s']:>9.1f} "
            f"{row['qps']:>9.1f} {row['errors']:>7.0f} "
            f"{row['mean_latency_s'] * 1e3:>10.3f} "
            f"{row['p99_s'] * 1e3:>9.3f}"
        )
    if len(doc["windows"]) > top:
        lines.append(f"... {len(doc['windows']) - top} more window(s)")
    for name, svc in list(doc.get("services", {}).items())[:8]:
        lines.append(
            f"{name:<24} util {sparkline(svc['utilization'])} "
            f"peak {svc['peak_utilization']:.2f} "
            f"@w{svc['peak_window']}"
        )
    cv = doc.get("convoy") or {}
    if cv:
        lines.append(
            f"convoy: entry-wait vs leaf-busy correlation "
            f"{cv['correlation']:+.3f}"
            + (" (convoy suspected)" if cv.get("convoy_suspected")
               else "")
        )
    return "\n".join(lines)


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float]) -> str:
    """A unicode sparkline of one windowed series."""
    vs = [float(v) for v in values]
    if not vs:
        return ""
    hi = max(vs)
    if hi <= 0:
        return _SPARK[0] * len(vs)
    return "".join(
        _SPARK[min(int(v / hi * (len(_SPARK) - 1) + 1e-9),
                   len(_SPARK) - 1)]
        for v in vs
    )


# -- Prometheus / monitor surfaces -------------------------------------------


def prometheus_text(compiled: CompiledGraph, tl: TimelineSummary) -> str:
    """Timestamped Prometheus exposition: each window renders as one
    scrape-interval sample (value + ``<timestamp_ms>``) — counters are
    cumulative across windows, gauges are per-window levels."""
    from isotope_tpu_torch.metrics.prometheus import timestamped_series

    names = compiled.services.names
    dt = float(tl.window_s)
    W = tl.num_windows
    ts = [int(round((w + 1) * dt * 1e3)) for w in range(W)]
    out: List[str] = []

    def counter_rows(series_by_label):
        rows = []
        for label, series in series_by_label:
            cum = np.cumsum(_np(series))
            rows.extend(
                (label, float(cum[w]), ts[w]) for w in range(W)
            )
        return rows

    def gauge_rows(series_by_label):
        rows = []
        for label, series in series_by_label:
            rows.extend(
                (label, float(series[w]), ts[w]) for w in range(W)
            )
        return rows

    timestamped_series(
        out, "timeline_client_requests_total",
        "Client requests arriving, cumulative per sim-time window.",
        "counter", counter_rows([({}, tl.arrivals)]),
    )
    timestamped_series(
        out, "timeline_client_errors_total",
        "Client-visible 500s, cumulative per sim-time window.",
        "counter", counter_rows([({}, tl.errors)]),
    )
    svc_arr = _np(tl.svc_arrivals)
    svc_err = _np(tl.svc_errors)
    inflight = _np(tl.svc_inflight_s) / dt
    busy = _np(tl.svc_busy_s)
    queue = np.maximum(_np(tl.svc_inflight_s) - busy, 0.0) / dt
    reps = np.asarray(compiled.services.replicas, np.float64)
    active = [
        s for s in range(compiled.num_services)
        if svc_arr[s].sum() > 0 or busy[s].sum() > 0
    ]
    timestamped_series(
        out, "timeline_service_requests_total",
        "Hops arriving at this service, cumulative per window.",
        "counter",
        counter_rows(
            [({"service": names[s]}, svc_arr[s]) for s in active]
        ),
    )
    timestamped_series(
        out, "timeline_service_errors_total",
        "Hop 500s at this service, cumulative per window.",
        "counter",
        counter_rows(
            [({"service": names[s]}, svc_err[s]) for s in active]
        ),
    )
    timestamped_series(
        out, "timeline_service_inflight",
        "Mean in-flight requests at this service per window.",
        "gauge",
        gauge_rows(
            [({"service": names[s]}, inflight[s]) for s in active]
        ),
    )
    timestamped_series(
        out, "timeline_service_queue_depth",
        "Mean queued (waiting) requests at this service per window.",
        "gauge",
        gauge_rows(
            [({"service": names[s]}, queue[s]) for s in active]
        ),
    )
    timestamped_series(
        out, "timeline_service_utilization",
        "Busy-time utilization of this service per window.",
        "gauge",
        gauge_rows(
            [
                (
                    {"service": names[s]},
                    busy[s] / (dt * max(float(reps[s]), 1.0)),
                )
                for s in active
            ]
        ),
    )
    return "\n".join(out) + ("\n" if out else "")


def window_stores(compiled: CompiledGraph, tl: TimelineSummary):
    """Per-window :class:`~isotope_tpu_torch.metrics.query.MetricStore`s
    — each window rendered as the service series a scraper would have
    seen over that interval, so the alarm queries evaluate per window
    and an SLO breach gets a sim-time ONSET.

    Yields ``(window_index, sim_time_s, store)``; ``sim_time_s`` is the
    window's end (the scrape instant).
    ``service_cpu_usage_seconds_total`` is the BUSY-OCCUPANCY integral
    (server-side time excluding the queueing wait), an upper bound on
    CPU burn.
    """
    from isotope_tpu_torch.metrics.query import MetricStore, Sample

    names = compiled.services.names
    dt = float(tl.window_s)
    svc_arr = _np(tl.svc_arrivals)
    svc_err = _np(tl.svc_errors)
    busy = _np(tl.svc_busy_s)
    inflight = _np(tl.svc_inflight_s)

    # resident payload estimate per in-flight request (the
    # resource_text working-set model, metrics/prometheus.py)
    req_sum = np.zeros(len(names))
    req_cnt = np.zeros(len(names))
    np.add.at(req_sum, compiled.hop_service, compiled.hop_request_size)
    np.add.at(req_cnt, compiled.hop_service, 1.0)
    payload = (
        compiled.services.response_size.astype(np.float64)
        + req_sum / np.maximum(req_cnt, 1.0)
    )

    for w in range(tl.num_windows):
        samples: List[Sample] = []
        for s, name in enumerate(names):
            lbl = {"service": name}
            samples.append(Sample(
                "service_incoming_requests_total", dict(lbl),
                float(svc_arr[s, w]),
            ))
            err = float(svc_err[s, w])
            samples.append(Sample(
                "service_request_duration_seconds_count",
                {"service": name, "code": "500"}, err,
            ))
            samples.append(Sample(
                "service_request_duration_seconds_count",
                {"service": name, "code": "200"},
                max(float(svc_arr[s, w]) - err, 0.0),
            ))
            samples.append(Sample(
                "service_cpu_usage_seconds_total", dict(lbl),
                float(busy[s, w]),
            ))
            samples.append(Sample(
                "service_memory_working_set_bytes", dict(lbl),
                float(inflight[s, w] / dt * payload[s]),
            ))
        yield w, (w + 1) * dt, MetricStore(samples, duration_s=dt)
