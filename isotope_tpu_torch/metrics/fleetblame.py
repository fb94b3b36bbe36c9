"""Fleet divergence explainer: WHY a Monte Carlo member had a bad day.

The port of ``isotope_tpu.metrics.fleetblame``.  An observed fleet
(``Simulator.run_ensemble(attribution=..., timeline=...)`` and the
protected fleets with ``attribution=True``) carries a stacked
:class:`~isotope_tpu_torch.metrics.attribution.AttributionSummary`
(``attributions``, (N,)-leading leaves) and the per-member window
series (``timelines``).  This module turns those stacks into an
explanation:

- **blame-share bands**: per-hop across-member quantile bands of the
  blame share;
- **control deltas**: member k's per-request blame seconds minus the
  control member's, per hop, ranked descending — the hops whose excess
  blame adds up to member k's latency gap;
- **onset localization**: for each member and recorder channel
  (per-service in-flight occupancy, per-service errors), the first
  window where the member departs the across-member per-window median
  by more than ``margin`` robust sigmas (median + MAD).

The reductions run in torch on the fleet's device (:func:`explain_fleet`,
one read-back); medians and quantiles use the reference's linear
interpolation in float32.  The ``isotope-fleet-blame/v1`` document
(:func:`to_doc`) and the ``explain`` narrative (:func:`format_report`)
are the reference's host code.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: artifact schema tag (the runner writes ``<label>.fleet-blame.json``)
DOC_SCHEMA = "isotope-fleet-blame/v1"

#: across-member quantile band reported per hop (lo, mid, hi)
BAND = (0.1, 0.5, 0.9)

#: how many robust sigmas past the member median counts as a departure
ONSET_MARGIN = 4.0

#: recorder channels the onset localizer scans, in report priority
#: order (an error burst outranks an occupancy ramp at the same
#: window).  ``inflight`` is the [start, end) occupancy integral —
#: unlike ``svc_busy_s`` it INCLUDES queueing wait, which is where a
#: capacity loss first shows
ONSET_CHANNELS = ("errors", "inflight")

F32 = torch.float32


def _quantile0(x: torch.Tensor, qs) -> torch.Tensor:
    """Quantiles over axis 0 with the reference's linear interpolation
    (``jnp.quantile``): the sorted values at ``floor`` / ``ceil`` of
    ``q * (n - 1)`` (float32), weighted ``1 - w`` / ``w``; a NaN along
    the axis gives NaN.  Returns (len(qs), *x.shape[1:])."""
    n = x.shape[0]
    xs = torch.sort(x, dim=0).values
    q = torch.tensor(qs, dtype=F32) * float(n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    rows = [
        xs[int(a)] * float(1.0 - w) + xs[int(b)] * float(w)
        for a, b, w in zip(torch.clamp(low, 0, n - 1),
                           torch.clamp(high, 0, n - 1), hw)
    ]
    nan = torch.isnan(x).any(0)
    return torch.where(nan[None], torch.nan, torch.stack(rows))


def _hop_blame(attr) -> torch.Tensor:
    """(N, H) total blame seconds per hop (wait + self + net + timeout)."""
    return (
        attr.wait_blame.to(F32)
        + attr.self_blame.to(F32)
        + attr.net_blame.to(F32)
        + attr.timeout_blame.to(F32)
    )


def _onset_windows(series: torch.Tensor,
                   margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """First departing window per (member, service).

    ``series`` is (N, S, W).  A member departs at window w when its
    value exceeds the across-member per-window median by more than
    ``margin`` robust sigmas (1.4826 * MAD), with a per-service scale
    floor so a near-constant channel's noise never "departs".  Returns
    ``(onset, depth)``: onset (N, S) int32 (-1 when the member never
    departs), depth the departure in robust sigmas."""
    med = _quantile0(series, (0.5,))[0]                   # (S, W)
    mad = _quantile0(torch.abs(series - med[None]), (0.5,))[0]
    floor = 0.02 * torch.amax(med, dim=1, keepdim=True) + 1e-9
    scale = torch.maximum(1.4826 * mad, floor)
    excess = (series - med[None]) / scale[None]          # (N, S, W)
    departed = excess > margin
    W = series.shape[-1]
    idx = torch.arange(W, device=series.device)[None, None, :]
    first = torch.where(
        departed, idx, torch.full_like(idx, W)
    ).amin(-1)                                           # (N, S)
    at = torch.clamp(first, 0, W - 1)
    depth = torch.gather(excess, -1, at[..., None])[..., 0]
    depth = torch.where(first < W, depth, 0.0)
    onset = torch.where(first < W, first, -1).to(torch.int32)
    return onset, depth


def _reduce(attributions, timelines, control: int,
            band: Tuple[float, float, float], margin: float) -> dict:
    """The reductions behind :func:`explain_fleet`."""
    blame = _hop_blame(attributions)                     # (N, H)
    count = torch.clamp(attributions.count.to(F32), min=1.0)  # (N,)
    per_req = blame / count[:, None]
    total = torch.clamp(blame.sum(1), min=1e-12)
    share = blame / total[:, None]
    out = {
        "blame_s": blame,
        "per_request_s": per_req,
        "share": share,
        "share_band": _quantile0(share, band),           # (3, H)
        "delta_per_request_s": per_req - per_req[control][None],
        "mean_latency_gap_s": (
            blame.sum(1) / count - blame[control].sum() / count[control]
        ),
        "error_count": attributions.error_count.to(F32),
    }
    if timelines is not None:
        channels = {
            "inflight": timelines.svc_inflight_s.to(F32),
            "errors": timelines.svc_errors.to(F32),
        }
        for name in ONSET_CHANNELS:
            onset, depth = _onset_windows(channels[name], margin)
            out[f"onset_{name}"] = onset
            out[f"onset_{name}_depth"] = depth
    return out


def explain_fleet(attributions, timelines=None, *, control: int = 0,
                  band: Tuple[float, float, float] = BAND,
                  margin: float = ONSET_MARGIN) -> dict:
    """Run the fleet divergence reductions on the fleet's device and read
    the result back once.  ``attributions`` is the stacked
    ``AttributionSummary`` of an observed fleet, ``timelines`` the
    stacked ``TimelineSummary`` (or None: no onsets).  Returns a dict of
    host numpy arrays."""
    reduced = _reduce(attributions, timelines, int(control), tuple(band),
                      float(margin))
    return {k: v.detach().cpu().numpy() for k, v in reduced.items()}


def to_doc(compiled, attributions, timelines=None, *, label: str = "",
           control: int = 0, severity=None, seeds=None,
           window_s: Optional[float] = None, top_hops: int = 5,
           band: Tuple[float, float, float] = BAND,
           margin: float = ONSET_MARGIN) -> dict:
    """The ``isotope-fleet-blame/v1`` artifact document.

    ``severity`` attaches the fleet's (N,) ranking statistic
    (``EnsembleSummary.severity()``) so the report orders members by
    the same channel the chaos-fleet postmortem uses; without it,
    members rank by their positive blame excess vs the control.
    ``seeds`` stamps each member's RNG identity; ``window_s`` converts
    onset window indices to sim seconds."""
    host = explain_fleet(
        attributions, timelines, control=control, band=band,
        margin=margin,
    )
    share = np.asarray(host["share"], np.float64)        # (N, H)
    delta = np.asarray(host["delta_per_request_s"], np.float64)
    per_req = np.asarray(host["per_request_s"], np.float64)
    blame = np.asarray(host["blame_s"], np.float64)
    errs = np.asarray(host["error_count"], np.float64)
    n_mem, n_hops = share.shape
    hs = np.asarray(compiled.hop_service)
    names = compiled.services.names
    excess = np.clip(delta, 0.0, None).sum(axis=1)       # (N,)
    sev = (
        np.asarray(severity, np.float64)
        if severity is not None else excess
    )
    order = np.argsort(-sev)

    def hop_row(k: int, h: int) -> dict:
        row = {
            "hop": int(h),
            "service": names[int(hs[h])],
            "share": float(share[k, h]),
            "blame_s": float(blame[k, h]),
            "per_request_s": float(per_req[k, h]),
            "delta_vs_control_s": float(delta[k, h]),
            "errors": float(errs[k, h]),
        }
        if timelines is not None:
            onset = _member_onset(host, k, int(hs[h]))
            if onset is not None:
                row["onset"] = _onset_entry(onset, window_s)
        return row

    members = []
    for k in range(n_mem):
        top = np.argsort(-share[k])[: max(int(top_hops), 1)]
        top = [int(h) for h in top if share[k, h] > 0]
        entry = {
            "member": int(k),
            "seed": (
                int(seeds[k]) if seeds is not None else None
            ),
            "control": bool(k == control),
            "severity": float(sev[k]),
            "blame_excess_vs_control_s": float(excess[k]),
            "mean_latency_gap_s": float(
                host["mean_latency_gap_s"][k]
            ),
            "top_hops": [hop_row(k, h) for h in top],
            # the "why" ranking: hops by their contribution to the
            # member's latency gap over the control member
            "gap_ranking": [
                hop_row(k, int(h))
                for h in np.argsort(-delta[k])[:max(int(top_hops), 1)]
                if delta[k, int(h)] > 0
            ],
        }
        if timelines is not None:
            onset = _member_onset(host, k)
            entry["onset"] = (
                _onset_entry(onset, window_s, names)
                if onset is not None else None
            )
        members.append(entry)

    # bands only for hops that surface in any member's table — O(top
    # * N), never O(H), so svc100k artifacts stay bounded
    surfaced = sorted({
        h["hop"]
        for m in members
        for h in (m["top_hops"] + m["gap_ranking"])
    })
    sb = np.asarray(host["share_band"], np.float64)      # (3, H)
    return {
        "schema": DOC_SCHEMA,
        "label": label,
        "members": int(n_mem),
        "control_member": int(control),
        "band": [float(b) for b in band],
        "onset_margin": float(margin),
        "window_s": (
            float(window_s) if window_s is not None else None
        ),
        "ranking": [int(k) for k in order],
        "hop_bands": [
            {
                "hop": int(h),
                "service": names[int(hs[h])],
                "share_lo": float(sb[0, h]),
                "share_mid": float(sb[1, h]),
                "share_hi": float(sb[2, h]),
            }
            for h in surfaced
        ],
        "member_blame": members,
    }


def _member_onset(host: dict, k: int, service: Optional[int] = None
                  ) -> Optional[dict]:
    """Member k's earliest band departure — over every service (the
    member narrative) or pinned to one service (a hop row).  Onset
    values are window indices, -1 = the member never left its band;
    ties between channels keep the ONSET_CHANNELS priority order."""
    best = None
    for name in ONSET_CHANNELS:
        key = f"onset_{name}"
        if key not in host:
            continue
        onset = np.asarray(host[key])                    # (N, S)
        depth = np.asarray(host[f"{key}_depth"])
        row = onset[k]
        svcs = (
            [int(service)] if service is not None
            else list(range(row.shape[0]))
        )
        hits = [(int(row[s]), int(s)) for s in svcs if row[s] >= 0]
        if not hits:
            continue
        w, s = min(hits)
        if best is None or w < best["window"]:
            best = {
                "window": w,
                "service_id": s,
                "channel": name,
                "depth": float(depth[k, s]),
            }
    return best


def _onset_entry(onset: dict, window_s: Optional[float],
                 names: Optional[Sequence[str]] = None) -> dict:
    out = dict(onset)
    if window_s is not None:
        out["time_s"] = onset["window"] * float(window_s)
    if names is not None:
        out["service"] = names[onset["service_id"]]
    return out


def worst_members(doc: dict, top: int = 3) -> list:
    """The ``top`` most-severe member entries of a fleet-blame doc."""
    by_id = {m["member"]: m for m in doc["member_blame"]}
    return [
        by_id[k]
        for k in doc["ranking"][: max(int(top), 1)]
        if k in by_id and not by_id[k]["control"]
    ] or [by_id[k] for k in doc["ranking"][: max(int(top), 1)]]


def format_report(doc: dict, top: int = 3, hops: int = 3) -> str:
    """Human-readable "why" narrative (the ``explain`` subcommand)."""
    lines = [
        f"fleet blame over {doc['members']} members "
        f"(control member {doc['control_member']}; band "
        f"p{int(doc['band'][0] * 100)}-p{int(doc['band'][2] * 100)})"
    ]
    bands = {b["hop"]: b for b in doc["hop_bands"]}
    for m in worst_members(doc, top):
        head = f"member {m['member']}"
        if m.get("seed") is not None:
            head += f" (seed {m['seed']})"
        head += (
            f": +{m['blame_excess_vs_control_s'] * 1e3:.3f} ms/req "
            "blame excess vs control"
        )
        lines.append(head)
        for r in (m["gap_ranking"] or m["top_hops"])[:hops]:
            b = bands.get(r["hop"])
            line = (
                f"  {r['service']:<20} +{r['delta_vs_control_s'] * 1e6:8.1f}"
                f" us/req  share {r['share'] * 100:5.1f}%"
            )
            if b is not None:
                line += (
                    f"  (band {b['share_lo'] * 100:.1f}-"
                    f"{b['share_hi'] * 100:.1f}%)"
                )
            if r.get("errors"):
                line += f"  errors {r['errors']:.0f}"
            lines.append(line)
        onset = m.get("onset")
        if onset:
            where = onset.get("service", f"svc{onset['service_id']}")
            when = (
                f"{onset['time_s']:.2f}s"
                if "time_s" in onset
                else f"window {onset['window']}"
            )
            lines.append(
                f"  onset: {where} departs the member band at {when} "
                f"({onset['channel']} channel, "
                f"{onset['depth']:.1f} robust sigmas out)"
            )
    return "\n".join(lines)
