"""The fit-fidelity artifact: ``<label>.ingest.json``.

Schema ``isotope-ingest/v1`` (to_doc / check_doc / load_doc, the same
round-trip idiom as isotope-timeline/v1 and isotope-search/v1):

- ``inputs``: per-input coverage rows whose counters PARTITION each
  input (lines_total == blank + comment + parsed + malformed;
  parsed == used + ignored) — the no-silent-truncation pin;
- ``fit``: the global knobs the TOML carries (entry, cpu_time, qps
  schedule) plus per-service observed/fitted values and residuals;
- ``coverage``: everything dropped, each with a reason (services
  unreachable from the entrypoint, cycle-closing edges, zero-ratio
  edges, empty lead/tail windows);
- ``closure`` (optional): the self-closure comparison appended when
  the source topology is known (tools/ingest_smoke.py), reconstructed
  vs source error share / mean self-time / degree sequence / qps
  schedule with the tolerances stated next to each check.

``format_report`` renders the human view for ``isotope-tpu explain``.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

from isotope_tpu_torch.ingest.fitters import FitResult
from isotope_tpu_torch.ingest.readers import Observation

DOC_SCHEMA = "isotope-ingest/v1"

# Self-closure tolerances (documented in README "Trace-driven ingest").
# The fit is statistical — Poisson arrival noise ~ 1/sqrt(qps * dt) per
# window, self-time residuals from the wire-time model — so the pins
# are bands, not equalities; the degree sequence alone is exact.
CLOSURE_TOLERANCES = {
    # |fitted - source| per-service intrinsic error share
    "error_share_abs": 0.02,
    # relative error of the FLEET MEAN self-time (cpu + sleep)
    "self_time_mean_rel": 0.15,
    # per-service self-time relative error (services with >= the
    # sample floor below); the residual estimator subtracts a
    # wire+sojourn term PER CALL, so high-fan-out hubs accumulate
    # noise linearly in degree — the pin is a band SHARE, not
    # all-or-nothing
    "self_time_each_rel": 0.35,
    "self_time_min_samples": 30,
    "self_time_band_share": 0.90,
    # sorted out-degree sequences must match exactly
    "degree_sequence": "exact",
    # fitted windowed qps: mean within this relative band ...
    "qps_mean_rel": 0.10,
    # ... and this share of windows within qps_window_rel of source
    "qps_window_rel": 0.25,
    "qps_window_share": 0.80,
}


def _finite(x: Optional[float]) -> Optional[float]:
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def to_doc(fr: FitResult, obs: Observation) -> dict:
    services = []
    for name in sorted(fr.services):
        f = fr.services[name]
        o = obs.services.get(name)
        row = {
            "name": name,
            "observed": {
                "incoming": f.incoming,
                "errors": (o.errors if o else 0.0),
                "sojourn_s": _finite(f.sojourn_s),
                "station_cpu_s": _finite(f.station_cpu_s),
                "samples": f.samples,
            },
            "fitted": {
                "error_rate": f.error_rate,
                "self_time_s": round(f.self_time_s, 9),
                "sleep_s": round(f.sleep_s, 9),
                "replicas": f.replicas,
                "out_degree": f.out_degree,
                "concurrent": f.concurrent,
                "response_size": f.response_size,
            },
            "residuals": _residuals(f),
        }
        if f.self_hist:
            row["observed"]["self_time_log_hist"] = [
                ["+Inf" if math.isinf(b) else b, c]
                for b, c in f.self_hist
            ]
        if f.flags:
            row["flags"] = list(f.flags)
        services.append(row)
    doc = {
        "schema": DOC_SCHEMA,
        "label": fr.label,
        "entry": fr.entry,
        "inputs": [c.to_dict() for c in obs.inputs],
        "fit": {
            "cpu_time_s": fr.cpu_time_s,
            "qps_mean": fr.qps_mean,
            "qps_schedule": [round(q, 6) for q in fr.qps_schedule],
            "window_s": fr.window_s,
            "duration_s": fr.duration_s,
            "num_services": len(fr.services),
            "num_edges": len(fr.edges),
            "degree_sequence": degree_sequence(fr),
            "services": services,
            "edges": [
                {"caller": src, "callee": dst, "ratio": round(r, 6)}
                for (src, dst), r in sorted(fr.edges.items())
            ],
        },
        "coverage": {
            "services_dropped": fr.dropped["services"],
            "edges_dropped": fr.dropped["edges"],
            "windows_dropped": fr.dropped["windows"],
        },
        "notes": list(fr.notes),
    }
    return doc


def _residuals(f) -> dict:
    """Self-consistency residuals: how far the fitted point estimates
    sit from their own observations (not from ground truth — that is
    the closure block's job)."""
    out: dict = {}
    if f.sojourn_s is not None and f.sojourn_s > 0:
        # the sleep+cpu point estimate can never exceed the sojourn
        out["self_over_sojourn"] = round(
            f.self_time_s / f.sojourn_s, 6
        )
    if f.station_cpu_s is not None and f.self_time_s > 0:
        out["station_share_of_self"] = round(
            min(f.station_cpu_s / f.self_time_s, 1.0), 6
        )
    return out


def degree_sequence(fr: FitResult) -> List[int]:
    return sorted(
        (f.out_degree for f in fr.services.values()), reverse=True
    )


def check_doc(doc: dict) -> dict:
    """Validate an isotope-ingest/v1 document (round-trip guard)."""
    if doc.get("schema") != DOC_SCHEMA:
        raise ValueError(
            f"not an {DOC_SCHEMA} document: {doc.get('schema')!r}"
        )
    for key in ("label", "inputs", "fit", "coverage"):
        if key not in doc:
            raise ValueError(f"{DOC_SCHEMA} document missing {key!r}")
    cov = doc["coverage"]
    for key in ("services_dropped", "edges_dropped", "windows_dropped"):
        if not isinstance(cov.get(key), list):
            raise ValueError(
                f"{DOC_SCHEMA} coverage.{key} must be a list"
            )
    for row in doc["inputs"]:
        total = row["lines_total"]
        parts = (
            row["lines_blank"] + row["lines_comment"]
            + row["lines_parsed"] + row["lines_malformed"]
        )
        if total != parts:
            raise ValueError(
                f"coverage accounting broken for {row.get('path')!r}: "
                f"lines_total={total} != partition sum {parts}"
            )
        if row["samples_used"] + row["samples_ignored"] != (
            row["lines_parsed"]
        ):
            raise ValueError(
                f"sample accounting broken for {row.get('path')!r}"
            )
    return doc


def load_doc(path: str) -> dict:
    with open(path) as f:
        return check_doc(json.load(f))


def save_doc(doc: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(check_doc(doc), f, indent=1, sort_keys=False)
        f.write("\n")


# -- self-closure ------------------------------------------------------


def closure_check(
    source_graph,
    source_cpu_time_s: float,
    source_qps: List[float],
    fr: FitResult,
    tolerances: Optional[dict] = None,
) -> dict:
    """Compare a fit against its known source topology: the self-closure
    pin.  Returns a dict with per-check pass/fail detail and an overall
    ``ok``; appended to the artifact under ``closure`` by the smoke.

    ``source_qps`` is the per-window source schedule (a constant-rate
    run passes ``[qps] * windows`` or just ``[qps]``).
    """
    tol = dict(CLOSURE_TOLERANCES)
    if tolerances:
        tol.update(tolerances)
    checks: List[dict] = []

    # source per-service truth
    src_err: Dict[str, float] = {}
    src_self: Dict[str, float] = {}
    src_deg: List[int] = []
    for svc in source_graph.services:
        src_err[svc.name] = float(svc.error_rate)
        sleep = 0.0
        deg = 0
        for cmd in svc.script:
            for c in _flatten(cmd):
                if hasattr(c, "seconds"):
                    sleep += c.seconds
                elif hasattr(c, "service_name"):
                    deg += 1
        src_self[svc.name] = source_cpu_time_s + sleep
        src_deg.append(deg)

    # error share
    worst_err = (None, 0.0)
    for name, f in fr.services.items():
        if name not in src_err:
            continue
        d = abs(f.error_rate - src_err[name])
        if d > worst_err[1]:
            worst_err = (name, d)
    checks.append({
        "check": "error_share",
        "tolerance_abs": tol["error_share_abs"],
        "worst_service": worst_err[0],
        "worst_abs_error": round(worst_err[1], 6),
        "ok": worst_err[1] <= tol["error_share_abs"],
    })

    # self-time (cpu + sleep): fleet mean + per-service band
    pairs = [
        (name, src_self[name],
         f.self_time_s if f.self_time_s > 0 else (
             f.station_cpu_s or fr.cpu_time_s
         ))
        for name, f in fr.services.items() if name in src_self
    ]
    if pairs:
        src_mean = sum(p[1] for p in pairs) / len(pairs)
        fit_mean = sum(p[2] for p in pairs) / len(pairs)
        mean_rel = abs(fit_mean - src_mean) / max(src_mean, 1e-12)
        per_svc_bad = []
        eligible = 0
        for name, s, v in pairs:
            f = fr.services[name]
            if f.samples < tol["self_time_min_samples"]:
                continue
            eligible += 1
            rel = abs(v - s) / max(s, 1e-12)
            if rel > tol["self_time_each_rel"]:
                per_svc_bad.append(
                    {"service": name, "rel_error": round(rel, 4),
                     "source_s": s, "fitted_s": v}
                )
        in_band_share = (
            (eligible - len(per_svc_bad)) / eligible
            if eligible else 1.0
        )
        checks.append({
            "check": "self_time",
            "tolerance_mean_rel": tol["self_time_mean_rel"],
            "tolerance_each_rel": tol["self_time_each_rel"],
            "tolerance_band_share": tol["self_time_band_share"],
            "source_mean_s": src_mean,
            "fitted_mean_s": fit_mean,
            "mean_rel_error": round(mean_rel, 6),
            "services_eligible": eligible,
            "services_in_band_share": round(in_band_share, 4),
            "services_out_of_band": per_svc_bad[:10],
            "ok": (
                mean_rel <= tol["self_time_mean_rel"]
                and in_band_share >= tol["self_time_band_share"]
            ),
        })

    # fan-out degree sequence (exact)
    fit_deg = degree_sequence(fr)
    src_deg_sorted = sorted(src_deg, reverse=True)
    checks.append({
        "check": "degree_sequence",
        "tolerance": "exact",
        "source": src_deg_sorted,
        "fitted": fit_deg,
        "ok": fit_deg == src_deg_sorted,
    })

    # qps schedule
    if source_qps:
        src_sched = list(source_qps)
        if len(src_sched) == 1:
            src_sched = src_sched * len(fr.qps_schedule)
        n = min(len(src_sched), len(fr.qps_schedule))
        src_mean_q = sum(src_sched) / max(len(src_sched), 1)
        fit_mean_q = fr.qps_mean
        mean_rel = abs(fit_mean_q - src_mean_q) / max(src_mean_q, 1e-12)
        in_band = sum(
            1 for i in range(n)
            if abs(fr.qps_schedule[i] - src_sched[i])
            <= tol["qps_window_rel"] * max(src_sched[i], 1e-12)
        )
        share = in_band / n if n else 0.0
        checks.append({
            "check": "qps_schedule",
            "tolerance_mean_rel": tol["qps_mean_rel"],
            "tolerance_window_rel": tol["qps_window_rel"],
            "tolerance_window_share": tol["qps_window_share"],
            "source_mean": src_mean_q,
            "fitted_mean": fit_mean_q,
            "mean_rel_error": round(mean_rel, 6),
            "windows_compared": n,
            "windows_in_band_share": round(share, 4),
            "ok": (
                mean_rel <= tol["qps_mean_rel"]
                and share >= tol["qps_window_share"]
            ),
        })

    return {
        "tolerances": tol,
        "checks": checks,
        "ok": all(c["ok"] for c in checks),
    }


def _flatten(cmd):
    # ConcurrentCommand subclasses list
    if isinstance(cmd, (list, tuple)):
        for c in cmd:
            yield from _flatten(c)
    else:
        yield cmd


# -- rendering (explain) -----------------------------------------------


def format_report(doc: dict, top: int = 10) -> str:
    check_doc(doc)
    fit = doc["fit"]
    cov = doc["coverage"]
    out: List[str] = []
    out.append(
        f"ingest {doc['label']!r}: {fit['num_services']} services, "
        f"{fit['num_edges']} edges, entry {doc.get('entry')!r}"
    )
    out.append(
        f"  schedule: {len(fit['qps_schedule'])} windows x "
        f"{fit['window_s']:g}s, mean {fit['qps_mean']:.1f} qps; "
        f"[sim] cpu_time {fit['cpu_time_s'] * 1e6:.0f}us"
    )
    for row in doc["inputs"]:
        out.append(
            f"  input {row['path']} ({row['format']}): "
            f"{row['lines_parsed']} parsed / {row['lines_malformed']} "
            f"malformed of {row['lines_total']}; "
            f"{row['samples_used']} used, "
            f"{row['samples_ignored']} ignored"
        )
        for n, t in row.get("malformed_examples", [])[:3]:
            out.append(f"    line {n}: {t}")
    dropped = (
        len(cov["services_dropped"]), len(cov["edges_dropped"]),
        len(cov["windows_dropped"]),
    )
    if any(dropped):
        out.append(
            f"  dropped: {dropped[0]} services, {dropped[1]} edges, "
            f"{dropped[2]} windows (reasons in coverage block)"
        )
        for row in cov["services_dropped"][:3]:
            out.append(
                f"    service {row['service']!r}: {row['reason']}"
            )
        for row in cov["edges_dropped"][:3]:
            out.append(
                f"    edge {row['edge'][0]}->{row['edge'][1]}: "
                f"{row['reason']}"
            )
    else:
        out.append("  dropped: nothing")
    rows = sorted(
        fit["services"],
        key=lambda r: -(r["observed"]["incoming"] or 0),
    )[:top]
    out.append(
        f"  top services by arrivals (of {fit['num_services']}):"
    )
    for r in rows:
        fitted = r["fitted"]
        line = (
            f"    {r['name']}: {r['observed']['incoming']:.0f} req, "
            f"err {fitted['error_rate']:.3f}, "
            f"self {fitted['self_time_s'] * 1e3:.2f}ms "
            f"(sleep {fitted['sleep_s'] * 1e3:.2f}ms), "
            f"fan-out {fitted['out_degree']}"
        )
        if fitted.get("concurrent"):
            line += " (concurrent)"
        out.append(line)
        for flag in r.get("flags", [])[:2]:
            out.append(f"      ! {flag}")
    closure = doc.get("closure")
    if closure:
        verdict = "PASS" if closure.get("ok") else "FAIL"
        out.append(f"  self-closure: {verdict}")
        for c in closure.get("checks", []):
            mark = "ok" if c.get("ok") else "FAIL"
            detail = ""
            if "mean_rel_error" in c:
                detail = f" mean_rel={c['mean_rel_error']:.3f}"
            elif "worst_abs_error" in c:
                detail = f" worst_abs={c['worst_abs_error']:.4f}"
            out.append(f"    {c['check']}: {mark}{detail}")
    if doc.get("notes"):
        for n in doc["notes"][:5]:
            out.append(f"  note: {n}")
    return "\n".join(out)
