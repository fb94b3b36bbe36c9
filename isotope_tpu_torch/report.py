"""Dashboard-lite: a static HTML report from sweep artifacts.

A copy of ``isotope_tpu.report`` (standard library only): the same
HTML on the same results.

The reference ships a Django dashboard (perf_dashboard/benchmarks/
views.py) that downloads published benchmark CSVs and renders latency /
CPU-vs-QPS/connection comparisons plus master-vs-release regression
views.  The sim's artifacts are local, so the whole dashboard collapses
to one self-contained HTML file: inline-SVG line charts (no external
assets, works offline), the full results table, and — given a baseline
run directory — a run-vs-run regression table with per-metric deltas.

Charts follow the dataviz method: categorical series colors assigned in
fixed slot order (the validated reference palette, light + dark steps
via CSS custom properties), 2px lines with >=8px hover targets, one
axis per chart, recessive grid, a legend for >=2 series, and the
results table as the always-available text alternative.
"""
from __future__ import annotations

import html
import json
import math
import os
import pathlib
import re
import urllib.parse
from typing import Dict, List, Optional, Sequence, Tuple

LATENCY_METRICS = ("p50", "p75", "p90", "p99", "p999")

# validated reference categorical palette (dataviz skill): light / dark
# steps of the same hues, in the fixed slot order that passes the
# adjacent-pair CVD checks in both modes
_SERIES_LIGHT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
                 "#008300", "#4a3aa7", "#e34948")
_SERIES_DARK = ("#3987e5", "#d95926", "#199e70", "#c98500", "#d55181",
                "#008300", "#9085e9", "#e66767")

_LABEL_RE = re.compile(
    r"^(?P<series>.+?)_(?P<qps>[0-9.]+(?:e[+-]?[0-9]+)?|max)qps_\d+c"
)


def _series_of(label: str) -> str:
    m = _LABEL_RE.match(str(label))
    return m.group("series") if m else str(label)


def load_results(results_dir) -> List[dict]:
    """The flat records of a sweep (results.jsonl)."""
    path = pathlib.Path(results_dir) / "results.jsonl"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found — point at a sweep output directory"
        )
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"{path} is empty")
    return rows


# -- inline-SVG line chart --------------------------------------------------


def _ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    if hi <= lo:
        hi = lo + 1.0
    span = hi - lo
    raw = span / max(n - 1, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    for step in (1, 2, 2.5, 5, 10):
        if raw <= step * mag:
            raw = step * mag
            break
    first = (int(lo / raw)) * raw
    ticks = []
    t = first
    while t <= hi + 1e-9:
        if t >= lo - 1e-9:
            ticks.append(round(t, 10))
        t += raw
    return ticks or [lo, hi]


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:g}"


def svg_line_chart(
    series: Dict[str, List[Tuple[float, float]]],
    title: str,
    x_label: str,
    y_label: str,
    width: int = 520,
    height: int = 300,
) -> str:
    """One SVG line chart: series colored by fixed slot order, 2px
    lines, 8px hover targets with native tooltips, recessive grid."""
    ml, mr, mt, mb = 56, 16, 34, 42
    pw, ph = width - ml - mr, height - mt - mb
    xs = [x for pts in series.values() for x, _ in pts]
    ys = [y for pts in series.values() for _, y in pts]
    if not xs:
        return ""
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = 0.0, max(ys) * 1.08 if max(ys) > 0 else 1.0
    if x_hi == x_lo:
        x_lo, x_hi = x_lo - 1, x_hi + 1

    def X(v):
        return ml + (v - x_lo) / (x_hi - x_lo) * pw

    def Y(v):
        return mt + ph - (v - y_lo) / (y_hi - y_lo) * ph

    parts = [
        f'<svg viewBox="0 0 {width} {height}" role="img" '
        f'aria-label="{html.escape(title)}">',
        f'<text x="{ml}" y="18" class="chart-title">'
        f"{html.escape(title)}</text>",
    ]
    for t in _ticks(y_lo, y_hi):
        y = Y(t)
        parts.append(
            f'<line x1="{ml}" y1="{y:.1f}" x2="{ml + pw}" y2="{y:.1f}" '
            'class="grid"/>'
        )
        parts.append(
            f'<text x="{ml - 6}" y="{y + 4:.1f}" text-anchor="end" '
            f'class="tick">{_fmt(t)}</text>'
        )
    for t in _ticks(x_lo, x_hi):
        x = X(t)
        parts.append(
            f'<text x="{x:.1f}" y="{mt + ph + 16}" text-anchor="middle" '
            f'class="tick">{_fmt(t)}</text>'
        )
    parts.append(
        f'<line x1="{ml}" y1="{mt + ph}" x2="{ml + pw}" y2="{mt + ph}" '
        'class="axis"/>'
    )
    for i, (name, pts) in enumerate(series.items()):
        slot = i % len(_SERIES_LIGHT)
        pts = sorted(pts)
        path = " ".join(
            f"{'M' if j == 0 else 'L'}{X(x):.1f},{Y(y):.1f}"
            for j, (x, y) in enumerate(pts)
        )
        parts.append(
            f'<path d="{path}" fill="none" class="s{slot}" '
            'stroke-width="2"/>'
        )
        for x, y in pts:
            # 8px hit target with a native tooltip; visible 3px dot
            parts.append(
                f'<circle cx="{X(x):.1f}" cy="{Y(y):.1f}" r="3" '
                f'class="s{slot} dot"/>'
                f'<circle cx="{X(x):.1f}" cy="{Y(y):.1f}" r="8" '
                f'fill="transparent" stroke="none">'
                f"<title>{html.escape(name)}\n{x_label}={_fmt(x)} "
                f"{y_label}={y:g}</title></circle>"
            )
    parts.append(
        f'<text x="{ml + pw / 2:.0f}" y="{height - 8}" '
        f'text-anchor="middle" class="axis-label">'
        f"{html.escape(x_label)}</text>"
    )
    parts.append(
        f'<text x="14" y="{mt + ph / 2:.0f}" text-anchor="middle" '
        f'transform="rotate(-90 14 {mt + ph / 2:.0f})" '
        f'class="axis-label">{html.escape(y_label)}</text>'
    )
    parts.append("</svg>")
    return "".join(parts)


def _legend(names: Sequence[str]) -> str:
    items = "".join(
        f'<span class="legend-item"><span class="swatch '
        f's{i % len(_SERIES_LIGHT)}"></span>{html.escape(n)}</span>'
        for i, n in enumerate(names)
    )
    return f'<div class="legend">{items}</div>'


# -- report assembly --------------------------------------------------------


def _group_series(rows: Sequence[dict], x_col: str, y_col: str):
    out: Dict[str, List[Tuple[float, float]]] = {}
    for r in rows:
        y = r.get(y_col)
        if not isinstance(y, (int, float)):
            continue
        x = float(r[x_col])
        out.setdefault(_series_of(r["Labels"]), []).append((x, float(y)))
    return out


def _pick_x(rows: Sequence[dict]) -> Tuple[str, str]:
    conns = {r["NumThreads"] for r in rows}
    if len(conns) > 1:
        return "NumThreads", "Connections"
    return "ActualQPS", "QPS"


_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 2rem; background: #fcfcfb; color: #0b0b0b;
  font: 14px/1.5 system-ui, sans-serif;
}
h1, h2 { font-weight: 600; }
.tiles { display: flex; gap: 1rem; flex-wrap: wrap; margin: 1rem 0; }
.tile {
  border: 1px solid #d8d7d3; border-radius: 8px; padding: .8rem 1.2rem;
  min-width: 8rem;
}
.tile .v { font-size: 1.6rem; font-weight: 600; }
.tile .k { color: #52514e; font-size: .85rem; }
.charts { display: flex; flex-wrap: wrap; gap: 1.5rem; }
figure { margin: 0; }
.chart-title { font-size: 13px; font-weight: 600; fill: #0b0b0b; }
.tick { font-size: 11px; fill: #52514e; }
.axis-label { font-size: 12px; fill: #52514e; }
.grid { stroke: #0b0b0b; stroke-opacity: .08; }
.axis { stroke: #52514e; }
.legend { margin: .4rem 0 1rem; }
.legend-item { margin-right: 1rem; white-space: nowrap; }
.swatch {
  display: inline-block; width: 10px; height: 10px; border-radius: 2px;
  margin-right: .35rem;
}
table { border-collapse: collapse; margin: 1rem 0; }
th, td { border: 1px solid #d8d7d3; padding: .35rem .6rem; text-align: right; }
th:first-child, td:first-child { text-align: left; }
th { background: #f1f0ec; }
.regress { color: #a11a1a; font-weight: 600; }
.improve { color: #0a6b0a; font-weight: 600; }
.discarded td { opacity: .5; }
.spark { vertical-align: middle; }
SERIES_CSS
@media (prefers-color-scheme: dark) {
  body { background: #1a1a19; color: #ffffff; }
  .tile { border-color: #3a3a38; }
  .tile .k, .tick, .axis-label { fill: #c3c2b7; color: #c3c2b7; }
  .chart-title { fill: #ffffff; }
  .grid { stroke: #ffffff; stroke-opacity: .1; }
  .axis { stroke: #c3c2b7; }
  th { background: #242423; }
  th, td { border-color: #3a3a38; }
  .regress { color: #e66767; }
  .improve { color: #31b058; }
  SERIES_DARK_CSS
}
"""


def _series_css() -> Tuple[str, str]:
    light = "\n".join(
        f".s{i} {{ stroke: {c}; }} .swatch.s{i} {{ background: {c}; }} "
        f".dot.s{i} {{ fill: {c}; stroke: none; }}"
        for i, c in enumerate(_SERIES_LIGHT)
    )
    dark = "\n".join(
        f"  .s{i} {{ stroke: {c}; }} .swatch.s{i} {{ background: {c}; }} "
        f".dot.s{i} {{ fill: {c}; stroke: none; }}"
        for i, c in enumerate(_SERIES_DARK)
    )
    return light, dark


_TABLE_COLS = (
    ("Labels", "run"),
    ("ActualQPS", "qps"),
    ("NumThreads", "conns"),
    ("p50", "p50 (µs)"),
    ("p90", "p90 (µs)"),
    ("p99", "p99 (µs)"),
    ("errorPercent", "errors %"),
)


def _results_table(rows: Sequence[dict]) -> str:
    head = "".join(f"<th>{html.escape(t)}</th>" for _, t in _TABLE_COLS)
    body = []
    for r in rows:
        cls = ' class="discarded"' if r.get("windowDiscarded") else ""
        tds = []
        for col, _ in _TABLE_COLS:
            v = r.get(col, "-")
            if isinstance(v, float):
                v = f"{v:.2f}"
            tds.append(f"<td>{html.escape(str(v))}</td>")
        body.append(f"<tr{cls}>{''.join(tds)}</tr>")
    return (
        f"<table><thead><tr>{head}</tr></thead>"
        f"<tbody>{''.join(body)}</tbody></table>"
    )


REGRESSION_METRICS = ("p50", "p90", "p99", "ActualQPS", "errorPercent")
REGRESSION_THRESHOLD = 0.05  # 5% — the dashboard's alert band


def regression_rows(
    current: Sequence[dict], baseline: Sequence[dict]
) -> List[dict]:
    """Join runs by label; per-metric relative deltas vs the baseline."""
    base_by_label = {r["Labels"]: r for r in baseline}
    out = []
    for r in current:
        b = base_by_label.get(r["Labels"])
        if b is None:
            continue
        deltas = {}
        for m in REGRESSION_METRICS:
            cur, old = r.get(m), b.get(m)
            if not isinstance(cur, (int, float)) or not isinstance(
                old, (int, float)
            ):
                continue
            if old:
                delta = (cur - old) / old
            else:
                # from zero: a nonzero current is an unbounded change
                # (e.g. errors newly appearing) — flag it, don't hide it
                delta = math.inf if cur else 0.0
            deltas[m] = {"current": cur, "baseline": old, "delta": delta}
        out.append({"label": r["Labels"], "metrics": deltas})
    return out


def _regression_table(rows: List[dict]) -> str:
    head = "<th>run</th>" + "".join(
        f"<th>{m} Δ%</th>" for m in REGRESSION_METRICS
    )
    body = []
    for row in rows:
        tds = [f"<td>{html.escape(row['label'])}</td>"]
        for m in REGRESSION_METRICS:
            d = row["metrics"].get(m)
            if d is None:
                tds.append("<td>-</td>")
                continue
            pct = d["delta"] * 100.0
            # latency/error up = regression; qps down = regression
            worse = d["delta"] > 0 if m != "ActualQPS" else d["delta"] < 0
            cls = ""
            if abs(d["delta"]) > REGRESSION_THRESHOLD:
                cls = ' class="regress"' if worse else ' class="improve"'
            text = "new" if math.isinf(pct) else f"{pct:+.1f}%"
            tds.append(
                f"<td{cls} title=\"{d['baseline']:g} → "
                f"{d['current']:g}\">{text}</td>"
            )
        body.append(f"<tr>{''.join(tds)}</tr>")
    return (
        f"<table><thead><tr>{head}</tr></thead>"
        f"<tbody>{''.join(body)}</tbody></table>"
    )


def load_timelines(results_dir) -> Dict[str, dict]:
    """Per-run timeline documents (``<label>.timeline.json``) written
    by a ``--timeline`` sweep (metrics/timeline.py); {} when none
    exist."""
    out: Dict[str, dict] = {}
    for p in sorted(pathlib.Path(results_dir).glob("*.timeline.json")):
        try:
            out[p.name[: -len(".timeline.json")]] = json.loads(
                p.read_text()
            )
        except (OSError, json.JSONDecodeError):
            continue
    return out


def _svg_sparkline(values: Sequence[float], width: int = 140,
                   height: int = 28) -> str:
    """A tiny inline-SVG sparkline for one windowed series (the
    dataviz sparkline form: one recessive line, no axes)."""
    vs = [float(v) for v in values]
    if not vs:
        return ""
    hi = max(vs) or 1.0
    n = max(len(vs) - 1, 1)
    pts = " ".join(
        f"{2 + i / n * (width - 4):.1f},"
        f"{height - 3 - v / hi * (height - 6):.1f}"
        for i, v in enumerate(vs)
    )
    return (
        f'<svg viewBox="0 0 {width} {height}" class="spark" '
        f'width="{width}" height="{height}" role="img">'
        f'<polyline points="{pts}" fill="none" class="s0" '
        'stroke-width="1.5"/></svg>'
    )


def _timeline_section(timelines: Dict[str, dict]) -> str:
    """Per-run timeline rows: client-qps and error sparklines over sim
    time plus the busiest services' peak utilization / queue."""
    head = (
        "<th>run</th><th>windows</th><th>qps over time</th>"
        "<th>errors over time</th><th>peak service</th>"
        "<th>peak util</th><th>convoy r</th>"
    )
    body = []
    for label, doc in timelines.items():
        wins = doc.get("windows", [])
        qps = [w.get("qps", 0.0) for w in wins]
        errs = [w.get("errors", 0.0) for w in wins]
        services = doc.get("services", {})
        peak_name, peak_util = "-", 0.0
        for name, svc in services.items():
            u = float(svc.get("peak_utilization", 0.0))
            if u > peak_util:
                peak_name, peak_util = name, u
        conv = (doc.get("convoy") or {}).get("correlation")
        body.append(
            "<tr>"
            f"<td>{html.escape(label)}</td>"
            f"<td>{len(wins)} x {doc.get('window_s', 0):g}s</td>"
            f"<td>{_svg_sparkline(qps)}</td>"
            f"<td>{_svg_sparkline(errs)}</td>"
            f"<td>{html.escape(peak_name)}</td>"
            f"<td>{peak_util * 100:.0f}%</td>"
            f"<td>{conv if conv is not None else '-'}</td>"
            "</tr>"
        )
    return (
        f"<table><thead><tr>{head}</tr></thead>"
        f"<tbody>{''.join(body)}</tbody></table>"
    )


def load_blame(results_dir) -> Dict[str, dict]:
    """Per-run blame documents (``<label>.blame.json``) written by an
    attributed sweep (``--attribution``); {} when none exist."""
    out: Dict[str, dict] = {}
    for p in sorted(pathlib.Path(results_dir).glob("*.blame.json")):
        try:
            out[p.name[: -len(".blame.json")]] = json.loads(
                p.read_text()
            )
        except (OSError, json.JSONDecodeError):
            continue
    return out


def _blame_table(blame: Dict[str, dict], top: int = 8) -> str:
    """Per-run critical-path blame rows: top services with mean (and,
    when the run was attributed in tail mode, p99-cut) blame shares."""
    any_tail = any(d.get("tail_services") for d in blame.values())
    head = (
        "<th>run</th><th>service</th><th>mean share</th>"
        "<th>wait (s)</th><th>self (s)</th><th>net (s)</th>"
        "<th>timeout (s)</th>"
    )
    if any_tail:
        head += "<th>tail share</th>"
    body = []
    for label, doc in blame.items():
        tail_rows = {
            r["service"]: r for r in doc.get("tail_services") or []
        }
        for i, r in enumerate(doc.get("services", [])[:top]):
            tds = [
                f"<td>{html.escape(label) if i == 0 else ''}</td>",
                f"<td>{html.escape(r['service'])}</td>",
                f"<td>{r['share'] * 100:.1f}%</td>",
                f"<td>{r['wait_s']:.4f}</td>",
                f"<td>{r['self_s']:.4f}</td>",
                f"<td>{r['net_s']:.4f}</td>",
                f"<td>{r['timeout_s']:.4f}</td>",
            ]
            if any_tail:
                t = tail_rows.get(r["service"])
                tds.append(
                    f"<td>{t['share'] * 100:.1f}%</td>" if t
                    else "<td>-</td>"
                )
            body.append(f"<tr>{''.join(tds)}</tr>")
    return (
        f"<table><thead><tr>{head}</tr></thead>"
        f"<tbody>{''.join(body)}</tbody></table>"
    )


def build_report(
    rows: Sequence[dict],
    baseline_rows: Optional[Sequence[dict]] = None,
    title: str = "isotope-tpu benchmark report",
    blame: Optional[Dict[str, dict]] = None,
    timelines: Optional[Dict[str, dict]] = None,
) -> str:
    x_col, x_label = _pick_x(rows)
    discarded = sum(1 for r in rows if r.get("windowDiscarded"))

    charts = []
    series_names: List[str] = []
    for metric, unit, scale in (
        ("p50", "latency (ms)", 1e-3),
        ("p99", "latency (ms)", 1e-3),
        ("errorPercent", "errors (%)", 1.0),
    ):
        grouped = _group_series(rows, x_col, metric)
        grouped = {
            k: [(x, y * scale) for x, y in pts]
            for k, pts in grouped.items()
        }
        if grouped:
            series_names = list(grouped)
            charts.append(
                "<figure>"
                + svg_line_chart(
                    grouped, f"{metric} vs {x_label.lower()}", x_label,
                    unit,
                )
                + "</figure>"
            )
    # mean CPU across services, if the sweep recorded it
    cpu_rows = []
    for r in rows:
        cores = [
            v for k, v in r.items()
            if k.startswith("cpu_cores_") and isinstance(v, (int, float))
        ]
        if cores:
            cpu_rows.append(dict(r, total_cpu=sum(cores)))
    if cpu_rows:
        grouped = _group_series(cpu_rows, x_col, "total_cpu")
        if grouped:
            charts.append(
                "<figure>"
                + svg_line_chart(
                    grouped, f"total service CPU vs {x_label.lower()}",
                    x_label, "cores",
                )
                + "</figure>"
            )

    light_css, dark_css = _series_css()
    css = _CSS.replace("SERIES_CSS", light_css).replace(
        "SERIES_DARK_CSS", dark_css
    )
    doc = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{css}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        '<div class="tiles">',
        f'<div class="tile"><div class="v">{len(rows)}</div>'
        '<div class="k">runs</div></div>',
        f'<div class="tile"><div class="v">{discarded}</div>'
        '<div class="k">discarded</div></div>',
        f'<div class="tile"><div class="v">'
        f'{len({_series_of(r["Labels"]) for r in rows})}</div>'
        '<div class="k">series</div></div>',
        "</div>",
    ]
    if len(series_names) >= 2:
        doc.append(_legend(series_names))
    doc.append(f'<div class="charts">{"".join(charts)}</div>')

    if baseline_rows is not None:
        doc.append("<h2>Regression vs baseline</h2>")
        joined = regression_rows(rows, baseline_rows)
        if joined:
            doc.append(_regression_table(joined))
        else:
            doc.append("<p>No runs with matching labels.</p>")

    if blame:
        doc.append("<h2>Critical-path blame</h2>")
        doc.append(
            "<p>Per-service blame shares of the attributed runs "
            "(metrics/attribution.py): which service's wait / self / "
            "wire / timeout time the client latency decomposes into "
            "along the critical path.</p>"
        )
        doc.append(_blame_table(blame))
    if timelines:
        doc.append("<h2>Timelines</h2>")
        doc.append(
            "<p>Windowed series of the recorded runs "
            "(metrics/timeline.py): client throughput and errors over "
            "sim time, plus the busiest service's peak utilization "
            "and the convoy detector's entry-wait-vs-leaf-busy "
            "correlation.</p>"
        )
        doc.append(_timeline_section(timelines))
    doc.append("<h2>All runs</h2>")
    doc.append(_results_table(rows))
    doc.append("</body></html>")
    return "".join(doc)


def write_report(
    results_dir,
    out_path,
    baseline_dir=None,
    title: Optional[str] = None,
) -> int:
    """Render ``results_dir``'s sweep into one HTML file; returns the
    number of runs included.  Blame artifacts (``*.blame.json`` from an
    attributed sweep) render as a critical-path blame table."""
    rows = load_results(results_dir)
    baseline = load_results(baseline_dir) if baseline_dir else None
    doc = build_report(
        rows,
        baseline,
        title or f"isotope-tpu report — {pathlib.Path(results_dir).name}",
        blame=load_blame(results_dir),
        timelines=load_timelines(results_dir),
    )
    pathlib.Path(out_path).write_text(doc)
    return len(rows)


# -- history across publish ids --------------------------------------------

# the suite's publish-id format, `<date>_<loadgen>_<branch>_<ver>` —
# exactly what the reference dashboard scrapes from the GCS bucket
# (perf_dashboard/helpers/download.py:56-62, e.g. 20200525_fortio_master_1.7)
_PUBLISH_ID_RE = re.compile(r"^(?P<date>\d{8})_[^_]+_.+_.+$")


def load_history(
    root, lineage: Optional[str] = None
) -> List[Tuple[str, List[dict]]]:
    """Scan a directory of publish trees (``runner.suite`` output roots)
    and return ``(publish_id, rows)`` pairs in date order.

    Each publish tree holds one ``results.jsonl`` per config
    subdirectory; rows are merged with their config name so the same
    run label in different configs stays distinct.

    A history is one *lineage*: publishes sharing the id suffix after
    the date (``<loadgen>_<branch>_<ver>``).  Mixing lineages would
    mis-order same-date publishes and diff unrelated runs (open-loop
    nighthawk vs closed-loop fortio), so a root holding several
    demands an explicit ``lineage`` selector (substring of the
    suffix).
    """
    root = pathlib.Path(root)
    found: List[Tuple[str, str, pathlib.Path]] = []
    for child in sorted(p for p in root.iterdir() if p.is_dir()):
        m = _PUBLISH_ID_RE.match(child.name)
        if not m:
            continue
        if not any(child.glob("*/results.jsonl")):
            continue  # empty/stale publish dir (e.g. a crashed suite)
        suffix = child.name[len(m.group("date")) + 1:]
        if lineage is not None and lineage not in suffix:
            continue
        found.append((m.group("date"), suffix, child))
    suffixes = {s for _, s, _ in found}
    if len(suffixes) > 1:
        raise ValueError(
            f"{root} holds {len(suffixes)} publish lineages "
            f"({sorted(suffixes)}); pass a lineage selector to pick one"
        )
    out: List[Tuple[str, List[dict]]] = []
    for _, _, child in sorted(found):
        rows: List[dict] = []
        for results in sorted(child.glob("*/results.jsonl")):
            cfg = results.parent.name
            for r in load_results(results.parent):
                rows.append(dict(r, _config=cfg))
        if rows:
            out.append((child.name, rows))
    if not out:
        raise FileNotFoundError(
            f"no publish trees (<date>_<loadgen>_<branch>_<ver> dirs "
            f"with */results.jsonl) under {root}"
            + (f" matching lineage {lineage!r}" if lineage else "")
        )
    return out


HISTORY_METRICS = (
    ("p50", "latency (ms)", 1e-3),
    ("p99", "latency (ms)", 1e-3),
    ("ActualQPS", "qps", 1.0),
    ("errorPercent", "errors (%)", 1.0),
)


def artifact_listing(root) -> List[Tuple[str, int]]:
    """Relative (path, bytes) of every artifact in a publish/sweep tree
    — the reference dashboard's raw-artifact browsing
    (perf_dashboard/artifacts/ views backed by
    helpers/download.py:27-66, which lists and fetches each publish's
    raw files from the bucket)."""
    root = pathlib.Path(root)
    return [
        (str(p.relative_to(root)), p.stat().st_size)
        for p in sorted(root.rglob("*"))
        if p.is_file()
    ]


def _artifact_section(label: str, root, link_prefix: str = "") -> str:
    files = artifact_listing(root)
    items = "".join(
        # quote() first (URL metacharacters like '#'/'?' in filenames),
        # html.escape() second (the URL goes into an attribute)
        f'<li><a href="'
        f'{html.escape(urllib.parse.quote(link_prefix + rel))}">'
        f"{html.escape(rel)}</a> <small>{size:,} B</small></li>"
        for rel, size in files
    )
    return (
        f"<details><summary><code>{html.escape(label)}</code> — "
        f"{len(files)} artifacts</summary><ul>{items}</ul></details>"
    )


def build_history_report(
    history: Sequence[Tuple[str, List[dict]]],
    title: str = "isotope-tpu history",
    artifact_sections: Sequence[str] = (),
) -> str:
    """Metric-over-publish-id time series — the reference dashboard's
    day-over-day regression view (perf_dashboard/helpers/download.py:
    27-66 downloads one benchmark.csv per day and charts them together).

    X axis is the publish index (ids are date-prefixed and sorted);
    each series is one run label, joined across the publishes it
    appears in.
    """
    ids = [pid for pid, _ in history]

    def series_for(metric: str, scale: float):
        out: Dict[str, List[Tuple[float, float]]] = {}
        for i, (_, rows) in enumerate(history):
            for r in rows:
                v = r.get(metric)
                if not isinstance(v, (int, float)):
                    continue
                name = f"{r['_config']}/{r['Labels']}"
                out.setdefault(name, []).append((float(i), v * scale))
        # a one-point series renders as a dot; keep it (a new config's
        # first publish is still information)
        return out

    charts = []
    series_names: List[str] = []
    for metric, unit, scale in HISTORY_METRICS:
        grouped = series_for(metric, scale)
        if grouped:
            series_names = sorted(grouped)
            charts.append(
                "<figure>"
                + svg_line_chart(
                    {k: grouped[k] for k in series_names},
                    f"{metric} over publishes",
                    "publish",
                    unit,
                )
                + "</figure>"
            )

    light_css, dark_css = _series_css()
    css = _CSS.replace("SERIES_CSS", light_css).replace(
        "SERIES_DARK_CSS", dark_css
    )
    id_list = "".join(
        f"<li><code>{i}: {html.escape(pid)}</code> — "
        f"{len(rows)} runs</li>"
        for i, (pid, rows) in enumerate(history)
    )
    doc = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        f"<style>{css}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>{len(ids)} publishes, oldest to newest:</p>",
        f"<ul>{id_list}</ul>",
    ]
    if len(series_names) >= 2:
        doc.append(_legend(series_names))
    doc.append(f'<div class="charts">{"".join(charts)}</div>')

    # latest-vs-previous regression table (the dashboard's
    # master-vs-release deltas, applied day-over-day)
    if len(history) >= 2:
        prev_id, prev_rows = history[-2]
        cur_id, cur_rows = history[-1]
        doc.append(
            f"<h2>Regression: {html.escape(cur_id)} vs "
            f"{html.escape(prev_id)}</h2>"
        )

        # join on (config, label): the same run label may exist in
        # several configs of one publish tree
        def qualify(rows):
            return [
                dict(r, Labels=f"{r['_config']}/{r['Labels']}")
                for r in rows
            ]

        joined = regression_rows(qualify(cur_rows), qualify(prev_rows))
        if joined:
            doc.append(_regression_table(joined))
        else:
            doc.append("<p>No runs with matching labels.</p>")
    if artifact_sections:
        doc.append("<h2>Artifacts</h2>")
        doc.extend(artifact_sections)
    doc.append("</body></html>")
    return "".join(doc)


def write_history_report(
    root, out_path, title: Optional[str] = None,
    lineage: Optional[str] = None,
) -> int:
    """Render a metric-over-time page from a directory of publish
    trees; returns the number of publishes included.  Each publish gets
    a collapsible raw-artifact browser with links relative to the
    report's location (the reference dashboard's per-publish artifact
    view)."""
    history = load_history(root, lineage=lineage)
    root_p = pathlib.Path(root)
    out_p = pathlib.Path(out_path)
    # links are resolved by the browser relative to the report file,
    # so the prefix must be root relative to the report's directory
    # (os.path.relpath walks .. when the report lives inside root)
    prefix_base = os.path.relpath(
        root_p.resolve(), out_p.resolve().parent
    )
    sections = [
        _artifact_section(
            pid, root_p / pid,
            link_prefix=f"{pid}/" if prefix_base == "."
            else f"{prefix_base}/{pid}/",
        )
        for pid, _ in history
        if (root_p / pid).is_dir()
    ]
    doc = build_history_report(
        history,
        title or f"isotope-tpu history — {pathlib.Path(root).name}",
        artifact_sections=sections,
    )
    pathlib.Path(out_path).write_text(doc)
    return len(history)
