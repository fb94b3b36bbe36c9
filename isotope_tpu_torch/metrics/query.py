"""A Prometheus query layer over the simulator's exposition.

The reference's analysis path speaks PromQL at a live Prometheus:
canned proxy CPU/memory aggregations
(perf/benchmark/runner/prom.py:116-126), latency quantiles via
``histogram_quantile(p, sum(rate(m[Ns])) by (g, le))``
(prom.py:216-232), and the stability alarms of metrics/check_metrics.py.
The simulator renders the same text exposition a scraper would see
(metrics/prometheus.py); this module closes the loop by parsing that
text back into samples and evaluating the PromQL subset those consumers
actually use:

- instant vector selectors with label matchers: ``m{a="x",b!="y"}``
  (and ``=~``/``!~`` anchored regexes);
- range selectors ``m[1m]`` — the simulator is a single scrape of a
  complete run, so ``rate()`` divides by the *run duration* regardless
  of the bracketed window (each counter accumulated over exactly that
  window); the bracket is accepted for query-string parity;
- ``rate(v)``, aggregations ``sum/max/min/avg/count (v) by (l1, ...)``
  (also ``without (...)``), ``histogram_quantile(q, v)``,
  ``max_over_time``/``avg_over_time`` (identity on a single scrape),
  and scalar arithmetic ``expr * 1000`` / ``expr / 60``.

``histogram_quantile`` implements Prometheus's algorithm: group
``_bucket`` series by all labels but ``le``, cumulative counts, linear
interpolation within the winning bucket (upper bound for +Inf).

A copy of ``isotope_tpu.metrics.query`` (pure Python): the port's
``check`` command evaluates its alarm queries with it.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


@dataclasses.dataclass(frozen=True)
class Sample:
    name: str
    labels: Dict[str, str]
    value: float
    # optional exposition timestamp (ms) — one series may carry several
    # timestamped samples (the timeline's per-window scrape sequence);
    # instant queries read the LATEST one (see MetricStore._select)
    timestamp_ms: Optional[int] = None

    def key(self, drop: Sequence[str] = ()) -> LabelSet:
        return tuple(
            sorted((k, v) for k, v in self.labels.items() if k not in drop)
        )


_LINE_RE = re.compile(
    # the label body matches quoted strings as units, so a '}' INSIDE a
    # label value (cluster="outbound|8080|{tag}") does not end the set;
    # the timestamp accepts OpenMetrics float/exponent notation
    # (1.7e12), not just the Prometheus text format's integer ms
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>(?:[^"{}]|"(?:[^"\\]|\\.)*")*)\})?'
    r'\s+(?P<value>[^\s]+)'
    r'(?:\s+(?P<ts>[-+0-9.eE]+))?\s*$'
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
# the whole label body must be well-formed pairs, not just contain some
_LABELS_BODY_RE = re.compile(
    r'^\s*(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\s*'
    r'(?:,\s*[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\s*)*,?\s*)?$'
)


# single-pass unescape: sequential str.replace passes corrupt values
# like '\\' + 'n' (escaped backslash followed by a literal n)
_UNESCAPE_RE = re.compile(r'\\(.)')
_UNESCAPE_MAP = {'"': '"', "\\": "\\", "n": "\n"}


def _unescape_label(v: str) -> str:
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(0)), v
    )


def _parse_sample_line(line: str) -> Sample:
    """One non-comment exposition line -> Sample; raises ValueError with
    the offending line on any malformation (shape, labels, value, ts)."""
    m = _LINE_RE.match(line)
    if not m:
        raise ValueError(f"unparseable exposition line: {line!r}")
    body = m.group("labels") or ""
    if not _LABELS_BODY_RE.match(body):
        raise ValueError(f"malformed labels in line: {line!r}")
    labels = {
        k: _unescape_label(v) for k, v in _LABEL_RE.findall(body)
    }
    try:
        # float() accepts the OpenMetrics specials verbatim: NaN,
        # +Inf/-Inf, and exponent notation
        value = float(m.group("value"))
    except ValueError:
        raise ValueError(
            f"unparseable sample value in line: {line!r}"
        ) from None
    ts = m.group("ts")
    ts_ms: Optional[int] = None
    if ts is not None:
        try:
            ts_ms = int(round(float(ts)))
        except (ValueError, OverflowError):
            raise ValueError(
                f"unparseable timestamp in line: {line!r}"
            ) from None
    return Sample(m.group("name"), labels, value, timestamp_ms=ts_ms)


@dataclasses.dataclass
class ExpositionParse:
    """A tolerant parse of one exposition: samples plus line accounting.

    The counters partition the input exactly —
    ``lines_total == lines_blank + lines_comment + lines_parsed +
    len(malformed)`` — so consumers (the ingest coverage block) can
    prove nothing was dropped silently.  Comment lines cover all ``#``
    families: HELP/TYPE and the OpenMetrics UNIT/EOF markers.
    """

    samples: List[Sample]
    lines_total: int = 0
    lines_blank: int = 0
    lines_comment: int = 0
    lines_parsed: int = 0
    malformed: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list
    )

    @property
    def lines_malformed(self) -> int:
        return len(self.malformed)


def parse_exposition_tolerant(text: str) -> ExpositionParse:
    """Parse a real-world scrape: malformed lines are COUNTED and
    carried (1-based line numbers), never raised mid-file, so one bad
    line cannot abort the ingest of an otherwise-usable exposition.
    Tolerates OpenMetrics ``# EOF`` / ``# TYPE`` / ``# UNIT`` comment
    families, ``NaN``/``+Inf`` values, and exponent-notation
    timestamps."""
    out = ExpositionParse(samples=[])
    for lineno, raw in enumerate(text.splitlines(), 1):
        out.lines_total += 1
        line = raw.strip()
        if not line:
            out.lines_blank += 1
            continue
        if line.startswith("#"):
            out.lines_comment += 1
            continue
        try:
            out.samples.append(_parse_sample_line(line))
        except ValueError:
            out.malformed.append((lineno, raw))
            continue
        out.lines_parsed += 1
    return out


def parse_exposition(text: str) -> List[Sample]:
    """Parse the Prometheus text format into flat samples.

    Strict: the first malformed line raises ValueError (the simulator's
    own expositions must be pristine).  Scrape ingestion uses
    :func:`parse_exposition_tolerant`, which counts instead."""
    out: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        out.append(_parse_sample_line(line))
    return out


# -- the PromQL-subset evaluator -------------------------------------------


class QueryError(ValueError):
    pass


@dataclasses.dataclass
class _Matcher:
    label: str
    op: str          # = != =~ !~
    value: str

    def ok(self, labels: Dict[str, str]) -> bool:
        got = labels.get(self.label, "")
        if self.op == "=":
            return got == self.value
        if self.op == "!=":
            return got != self.value
        # Prometheus fully anchors regex matchers
        hit = re.fullmatch(self.value, got) is not None
        return hit if self.op == "=~" else not hit


_AGGS: Dict[str, Callable] = {
    "sum": sum,
    "max": max,
    "min": min,
    "avg": lambda vs: sum(vs) / len(vs),
    "count": len,
}
# single-scrape identities: the run IS the whole time range
_OVER_TIME = {"max_over_time", "avg_over_time", "min_over_time"}


class _Parser:
    """Recursive descent over the supported grammar."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        self._ws()
        return self.text[self.pos:self.pos + 1]

    def _ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def expect(self, ch: str):
        self._ws()
        if not self.text.startswith(ch, self.pos):
            raise QueryError(
                f"expected {ch!r} at {self.pos} in {self.text!r}"
            )
        self.pos += len(ch)

    def ident(self) -> str:
        self._ws()
        m = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", self.text[self.pos:])
        if not m:
            raise QueryError(
                f"expected identifier at {self.pos} in {self.text!r}"
            )
        self.pos += m.end()
        return m.group(0)

    def number(self) -> float:
        self._ws()
        m = re.match(r"[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?",
                     self.text[self.pos:])
        if not m:
            raise QueryError(f"expected number at {self.pos}")
        self.pos += m.end()
        return float(m.group(0))

    # grammar -----------------------------------------------------------

    def parse(self):
        node = self.expr()
        self._ws()
        if self.pos != len(self.text):
            raise QueryError(
                f"trailing input at {self.pos}: {self.text[self.pos:]!r}"
            )
        return node

    def expr(self):
        node = self.term()
        while True:
            self._ws()
            ch = self.peek()
            if ch in ("*", "/"):
                self.pos += 1
                rhs = self.term()
                node = ("binop", ch, node, rhs)
            else:
                return node

    def term(self):
        self._ws()
        ch = self.peek()
        if ch == "(":
            self.expect("(")
            node = self.expr()
            self.expect(")")
            return node
        if ch.isdigit() or ch == ".":
            return ("number", self.number())
        ident = self.ident()
        self._ws()
        if self.peek() == "(":
            return self.call(ident)
        return self.selector(ident)

    def call(self, fn: str):
        self.expect("(")
        args = [self.expr()]
        while self.peek() == ",":
            self.expect(",")
            args.append(self.expr())
        self.expect(")")
        by: Optional[Tuple[str, bool]] = None
        self._ws()
        m = re.match(r"(by|without)\s*\(", self.text[self.pos:])
        if fn in _AGGS and m:
            self.pos += m.end()
            labels = []
            while self.peek() != ")":
                labels.append(self.ident())
                if self.peek() == ",":
                    self.expect(",")
            self.expect(")")
            by = (tuple(labels), m.group(1) == "by")
        return ("call", fn, args, by)

    def selector(self, name: str):
        matchers: List[_Matcher] = []
        self._ws()
        if self.peek() == "{":
            self.expect("{")
            while self.peek() != "}":
                label = self.ident()
                self._ws()
                for op in ("!~", "=~", "!=", "="):
                    if self.text.startswith(op, self.pos):
                        self.pos += len(op)
                        break
                else:
                    raise QueryError(f"bad matcher op at {self.pos}")
                self._ws()
                m = re.match(r'"((?:[^"\\]|\\.)*)"', self.text[self.pos:])
                if not m:
                    raise QueryError(f"expected quoted value at {self.pos}")
                self.pos += m.end()
                matchers.append(_Matcher(label, op, m.group(1)))
                if self.peek() == ",":
                    self.expect(",")
            self.expect("}")
        self._ws()
        if self.peek() == "[":
            self.expect("[")
            m = re.match(r"[0-9]+[smhd]?", self.text[self.pos:])
            if not m:
                raise QueryError(f"expected range duration at {self.pos}")
            self.pos += m.end()
            self.expect("]")
            return ("range", name, tuple(matchers))
        return ("instant", name, tuple(matchers))


Vector = Dict[LabelSet, float]


class MetricStore:
    """Instant-query evaluation over one scrape of samples.

    ``duration_s`` is the wall span the counters accumulated over — the
    simulated run's duration — used by ``rate()``.
    """

    def __init__(self, samples: Sequence[Sample], duration_s: float):
        self.samples = list(samples)
        self.duration_s = float(duration_s)
        self._by_name: Dict[str, List[Sample]] = {}
        for s in self.samples:
            self._by_name.setdefault(s.name, []).append(s)

    @classmethod
    def from_text(cls, text: str, duration_s: float) -> "MetricStore":
        return cls(parse_exposition(text), duration_s)

    # -- public API -----------------------------------------------------

    def query(self, expr: str) -> Vector:
        """Evaluate; returns {sorted-label-tuple: value}."""
        node = _Parser(expr).parse()
        val = self._eval(node)
        if isinstance(val, float):
            return {(): val}
        return val

    def query_value(self, expr: str, default: float = 0.0) -> float:
        """Evaluate to one number (prometheus.py:43-61's fetch_value:
        an empty result is 0)."""
        vec = self.query(expr)
        if not vec:
            return default
        if len(vec) > 1:
            raise QueryError(
                f"query returned {len(vec)} series, expected 1: {expr!r}"
            )
        return next(iter(vec.values()))

    # -- evaluation -----------------------------------------------------

    def _select(self, name: str, matchers) -> Vector:
        out: Vector = {}
        # instant-query semantics for TIMESTAMPED series: the latest
        # sample of each label set wins (a timeline exposition carries
        # one sample per window); untimestamped duplicates keep the
        # historical summing behavior
        latest_ts: Dict[LabelSet, int] = {}
        for s in self._by_name.get(name, ()):
            if not all(m.ok(s.labels) for m in matchers):
                continue
            k = s.key()
            if s.timestamp_ms is not None:
                if k not in latest_ts or s.timestamp_ms >= latest_ts[k]:
                    latest_ts[k] = s.timestamp_ms
                    out[k] = s.value
            else:
                out[k] = out.get(k, 0.0) + s.value
        return out

    def _eval(self, node):
        kind = node[0]
        if kind == "number":
            return node[1]
        if kind in ("instant", "range"):
            return self._select(node[1], node[2])
        if kind == "binop":
            _, op, lhs, rhs = node
            lv, rv = self._eval(lhs), self._eval(rhs)
            f = (lambda a, b: a * b) if op == "*" else (lambda a, b: a / b)
            if isinstance(lv, float) and isinstance(rv, float):
                return f(lv, rv)
            if isinstance(rv, float):
                return {k: f(v, rv) for k, v in lv.items()}
            if isinstance(lv, float):
                return {k: f(lv, v) for k, v in rv.items()}
            raise QueryError("vector-vector arithmetic is not supported")
        if kind == "call":
            _, fn, args, by = node
            if fn == "rate" or fn == "irate":
                v = self._eval(args[0])
                if not isinstance(v, dict):
                    raise QueryError("rate() needs a selector")
                if self.duration_s <= 0:
                    return {k: 0.0 for k in v}
                return {k: val / self.duration_s for k, val in v.items()}
            if fn in _OVER_TIME:
                return self._eval(args[0])
            if fn == "histogram_quantile":
                q = self._eval(args[0])
                v = self._eval(args[1])
                if not isinstance(q, float) or not isinstance(v, dict):
                    raise QueryError(
                        "histogram_quantile(scalar, vector) expected"
                    )
                return _histogram_quantile(q, v)
            if fn in _AGGS:
                v = self._eval(args[0])
                if not isinstance(v, dict):
                    raise QueryError(f"{fn}() needs a vector")
                groups: Dict[LabelSet, List[float]] = {}
                for key, val in v.items():
                    labels = dict(key)
                    if by is None:
                        gkey: LabelSet = ()
                    else:
                        names, is_by = by
                        if is_by:
                            kept = {
                                k: x for k, x in labels.items()
                                if k in names
                            }
                        else:
                            kept = {
                                k: x for k, x in labels.items()
                                if k not in names
                            }
                        gkey = tuple(sorted(kept.items()))
                    groups.setdefault(gkey, []).append(val)
                return {
                    k: float(_AGGS[fn](vs)) for k, vs in groups.items()
                }
            raise QueryError(f"unsupported function: {fn!r}")
        raise QueryError(f"bad node {node!r}")  # pragma: no cover


def _histogram_quantile(q: float, vec: Vector) -> Vector:
    """Prometheus's histogram_quantile over ``_bucket`` series."""
    groups: Dict[LabelSet, List[Tuple[float, float]]] = {}
    for key, val in vec.items():
        labels = dict(key)
        le = labels.pop("le", None)
        if le is None:
            raise QueryError("histogram_quantile input lacks 'le' labels")
        bound = math.inf if le in ("+Inf", "Inf", "inf") else float(le)
        groups.setdefault(tuple(sorted(labels.items())), []).append(
            (bound, val)
        )
    out: Vector = {}
    for gkey, buckets in groups.items():
        buckets.sort()
        total = buckets[-1][1] if buckets else 0.0
        # Prometheus: NaN without at least two buckets (one finite + +Inf)
        if (
            len(buckets) < 2
            or total <= 0
            or not math.isinf(buckets[-1][0])
        ):
            out[gkey] = math.nan
            continue
        rank = q * total
        prev_bound, prev_count = 0.0, 0.0
        val = buckets[-2][0] if len(buckets) > 1 else math.nan
        for bound, count in buckets:
            if count >= rank:
                if math.isinf(bound):
                    # quantile falls in +Inf: report the last finite bound
                    val = prev_bound
                else:
                    width = bound - prev_bound
                    frac = (
                        (rank - prev_count) / (count - prev_count)
                        if count > prev_count
                        else 0.0
                    )
                    val = prev_bound + width * frac
                break
            prev_bound, prev_count = bound, count
        out[gkey] = val
    return out
