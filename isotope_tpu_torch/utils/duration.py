"""Go-compatible duration parsing and formatting.

Sleep commands in topology YAML use Go ``time.ParseDuration`` strings
("100ms", "1.5s", "1h2m3s"); the reference stores them as ``time.Duration``
(isotope/convert/pkg/graph/script/sleep_command.go:23-38). We parse the same
grammar and format with the same rules as Go's ``Duration.String()`` so
round-tripped YAML matches the reference's output.
"""
from __future__ import annotations

import re

# Unit -> nanoseconds, per Go time.ParseDuration.
_UNITS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,
    "μs": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
}

_TOKEN = re.compile(r"(\d+(?:\.\d*)?|\.\d+)(ns|us|µs|μs|ms|s|m|h)")


class InvalidDurationError(ValueError):
    def __init__(self, s: str):
        super().__init__(f"time: invalid duration {s!r}")


def parse_duration_ns(s: str) -> int:
    """Parse a Go duration string to integer nanoseconds.

    Accepts a sign, then one or more (number, unit) tokens; "0" is allowed
    without a unit. Mirrors Go time.ParseDuration's grammar.
    """
    if not isinstance(s, str) or not s:
        raise InvalidDurationError(s)
    orig = s
    sign = 1
    if s[0] in "+-":
        sign = -1 if s[0] == "-" else 1
        s = s[1:]
    if s == "0":
        return 0
    pos = 0
    total = 0.0
    found = False
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if m is None:
            raise InvalidDurationError(orig)
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
        found = True
    if not found:
        raise InvalidDurationError(orig)
    return sign * int(round(total))


def parse_duration_seconds(s: str) -> float:
    return parse_duration_ns(s) / 1e9


def format_duration_ns(ns: int) -> str:
    """Format nanoseconds the way Go's ``Duration.String()`` does.

    < 1s uses ns/us/ms with fractional digits; >= 1s uses h/m/s. Trailing
    zero fractions are trimmed. Examples: 0 -> "0s", 10ms -> "10ms",
    90s -> "1m30s", 1.5s -> "1.5s".
    """
    if ns == 0:
        return "0s"
    sign = "-" if ns < 0 else ""
    ns = abs(ns)
    if ns < 1_000:
        return f"{sign}{ns}ns"
    if ns < 1_000_000:
        return sign + _trim(ns / 1_000) + "µs"
    if ns < 1_000_000_000:
        return sign + _trim(ns / 1_000_000) + "ms"
    secs = ns / 1e9
    h = int(secs // 3600)
    rem = secs - h * 3600
    m = int(rem // 60)
    s_part = rem - m * 60
    out = ""
    if h:
        out += f"{h}h"
    if m or h:
        out += f"{m}m"
    out += _trim(s_part) + "s"
    return sign + out


def _trim(x: float) -> str:
    out = f"{x:.9f}".rstrip("0").rstrip(".")
    return out if out else "0"


def format_duration_seconds(seconds: float) -> str:
    return format_duration_ns(int(round(seconds * 1e9)))
