"""A profiled span of experiments, reduced in memory.

``capture`` runs a function under ``torch.profiler`` (host ops and CUDA
activities) and keeps the events as plain tuples; nothing is written to
disk.  Each profiled experiment runs inside a ``portbench.experiment``
range, and the traced window is the span of those ranges: each ends
with a host read of the experiment's results, so every device activity
it launched lies inside it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

LABEL = "portbench.experiment"
#: a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160
Span = Tuple[str, float, float]  # (name, start s, end s)


def _ns(e, what: str) -> float:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, what + "_us")()) * 1e3


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint intervals covering ``spans``, in order."""
    out: List[List[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


class Trace:
    """Device activities and host ops of one profiled span."""

    def __init__(self, device: List[Span], host: List[Span]):
        labels = [s for s in host if s[0] == LABEL]
        if not labels:
            raise ValueError("the trace holds no profiled experiment")
        self.lo = min(s[1] for s in labels)
        self.hi = max(s[2] for s in labels)
        self.device = [s for s in device if s[2] > self.lo and s[1] < self.hi]
        self.host = [s for s in host if s[0] != LABEL]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def kernels(self) -> List[Span]:
        """Device activities that are kernels (no copies, no fills)."""
        return [s for s in self.device
                if not s[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return union([(max(lo, self.lo), min(hi, self.hi))
                      for _, lo, hi in self.device])

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def device_s(self, match: Optional[str] = None) -> float:
        """Summed device time of activities whose name holds ``match``."""
        return sum(hi - lo for name, lo, hi in self.device
                   if match is None or match in name)

    def count(self, match: Optional[str] = None) -> int:
        return sum(1 for name, _, _ in self.kernels()
                   if match is None or match in name)

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for name, lo, hi in self.device:
            by[name[:NAME_CHARS]] += hi - lo
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                ][:top]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time by the innermost host op running at each
        gap's midpoint (``host`` where no op was)."""
        gaps, t = [], self.lo
        for lo, hi in self.busy_intervals():
            if lo > t:
                gaps.append((t, lo))
            t = max(t, hi)
        if self.hi > t:
            gaps.append((t, self.hi))
        host = sorted(self.host, key=lambda s: s[1])
        starts = [s[1] for s in host]
        by = defaultdict(float)
        stack: List[Span] = []
        i = 0
        for lo, hi in sorted(gaps):
            mid = 0.5 * (lo + hi)
            j = bisect.bisect_right(starts, mid)
            stack.extend(host[i:j])
            i = max(i, j)
            while stack and stack[-1][2] < mid:
                stack.pop()
            by[stack[-1][0][:NAME_CHARS] if stack else "host"] += hi - lo
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                ][:top]


def capture(fn: Callable[[], object]):
    """``(fn(), Trace)``: ``fn`` runs under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        lo = _ns(e, "start") * 1e-9
        span = (e.name(), lo, lo + _ns(e, "duration") * 1e-9)
        if not _is_device(e):
            host.append(span)
        elif not _annotation(e):
            device.append(span)
    return out, Trace(device, host)


def _annotation(e) -> bool:
    """A range the profiler mirrors onto the device's timeline (a
    ``record_function`` label): no work ran on the card in it."""
    f = getattr(e, "is_user_annotation", None)
    return e.name() == LABEL or bool(f is not None and f())
