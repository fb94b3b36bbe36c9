"""The program's own spans on the profiler's clock, with each device
activity put down to the span in which the host launched it.

The program opens ``record_function`` ranges (``telemetry.span``) in its
block loop while a profiler records.  ``trace.py``'s ``Trace`` keeps
them among its host ops but not which call launched each device
activity, so a traced run whose trace shows any of the program's spans
profiles the cell's experiments once more, after the window, keeping
both: each device activity is paired with the CUDA API call that
launched it by ``correlation_id()``.  A program without the spans (an
older commit) is not profiled again, and the readers leave their
metrics out.
"""
from __future__ import annotations

import bisect
import sys
from typing import Callable, List, Optional, Tuple

import torch

from portbench.harness import trace

#: the program's spans in the block loop that the readers look for
PROGRAM = ("engine.block", "engine.draws", "engine.sweep", "summary.block",
           "attribution.block", "attribution.tail_pilot")
#: the least share of device time whose launch must be found
LINKED_MIN = 0.99
#: host calls of the CUDA APIs (``cudaLaunchKernel``, ``cuLaunchKernel``, ...):
#: those that launch device work share a correlation id with it
LAUNCH_PREFIX = "cu"
#: the experiment paths of the second profiled pass, never a window's
SPAN_PATH = 1 << 41
Intervals = List[Tuple[float, float]]


class Unlinked(ValueError):
    """Too little of a trace's device time found the call that
    launched it."""


def _intersect(a: Intervals, b: Intervals) -> Intervals:
    """The overlap of two disjoint, ordered interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a: Intervals, b: Intervals) -> Intervals:
    """``a`` less ``b`` (both disjoint and ordered)."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while lo < hi and k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if lo < hi:
            out.append((lo, hi))
    return out


def _inside(t: float, ivs: Intervals) -> bool:
    k = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return k >= 0 and ivs[k][0] <= t <= ivs[k][1]


class Linked(trace.Trace):
    """A ``Trace`` whose device activities know when they were launched.

    ``launched[i]`` is the host time at which ``device[i]`` was launched
    (``None`` where no launch was found), and ``spans`` the program's
    spans.  Under ``LINKED_MIN`` of the window's device time linked to
    its launch raises ``Unlinked``.  Every reading of ``Trace`` is as
    it would be without the links and the spans.
    """

    def __init__(self, device: List[trace.Span], host: List[trace.Span],
                 launched: List[Optional[float]], spans: List[trace.Span]):
        super().__init__(device, host)
        self.launched = [t for s, t in zip(device, launched)
                         if s[2] > self.lo and s[1] < self.hi]
        self.spans = sorted(spans, key=lambda s: s[1])
        total = self.device_s()
        found = sum(hi - lo for (_, lo, hi), t in
                    zip(self.device, self.launched) if t is not None)
        if total > 0 and found < LINKED_MIN * total:
            raise Unlinked(f"the launch of {found / total:.2%} of the "
                           f"device time was found; {LINKED_MIN:.0%} needed")

    def _open(self, names) -> Intervals:
        """The host time in which a program span in ``names`` was open."""
        return trace.union([(lo, hi) for n, lo, hi in self.spans
                            if n in names])

    def span_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def launched_in(self, name: str) -> float:
        """Summed device time of activities launched while a program
        span ``name`` was open, at any depth."""
        ivs = self._open({name})
        return sum(hi - lo for (_, lo, hi), t in zip(self.device,
                                                     self.launched)
                   if t is not None and _inside(t, ivs))

    def launched_share(self, name: str) -> Optional[float]:
        """``launched_in(name)`` over all device time, in %; ``None``
        where nothing was launched in such a span."""
        total, mine = self.device_s(), self.launched_in(name)
        if total <= 0 or mine <= 0:
            return None
        return 100.0 * mine / total

    def idle_in(self, names, outside=()) -> float:
        """The card's idle time in the window while a program span in
        ``names`` was open and none in ``outside`` was."""
        idle = _subtract([(self.lo, self.hi)], self.busy_intervals())
        held = _subtract(self._open(set(names)), self._open(set(outside)))
        return sum(hi - lo for lo, hi in _intersect(idle, held))


def _annotation(e) -> bool:
    """A ``record_function`` range, or its mirror on the device's
    timeline (``gpu_user_annotation``): no work ran on the card in it.
    Read from the activity type where the event does not say."""
    if e.name() == trace.LABEL:
        return True
    f = getattr(e, "is_user_annotation", None)
    if f is not None:
        return bool(f())
    kind = getattr(e, "activity_type", None)
    return kind is not None and str(kind()) in ("user_annotation",
                                                "gpu_user_annotation")


def from_events(events) -> Linked:
    """A ``Linked`` trace of the profiler's events (``kineto_results``):
    each device activity paired with the CUDA API call that launched it
    by correlation id (torch ops number theirs apart, so only the API's
    calls are matched); the program's spans are the host ranges that are
    user annotations, the benchmark's own label aside."""
    device, host, spans = [], [], []
    launch_at, corr = {}, []
    for e in events:
        lo = trace._ns(e, "start") * 1e-9
        span = (e.name(), lo, lo + trace._ns(e, "duration") * 1e-9)
        if not trace._is_device(e):
            host.append(span)
            if _annotation(e):
                if e.name() != trace.LABEL:
                    spans.append(span)
            elif e.name().startswith(LAUNCH_PREFIX):
                launch_at[e.correlation_id()] = lo
        elif not _annotation(e):
            device.append(span)
            corr.append(e.correlation_id())
    return Linked(device, host, [launch_at.get(c) for c in corr], spans)


def capture(fn: Callable[[], object]) -> Linked:
    """``fn`` run under the profiler, as a ``Linked`` trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return from_events(prof.profiler.kineto_results.events())


def has_spans(tr: Optional[trace.Trace]) -> bool:
    """Whether the program opened any of its loop's spans in ``tr``."""
    return tr is not None and any(n in PROGRAM for n, _, _ in tr.host)


def _profile(ctx) -> Linked:
    count = ctx.profiled_experiments

    def experiments():
        for i in range(count):
            with torch.profiler.record_function(trace.LABEL):
                ctx.cell.entry.run(ctx, ctx.source((SPAN_PATH + i,)))

    for _ in range(2):
        try:
            tr = capture(experiments)
        except Unlinked as e:
            print(f"profiler: {e}", file=sys.stderr)
            continue
        names = sorted({n for n, _, _ in tr.spans})
        print("program spans an experiment: " + ", ".join(
            f"{n} {tr.span_count(n) / count:g}" for n in names),
            file=sys.stderr)
        return tr
    raise RuntimeError("the profiler lost the launch of device time twice; "
                       "no reading of the program's spans")


def of(ctx) -> Optional[Linked]:
    """The run's ``Linked`` trace of the program's spans, profiled once a
    run and kept on ``ctx``; ``None`` off the card, in an untraced run,
    or where the program opened none of its spans."""
    if "span_trace" not in vars(ctx):
        traced = ctx.device.type == "cuda" and has_spans(ctx.trace)
        ctx.span_trace = _profile(ctx) if traced else None
    return ctx.span_trace
