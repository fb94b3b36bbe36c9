"""The comparison that decides ``correct``.

Each judged run of the program (one experiment, or one member of a
fleet) is reduced on the host to the numbers its summary carries, and
held against the plain reference's run over the same streams.  Every
number is a gap the limit bounds from above:

- ``requests``: requests simulated, program minus reference (exact);
- ``errors``: client-visible errors, program minus reference (exact);
- ``hop_events_gap``: relative gap of the executed hops;
- ``hist_moved``: share of requests whose latency bucket differs (half
  the L1 distance of the two histograms over the requests);
- ``mean_gap``: relative gap of the mean client latency;
- ``p50_gap`` / ``p99_gap``: relative gap of the histogram quantiles;
- ``util_gap``: largest relative gap of a service's utilization;

and of an attributed run's blame:

- ``crit_moved``: share of critical-path hop visits that differ;
- ``blame_gap``: largest relative L1 gap of the wait, self, wire and
  timeout blame vectors;
- ``blame_hist_moved``: share of path hops whose blame bucket differs;
- ``tail_cut_gap``: relative gap of the estimated tail cut;
- ``tail_count_gap``: relative gap of the requests past it;
- ``tail_moved``: the worst of the three above over the tail's sums;
- ``exemplar_gap``: largest relative gap of the top-K slowest latencies.

Over several judged runs each number is the worst of them.  An entry
that judges more names its numbers (``CHECKS``) and computes them
(``gaps(prog, ref)``); ``names`` gives every number a cell's limits may
hold.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional

import numpy as np

from portbench.reference.sim import quantile


class Run(NamedTuple):
    """One run's summary on the host."""

    count: float
    errors: float
    hop_events: float
    hist: np.ndarray
    latency_sum: float
    utilization: np.ndarray
    blame: Optional[Dict[str, np.ndarray]] = None


#: the numbers of every run's summary
SUMMARY = ("requests", "errors", "hop_events_gap", "hist_moved",
           "mean_gap", "p50_gap", "p99_gap", "util_gap")
#: the numbers of an attributed run's blame
BLAME = ("crit_moved", "blame_gap", "blame_hist_moved", "tail_cut_gap",
         "tail_count_gap", "tail_moved", "exemplar_gap")


def names(entry) -> tuple:
    """Every number a run of ``entry`` (an entry module) is judged by."""
    return SUMMARY + tuple(getattr(entry, "CHECKS", ()))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def gaps(prog: Run, ref: Run) -> Dict[str, float]:
    """Every number of one judged run."""
    mean_p = prog.latency_sum / max(prog.count, 1.0)
    mean_r = ref.latency_sum / max(ref.count, 1.0)
    u_ref = np.asarray(ref.utilization, np.float64)
    u_gap = np.abs(np.asarray(prog.utilization, np.float64) - u_ref)
    return {
        "requests": abs(prog.count - ref.count),
        "errors": abs(prog.errors - ref.errors),
        "hop_events_gap": _rel(prog.hop_events, ref.hop_events),
        "hist_moved": 0.5 * float(np.abs(
            np.asarray(prog.hist, np.float64) - ref.hist).sum())
        / max(ref.count, 1.0),
        "mean_gap": _rel(mean_p, mean_r),
        "p50_gap": _rel(quantile(prog.hist, 0.5), quantile(ref.hist, 0.5)),
        "p99_gap": _rel(quantile(prog.hist, 0.99), quantile(ref.hist, 0.99)),
        "util_gap": float((u_gap / np.maximum(u_ref, 1e-30)).max()),
    }


def entry_gaps(entry, prog: Run, ref: Run) -> Dict[str, float]:
    """Every number of one judged run of ``entry``: the summary's and
    the entry's own."""
    extra = getattr(entry, "gaps", None)
    return {**gaps(prog, ref), **(extra(prog, ref) if extra else {})}


def _l1(a, b) -> float:
    """L1 distance of two arrays relative to the second's L1 norm."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    norm = np.abs(b).sum()
    diff = np.abs(a - b).sum()
    return float(diff / norm) if norm else float(diff)


def blame_gaps(p: Dict[str, np.ndarray], r: Dict[str, np.ndarray]
               ) -> Dict[str, float]:
    vec = ("wait", "self", "net", "timeout")
    half = 0.5
    k = min(len(p["slowest"]), len(r["slowest"]))
    return {
        "crit_moved": _l1(p["crit"], r["crit"]),
        "blame_gap": max(_l1(p[v], r[v]) for v in vec),
        "blame_hist_moved": half * _l1(p["hist"], r["hist"]),
        "tail_cut_gap": _rel(float(p["tail_cut"]), float(r["tail_cut"])),
        "tail_count_gap": _rel(float(p["tail_count"]),
                               float(r["tail_count"])),
        "tail_moved": max([_l1(p["tail_crit"], r["tail_crit"]),
                           half * _l1(p["tail_hist"], r["tail_hist"])]
                          + [_l1(p["tail_" + v], r["tail_" + v])
                             for v in vec]),
        "exemplar_gap": max(
            [_rel(a, b) for a, b in zip(p["slowest"][:k], r["slowest"][:k])]
            + [float(len(p["slowest"]) != len(r["slowest"]))]),
    }


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """``(correct, {name: {"value", "limit"}})``: every number within
    its limit, and every limit read."""
    checks = {k: {"value": readings.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values()
    )
    return ok, checks
