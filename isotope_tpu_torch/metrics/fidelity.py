"""Ground-truth fidelity check against a real Fortio artifact.

The port of ``isotope_tpu.metrics.fidelity``.  The north star's fidelity
clause is "p99 within 5% of a real Fortio run" (BASELINE.json).  The
evidence chain starts from real ``fortio load -json`` output (the
artifact whose schema ``perf/benchmark/runner/fortio.py:38-75``
flattens, and which ``metrics/fortio.py`` emits for simulated runs):
ingest an actual Fortio result JSON, reconstruct the matching load
(closed-loop workers at the artifact's NumThreads / RequestedQPS, or
``-qps max`` saturation), simulate the topology on the device, and diff
the sim's percentiles against the artifact's, percentile by percentile.

Simulation knobs that the artifact cannot carry (service-time
distribution, CPU demand, the environment's sidecar tax) are passed by
the caller: measure once on the cluster, then tune ``SimParams`` until
the report is inside the clause.  The run draws from
``TorchDraws(seed)`` (the reference's ``PRNGKey(seed)``), looked up
when called so that a test can hand it the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PercentileDelta:
    """One artifact-vs-sim percentile comparison (seconds)."""

    percentile: float
    fortio_s: float
    sim_s: float

    @property
    def rel_err(self) -> float:
        if self.fortio_s <= 0:
            return math.inf if self.sim_s > 0 else 0.0
        return self.sim_s / self.fortio_s - 1.0


@dataclasses.dataclass(frozen=True)
class FidelityReport:
    deltas: List[PercentileDelta]
    actual_qps_fortio: float
    actual_qps_sim: float
    error_percent_fortio: float
    error_percent_sim: float
    tolerance: float

    @property
    def ok(self) -> bool:
        # vacuous truth is failure: a gate that compared nothing must
        # not report PASS (empty Percentiles happens on tiny runs)
        return bool(self.deltas) and all(
            abs(d.rel_err) <= self.tolerance for d in self.deltas
        )

    def lines(self) -> List[str]:
        out = [
            f"{'pctile':>8} {'fortio':>12} {'sim':>12} {'delta':>8}",
        ]
        for d in self.deltas:
            mark = "" if abs(d.rel_err) <= self.tolerance else "  OUT"
            out.append(
                f"{d.percentile:>8g} {d.fortio_s * 1e3:>10.3f}ms "
                f"{d.sim_s * 1e3:>10.3f}ms {d.rel_err:>+7.2%}{mark}"
            )
        out.append(
            f"   qps: fortio {self.actual_qps_fortio:.1f} vs sim "
            f"{self.actual_qps_sim:.1f}; errors: "
            f"{self.error_percent_fortio:.2f}% vs "
            f"{self.error_percent_sim:.2f}%"
        )
        if self.ok:
            out.append(
                f"   PASS: all percentiles within "
                f"{self.tolerance:.0%} of the Fortio artifact"
            )
        elif not self.deltas:
            out.append(
                "   FAIL: the artifact carried no comparable "
                "percentiles — nothing was checked"
            )
        else:
            out.append(
                f"   FAIL: at least one percentile beyond "
                f"{self.tolerance:.0%}"
            )
        return out


def load_from_artifact(doc: dict, connections_default: int = 64):
    """(LoadModel, duration_s) reconstructed from a Fortio result JSON.

    ``RequestedQPS`` is a number or the string "max" (runner.py's
    ``-qps max``); ``NumThreads`` is ``-c``; ``ActualDuration`` is in
    nanoseconds (the Go time.Duration encoding the reference divides
    by 1e9, fortio.py:58).
    """
    from isotope_tpu_torch.sim.config import LoadModel

    req = doc.get("RequestedQPS", "max")
    conns = int(doc.get("NumThreads", connections_default))
    if isinstance(req, str) and req == "max":
        load = LoadModel(kind="closed", qps=None, connections=conns)
    else:
        load = LoadModel(
            kind="closed", qps=float(req), connections=conns
        )
    duration_s = float(doc.get("ActualDuration", 0)) / 1e9
    return load, duration_s


def check_fidelity(
    doc: dict,
    topology_yaml: str,
    params=None,
    tolerance: float = 0.05,
    max_requests: int = 1_000_000,
    percentiles: Optional[Sequence[float]] = None,
    entry: Optional[str] = None,
    seed: int = 0,
    device=None,
) -> FidelityReport:
    """Simulate the artifact's run and diff percentiles.

    ``doc`` is a parsed ``fortio load -json`` result; ``topology_yaml``
    the service-graph YAML text the cluster ran.  The request count is
    the artifact's own census (ActualQPS x duration) capped at
    ``max_requests``.  ``device`` is the Simulator's (CUDA unless
    given; raises without a GPU).
    """
    from isotope_tpu_torch import sim as sim_pkg
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim.config import SimParams
    from isotope_tpu_torch.sim.engine import Simulator

    params = params or SimParams()
    load, duration_s = load_from_artifact(doc)
    actual_qps = float(doc.get("ActualQPS", 0.0))
    n = int(min(max(actual_qps * duration_s, 10_000), max_requests))

    graph = ServiceGraph.from_yaml(topology_yaml)
    sim = Simulator(compile_graph(graph, entry=entry), params,
                    device=device)
    summary = sim.run_summary(load, n, sim_pkg.TorchDraws(seed, sim.device))

    h = doc["DurationHistogram"]
    wanted = (
        [float(p["Percentile"]) for p in h["Percentiles"]]
        if percentiles is None
        else list(percentiles)
    )
    ref_vals = {float(p["Percentile"]): float(p["Value"])
                for p in h["Percentiles"]}
    qs = [p / 100.0 for p in wanted]
    sim_vals = summary.quantiles_s(tuple(qs))
    deltas = [
        PercentileDelta(p, ref_vals.get(p, float("nan")), float(sv))
        for p, sv in zip(wanted, np.asarray(sim_vals))
        if p in ref_vals
    ]

    count = float(doc.get("Sizes", {}).get("Count", 0.0)) or float(
        sum(doc.get("RetCodes", {}).values())
    )
    ok_ref = float(doc.get("RetCodes", {}).get("200", 0))
    err_ref = 100.0 * (count - ok_ref) / count if count else 0.0
    sim_count = float(summary.count)
    err_sim = (
        100.0 * float(summary.error_count) / sim_count
        if sim_count else 0.0
    )
    sim_qps = (
        sim_count / float(summary.end_max)
        if float(summary.end_max) > 0 else 0.0
    )
    return FidelityReport(
        deltas=deltas,
        actual_qps_fortio=actual_qps,
        actual_qps_sim=sim_qps,
        error_percent_fortio=err_ref,
        error_percent_sim=err_sim,
        tolerance=tolerance,
    )
