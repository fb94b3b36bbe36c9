"""Importance splitting: rare-outage probability estimation.

The port of ``isotope_tpu.sim.splitting``.  A multilevel splitting /
subset-simulation estimator (Au & Beck) over a fleet's draws: run a
short-horizon fleet, rank its members by a severity statistic, clone the
worst quantile with redrawn components across K levels (one fleet a
level), and combine the level conditionals into a rare-event
probability with a variance estimate.

A member's randomness decomposes into one CHAOS seed per chaos event
(its jittered timing, target and magnitude,
``resilience/faults.ChaosJitterSpec``) and one WORK seed (the workload
draws).  Each level conditions on ``severity >= T_l``; each clone takes
one Metropolis step whose proposal redraws each chaos component with
probability ``chaos_prob`` and the work seed with ``work_prob`` from the
prior, accepted iff its severity clears ``T_l``.  The product estimator
is consistent; the reported variance uses the independence
approximation ``cv^2 ~= sum_l (1 - p_l) / (p_l N)``.  A COMMON event
(``p >= keep`` at level 0) short-circuits to the plain Monte Carlo
estimate.

:class:`SplitSpec`, :func:`parse_split_spec`, :func:`subset_estimate`
and :func:`severity_scores` are host code copied from the reference
(numpy), so the same severities give the same document;
:func:`severity_scores_device` is the torch twin the search brackets
rank by (``sim/search.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from isotope_tpu_torch.sim.ensemble import wilson_interval

#: the splitting block's schema key inside ``<label>.ensemble.json``
#: (isotope-ensemble/v2)
SPLIT_SCHEMA = "isotope-splitting/v1"

#: severity statistics the estimator can rank members by
#: ("trips" ranks PROTECTED fleets by breaker-trip + budget-ejection
#: events — the severity channel protected search brackets screen on)
SEVERITIES = ("err_peak", "err_share", "p99", "trips")


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """One splitting estimate's configuration.

    ``threshold`` defines the rare event (``severity >= threshold``);
    ``keep`` is the survivor fraction per level (the level quantile is
    ``1 - keep``); ``members`` is the fleet width per level, so the
    total simulation budget is at most ``levels * members`` member
    runs; ``horizon`` scales the per-member request count (splitting
    fleets are screening fleets — a short horizon ranks severity
    almost as well as the full run at a fraction of the cost);
    ``chaos_prob`` / ``work_prob`` are the proposal's per-component
    redraw probabilities.
    """

    levels: int = 4
    members: int = 64
    keep: float = 0.25
    threshold: float = 0.5
    severity: str = "err_peak"
    horizon: float = 0.25
    slo_s: Optional[float] = None   # the p99 severity's latency unit
    chaos_prob: float = 0.5
    work_prob: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError("splitting levels must be >= 1")
        if self.members < 2:
            raise ValueError("splitting members must be >= 2")
        if not 0.0 < self.keep < 1.0:
            raise ValueError(
                "splitting keep (survivor fraction) must lie in (0, 1)"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown splitting severity {self.severity!r} "
                f"(one of {SEVERITIES})"
            )
        if not 0.0 < self.horizon <= 1.0:
            raise ValueError("splitting horizon must lie in (0, 1]")
        if not 0.0 <= self.chaos_prob <= 1.0:
            raise ValueError("splitting chaos_prob must lie in [0, 1]")
        if not 0.0 <= self.work_prob <= 1.0:
            raise ValueError("splitting work_prob must lie in [0, 1]")

    @property
    def budget(self) -> int:
        """The worst-case member-run budget of one estimate."""
        return self.levels * self.members

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_split_spec(text: Optional[str]) -> Optional[SplitSpec]:
    """Parse the CLI/TOML spec, e.g.
    ``"levels=4,members=64,keep=0.25,threshold=0.5,sev=err_peak"``.
    ``"off"`` / empty returns None.  Unknown keys are errors — a
    typo'd knob must not silently run the defaults."""
    if not text or str(text).strip().lower() in ("off", "0", "false"):
        return None
    kw: dict = {}
    keys = {
        "levels": ("levels", int),
        "members": ("members", int),
        "keep": ("keep", float),
        "threshold": ("threshold", float),
        "sev": ("severity", str),
        "severity": ("severity", str),
        "horizon": ("horizon", float),
        "slo": ("slo_s", float),
        "chaos_prob": ("chaos_prob", float),
        "work_prob": ("work_prob", float),
        "seed": ("seed", int),
    }
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad splitting spec entry {part!r} (expected "
                f"key=value; keys: {', '.join(sorted(keys))})"
            )
        k, v = part.split("=", 1)
        k = k.strip().lower()
        if k not in keys:
            raise ValueError(
                f"unknown splitting spec key {k!r} (expected one of "
                f"{', '.join(sorted(keys))})"
            )
        name, conv = keys[k]
        kw[name] = conv(v.strip())
    return SplitSpec(**kw)


class _Draws:
    """One level's population: chaos (N, C) + work (N,) seed arrays."""

    def __init__(self, chaos: np.ndarray, work: np.ndarray):
        self.chaos = np.asarray(chaos, np.int64)
        self.work = np.asarray(work, np.int64)

    def take(self, idx) -> "_Draws":
        return _Draws(self.chaos[idx], self.work[idx])


def _fresh(rng: np.random.Generator, shape) -> np.ndarray:
    # 31-bit positive seeds: safe as uint32 fold-in indices and in JSON
    return rng.integers(1, 2**31 - 1, size=shape, dtype=np.int64)


def subset_estimate(
    evaluate: Callable[[np.ndarray, np.ndarray], np.ndarray],
    spec: SplitSpec,
    chaos_components: int = 1,
) -> dict:
    """Estimate ``P(severity >= spec.threshold)`` by subset simulation.

    ``evaluate(chaos_seeds, work_seeds) -> severities`` runs one fleet
    of ``N = spec.members`` members (``chaos_seeds`` is ``(N, C)``
    with one column per chaos component, ``work_seeds`` ``(N,)``) and
    returns their severity scores — ONE call per level, so the engine
    backs it with one fleet a level.  Deterministic given
    ``spec.seed``.

    Returns the ``isotope-splitting/v1`` dict: ``p`` (the estimate),
    ``cv`` / ``ci_lo`` / ``ci_hi`` (delta-method, independence
    approximation), per-level records, and the member-run budget
    actually spent.
    """
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed]))
    N = spec.members
    C = max(int(chaos_components), 1)
    draws = _Draws(_fresh(rng, (N, C)), _fresh(rng, N))
    sev = np.asarray(evaluate(draws.chaos, draws.work), np.float64)
    if sev.shape != (N,):
        raise ValueError(
            f"evaluate returned shape {sev.shape}, expected ({N},)"
        )
    evals = N
    levels = []
    log_p = 0.0
    cv2 = 0.0
    p_final = None
    for level in range(spec.levels):
        above = float((sev >= spec.threshold).mean())
        last = level == spec.levels - 1
        # the intermediate threshold: the survivor quantile, clamped
        # at the target — once the population reaches the event, the
        # remaining fraction is the final conditional
        T = float(np.quantile(sev, 1.0 - spec.keep))
        if above >= spec.keep or T >= spec.threshold or last:
            p_final = above
            levels.append({
                "level": level, "threshold": spec.threshold,
                "p_level": above, "final": True,
            })
            break
        surv = np.nonzero(sev >= T)[0]
        if len(surv) == 0:  # degenerate population (constant severity)
            p_final = 0.0
            levels.append({
                "level": level, "threshold": T,
                "p_level": 0.0, "final": True,
            })
            break
        p_l = len(surv) / N
        levels.append({
            "level": level, "threshold": T, "p_level": p_l,
            "final": False,
        })
        log_p += float(np.log(p_l))
        cv2 += (1.0 - p_l) / (p_l * N)
        # clone-and-continue: survivors cycle over the N slots, each
        # clone takes one Metropolis step with the component-wise
        # prior proposal (re-folded keys)
        slot = surv[np.arange(N) % len(surv)]
        parents = draws.take(slot)
        sev_par = sev[slot]
        prop = _Draws(
            np.where(
                rng.random((N, C)) < spec.chaos_prob,
                _fresh(rng, (N, C)), parents.chaos,
            ),
            np.where(
                rng.random(N) < spec.work_prob,
                _fresh(rng, N), parents.work,
            ),
        )
        sev_prop = np.asarray(
            evaluate(prop.chaos, prop.work), np.float64
        )
        evals += N
        accept = sev_prop >= T
        draws = _Draws(
            np.where(accept[:, None], prop.chaos, parents.chaos),
            np.where(accept, prop.work, parents.work),
        )
        sev = np.where(accept, sev_prop, sev_par)
    assert p_final is not None
    if p_final > 0.0:
        p = float(np.exp(log_p) * p_final)
        cv2 += (1.0 - p_final) / (p_final * N)
    else:
        p = 0.0
    cv = float(np.sqrt(cv2)) if p > 0 else 0.0
    # lognormal-shaped CI: multiplicative error keeps the bound
    # positive where the rare estimate sits orders below 1
    z = 1.959963984540054  # norm_ppf(0.975)
    ci = (
        (p * np.exp(-z * cv), min(1.0, p * np.exp(z * cv)))
        if p > 0
        else (0.0, wilson_interval(0, spec.budget)[1])
    )
    return {
        "schema": SPLIT_SCHEMA,
        "spec": spec.to_dict(),
        "p": p,
        "cv": cv,
        "ci_lo": float(ci[0]),
        "ci_hi": float(ci[1]),
        "levels": levels,
        "evaluations": int(evals),
        "accept_note": (
            "variance assumes independent level samples; correlated "
            "clone chains understate it"
        ),
    }


# -- severity statistics ------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def severity_scores(
    spec: SplitSpec,
    summaries,
    timelines=None,
    policies=None,
) -> np.ndarray:
    """Per-member severity from a fleet's stacked outputs (float64, on
    the host).

    - ``err_peak``: the PEAK per-window client error share from the
      recorder windows (``timelines``); falls back to ``err_share``
      when no timeline rode the fleet;
    - ``err_share``: the run-long client error share;
    - ``p99``: the member's p99 latency in units of ``spec.slo_s``;
    - ``trips``: breaker trips + retry-budget ejections summed over
      services from the stacked ``PolicySummary`` (``policies``); falls
      back to ``err_share`` without one.
    """
    if spec.severity == "trips" and policies is not None:
        trips = _np(policies.trips).astype(np.float64)       # (N, S)
        ej = _np(policies.ejections).astype(np.float64)      # (N, S)
        return trips.sum(axis=-1) + ej.sum(axis=-1)
    if spec.severity == "p99":
        if spec.slo_s is None or spec.slo_s <= 0:
            raise ValueError(
                "p99 splitting severity needs slo= (the latency that "
                "maps to severity 1.0)"
            )
        from isotope_tpu_torch.metrics.histogram import (
            quantile_from_histogram,
        )

        hists = _np(summaries.latency_hist).astype(np.float64)
        p99 = np.asarray([
            quantile_from_histogram(h, (0.99,))[0] for h in hists
        ])
        return p99 / float(spec.slo_s)
    if spec.severity == "err_peak" and timelines is not None:
        arr = _np(timelines.arrivals).astype(np.float64)   # (N, W)
        err = _np(timelines.errors).astype(np.float64)     # (N, W)
        share = err / np.maximum(arr, 1.0)
        return share.max(axis=1)
    counts = _np(summaries.count).astype(np.float64)
    errs = _np(summaries.error_count).astype(np.float64)
    return errs / np.maximum(counts, 1.0)


def severity_scores_device(
    severity: str,
    summaries,
    slo_s=None,
    policies=None,
) -> torch.Tensor:
    """The torch twin of :func:`severity_scores` over a member-stacked
    fleet summary, on the summary's device in float32 and the
    reference's op order: the rank channel of the search brackets
    (``sim/search.py``), whose scores feed a stable sort and a gather
    without leaving the device.  ``p99`` is the SLO-violation depth
    through :func:`~isotope_tpu_torch.metrics.histogram.
    quantile_from_histogram_device`; ``err_peak`` falls back to
    ``err_share`` (no recorder rides a search fleet); ``trips`` sums
    breaker trips and budget ejections of the stacked ``PolicySummary``
    (``policies``), falling back to ``err_share`` on plain fleets."""
    if severity == "trips" and policies is not None:
        trips = policies.trips.to(torch.float32)
        ej = policies.ejections.to(torch.float32)
        return trips.sum(-1) + ej.sum(-1)
    if severity == "p99":
        if slo_s is None or slo_s <= 0:
            raise ValueError(
                "p99 search severity needs slo= (the latency that "
                "maps to severity 1.0)"
            )
        from isotope_tpu_torch.metrics.histogram import (
            quantile_from_histogram_device,
        )

        p99 = quantile_from_histogram_device(summaries.latency_hist, 0.99)
        # the reference's compiled rank step divides by the constant as
        # XLA lowers it: a product with its float32 reciprocal
        slo = torch.tensor(float(slo_s), dtype=torch.float32,
                           device=p99.device)
        return p99 * (1.0 / slo)
    counts = summaries.count.to(torch.float32)
    errs = summaries.error_count.to(torch.float32)
    return errs / torch.clamp(counts, min=1.0)
