"""Scenario ensembles: Monte Carlo fleets, in torch.

The port of ``isotope_tpu.sim.ensemble``.  One fleet is N members, each
a full run of the same topology under its own draws and its own
perturbations:

- :class:`EnsembleSpec` declares the fleet: member seeds (the draw
  axis: member k draws from ``RootedSource(source, seeds[k])``, the
  reference's ``fold_in(key, seed)``) plus optional per-member
  multiplicative perturbations of the offered qps, the per-request CPU
  demand and the per-hop error rates;
- :class:`EnsembleSummary` holds the per-member
  :class:`~isotope_tpu_torch.sim.summary.RunSummary` stack (tensors with
  a leading member axis) and the distributional reductions: per-member
  quantiles, quantile bands across members, SLO-violation
  probabilities with Wilson intervals, the severity ranking and the
  worst-member postmortem;
- :func:`wilson_interval` and :func:`norm_ppf` are the closed forms of
  the reference (float64 on the host).

``EnsembleSpec.mode`` picks how the engine runs the member axis of
every fleet (``Simulator.run_ensemble``, ``run_policies_ensemble``,
``run_rollouts_ensemble``, the search brackets and the splitting
levels): ``"map"`` runs the members one after another through the solo
block loop, so member k is bit-equal to its solo run; ``"vmap"`` folds
a chunk of M members into one block of M x N request rows, chaos fleets
with each member's chaos tables, protected fleets with their control
laws over an (M, S) state, observed fleets with their reductions binned
by member.  ``None`` resolves per device: ``"vmap"`` on CUDA, ``"map"``
on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: artifact schema tag (runner/run.py writes ``<label>.ensemble.json``)
#: — v2 adds the schema-versioned ``splitting`` block (importance
#: splitting, ROADMAP item 9), the protected-fleet severity/worst-
#: member block, and the per-member chaos marker; v1 documents remain
#: readable (see :func:`doc_member_quantiles`)
DOC_SCHEMA = "isotope-ensemble/v2"
DOC_SCHEMAS = ("isotope-ensemble/v1", "isotope-ensemble/v2")

#: quantiles reported per member in the artifact / tables
DOC_QUANTILES = (0.5, 0.9, 0.99)


def _scale_array(x, n: int, what: str) -> Optional[np.ndarray]:
    if x is None:
        return None
    a = np.asarray(x, np.float64)
    if a.shape != (n,):
        raise ValueError(
            f"{what} must have shape ({n},) to match the member count; "
            f"got {a.shape}"
        )
    if not np.all(np.isfinite(a)) or (a <= 0).any():
        raise ValueError(f"{what} entries must be finite and positive")
    return a


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    """One Monte Carlo fleet: seeds + per-member perturbations.

    ``seeds`` are the fold indices deriving each member's RNG key
    (``fold_in(run_key, seed)``); duplicates make two members
    bit-identical copies, which is almost always a configuration bug —
    the vet gate errors on them (VET-T023) and ``run_ensemble``
    rejects them unless explicit per-member keys override the seed
    derivation (the runner's same-shape case collapse does).

    The scale leaves are multiplicative and mean-1 by convention
    (:meth:`from_jitter` draws mean-preserving lognormal factors):

    - ``qps_scale`` multiplies the offered rate (open loop) / target
      qps (closed loop) — it sets the member's own rate, so it is
      exact;
    - ``cpu_scale`` multiplies the per-request CPU demand: service
      draws scale by s and every station's mu scales by 1/s inside
      the wait law (engine ``_simulate_core``).  The
      closed-loop equilibrium rate and the host-side retry-feedback
      visit fixed point are solved at the BASE cpu (a second-order
      approximation, documented on ``Simulator.run_ensemble``);
    - ``error_scale`` multiplies the per-hop error rates (clipped to
      [0, 1]); statically-zero rates stay zero.

    ``chunk`` caps how many members fold into one block (``"vmap"``);
    None lets the engine pre-compute it from the cost model's
    plan-only peak bytes against the device's memory
    (``analysis/costmodel.ensemble_chunk``).

    ``mode`` selects how the engine runs the member axis —
    ``"vmap"`` (a chunk of M members folds into one block of M x N
    request rows: one census call of ``(M*N, B, P)`` a level, per-member
    scalars broadcast to their rows) or ``"map"`` (the members run one
    after another through the solo block loop, at the solo shapes).
    ``None`` auto-selects per device: vmap on CUDA, map on the CPU.
    Member k of a ``"map"`` fleet is bit-identical to its solo run; a
    ``"vmap"`` member equals it in its integers and within float32
    summation order in its float sums.
    """

    seeds: Tuple[int, ...]
    qps_scale: Optional[np.ndarray] = None
    cpu_scale: Optional[np.ndarray] = None
    error_scale: Optional[np.ndarray] = None
    chunk: Optional[int] = None
    mode: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(
            self, "seeds", tuple(int(s) for s in self.seeds)
        )
        n = len(self.seeds)
        for name in ("qps_scale", "cpu_scale", "error_scale"):
            object.__setattr__(
                self, name,
                _scale_array(getattr(self, name), n, name),
            )
        if self.chunk is not None and self.chunk < 1:
            raise ValueError("chunk must be >= 1 (or None = auto)")
        if self.mode not in (None, "vmap", "map"):
            raise ValueError(
                f"unknown ensemble mode {self.mode!r} (expected "
                "'vmap', 'map', or None = auto)"
            )

    def resolved_mode(self, device=None) -> str:
        """The concrete batching mode (auto resolves per device:
        ``"vmap"`` on CUDA, ``"map"`` on the CPU)."""
        if self.mode is not None:
            return self.mode
        return (
            "vmap"
            if device is not None and torch.device(device).type == "cuda"
            else "map"
        )

    @property
    def members(self) -> int:
        return len(self.seeds)

    @property
    def jittered(self) -> bool:
        """True when any per-member physics perturbation is armed
        (the engine then passes the members' scales to each block)."""
        return (
            self.cpu_scale is not None or self.error_scale is not None
        )

    def check(self, allow_duplicate_seeds: bool = False) -> None:
        """Run-entry validation (the loud version of VET-T023)."""
        if self.members == 0:
            raise ValueError(
                "ensemble spec has zero members (VET-T023)"
            )
        if not allow_duplicate_seeds and (
            len(set(self.seeds)) != self.members
        ):
            dupes = sorted(
                {s for s in self.seeds if self.seeds.count(s) > 1}
            )
            raise ValueError(
                f"ensemble spec has duplicate member seeds {dupes} "
                "(VET-T023): duplicated members are bit-identical "
                "copies, not extra Monte Carlo samples"
            )

    @classmethod
    def of(cls, members: int, chunk: Optional[int] = None,
           mode: Optional[str] = None) -> "EnsembleSpec":
        """The plain seeds-only fleet: seeds 0..members-1."""
        return cls(seeds=tuple(range(int(members))), chunk=chunk,
                   mode=mode)

    @classmethod
    def from_jitter(
        cls,
        members: int,
        *,
        qps_jitter: float = 0.0,
        cpu_jitter: float = 0.0,
        error_jitter: float = 0.0,
        jitter_seed: int = 0,
        chunk: Optional[int] = None,
        mode: Optional[str] = None,
    ) -> "EnsembleSpec":
        """Seeds 0..N-1 plus deterministic lognormal perturbations.

        Each jitter is the log-space sigma of a mean-preserving
        lognormal factor ``exp(sigma Z - sigma^2 / 2)`` drawn from a
        host RNG seeded by ``jitter_seed`` — the same fleet spec
        reproduces bit-identical scale tables on every host.
        """
        members = int(members)
        for name, j in (("qps_jitter", qps_jitter),
                        ("cpu_jitter", cpu_jitter),
                        ("error_jitter", error_jitter)):
            if j < 0:
                raise ValueError(f"{name} must be >= 0")
        rng = np.random.default_rng(int(jitter_seed))

        def draw(sigma):
            # one draw per axis regardless of arming keeps the axes'
            # streams independent of which jitters are on
            z = rng.standard_normal(max(members, 1))
            if sigma <= 0:
                return None
            return np.exp(sigma * z - 0.5 * sigma * sigma)

        qps = draw(qps_jitter)
        cpu = draw(cpu_jitter)
        err = draw(error_jitter)
        return cls(
            seeds=tuple(range(members)),
            qps_scale=qps, cpu_scale=cpu, error_scale=err,
            chunk=chunk, mode=mode,
        )

    def to_dict(self) -> dict:
        return {
            "seeds": list(self.seeds),
            "qps_scale": (
                None if self.qps_scale is None
                else [float(x) for x in self.qps_scale]
            ),
            "cpu_scale": (
                None if self.cpu_scale is None
                else [float(x) for x in self.cpu_scale]
            ),
            "error_scale": (
                None if self.error_scale is None
                else [float(x) for x in self.error_scale]
            ),
            "chunk": self.chunk,
            "mode": self.mode,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EnsembleSpec":
        return cls(
            seeds=tuple(d["seeds"]),
            qps_scale=d.get("qps_scale"),
            cpu_scale=d.get("cpu_scale"),
            error_scale=d.get("error_scale"),
            chunk=d.get("chunk"),
            mode=d.get("mode"),
        )


def wilson_interval(k: float, n: float, confidence: float = 0.95
                    ) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion k/n.

    The interval of choice for small-N rare-event estimates: unlike
    the Wald interval it never collapses to width 0 at k in {0, n}
    and never leaves [0, 1].  ``confidence`` maps to the normal
    quantile via the Acklam/Beasley-Springer inverse-normal
    approximation (|relative error| < 1.2e-9 — closed form, no scipy).
    """
    n = float(n)
    if n <= 0:
        return (0.0, 1.0)
    if not 0.0 < confidence < 1.0:
        raise ValueError("confidence must lie in (0, 1)")
    z = norm_ppf(0.5 + confidence / 2.0)
    p = float(k) / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (
        z / denom * np.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    )
    return (float(max(0.0, center - half)),
            float(min(1.0, center + half)))


def norm_ppf(q: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    A float64 closed form on the host (|rel err| < 1.2e-9), as in the
    reference, rather than a float32 device call."""
    if not 0.0 < q < 1.0:
        raise ValueError("q must lie in (0, 1)")
    # coefficients from Acklam (2003); relative error < 1.15e-9
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low = 0.02425
    if q < p_low:
        u = np.sqrt(-2.0 * np.log(q))
        return (
            (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
             * u + c[5])
            / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1.0)
        )
    if q > 1.0 - p_low:
        return -norm_ppf(1.0 - q)
    u = q - 0.5
    t = u * u
    return (
        (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t + a[4])
         * t + a[5]) * u
        / (((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t + b[4])
           * t + 1.0)
    )


def tree_map(fn, tree):
    """``fn`` over every tensor or array leaf of a (nested) NamedTuple,
    tuple, list or dict; ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_stack(trees):
    """Stack per-member NamedTuples along a new leading member axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_stack(xs) for xs in zip(*trees)))
    return torch.stack(trees)


def tree_cat(trees):
    """Concatenate member-stacked NamedTuples along the member axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_cat(xs) for xs in zip(*trees)))
    return torch.cat(trees)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def member_summary(stacked, k: int):
    """Member ``k``'s summary sliced out of a stacked one (every leaf
    carries a leading member axis; ``metrics`` is None on fleets)."""
    return tree_map(lambda x: x[k], stacked)


@dataclasses.dataclass(frozen=True)
class EnsembleSummary:
    """The reduced view of one ensemble dispatch.

    ``summaries`` is a :class:`~isotope_tpu_torch.sim.summary.RunSummary`
    whose leaves carry a leading ``(N,)`` member axis (``metrics`` is
    None — the per-service collector series stay out of the fleet).
    Everything distributional derives from the per-member windowed
    latency histograms, so the fleet's footprint is O(N * buckets),
    never O(N * requests).
    """

    spec: EnsembleSpec
    summaries: object  # RunSummary with (N,)-leading leaves
    offered_qps: np.ndarray  # (N,) per-member offered rate actually run
    chunk: int               # members per device dispatch actually used
    # -- chaos fleets ---------------------------------------------------
    # per-member jittered ChaosEvent tuples (None = every member ran
    # the base schedule); protected fleets additionally stack the
    # flight-recorder timelines and the policy / rollout actuation
    # series per member (None on plain fleets)
    member_chaos: Optional[list] = None
    timelines: Optional[object] = None   # TimelineSummary, (N,)-leading
    policies: Optional[object] = None    # PolicySummary, (N,)-leading
    rollouts: Optional[object] = None    # RolloutSummary, (N,)-leading
    # fleet observability: per-member critical-path blame —
    # an AttributionSummary with (N,)-leading leaves when the fleet
    # ran with attribution armed
    attributions: Optional[object] = None
    # the bytes the auto chunk was sized from (a FleetBytes of
    # analysis/costmodel.fleet_member_bytes); None when the chunk was
    # given or the device reports no capacity
    member_bytes: Optional[object] = None

    @property
    def members(self) -> int:
        return self.spec.members

    @property
    def protected(self) -> bool:
        return self.policies is not None or self.rollouts is not None

    def member(self, k: int):
        return member_summary(self.summaries, k)

    def member_timeline(self, k: int):
        if self.timelines is None:
            raise ValueError("this fleet carried no timelines")
        return member_summary(self.timelines, k)

    def member_policies(self, k: int):
        if self.policies is None:
            raise ValueError("this fleet carried no policy series")
        return member_summary(self.policies, k)

    def member_rollouts(self, k: int):
        if self.rollouts is None:
            raise ValueError("this fleet carried no rollout series")
        return member_summary(self.rollouts, k)

    def member_attribution(self, k: int):
        if self.attributions is None:
            raise ValueError("this fleet carried no attribution")
        return member_summary(self.attributions, k)

    def severity(self, mode: str = "err_peak",
                 slo_s: Optional[float] = None) -> np.ndarray:
        """(N,) per-member severity scores (``sim/splitting.py``): the
        statistic fleets are ranked by — peak per-window client error
        share when the recorder rode the fleet, run-long error share
        otherwise, or SLO-violation depth (``p99``)."""
        from isotope_tpu_torch.sim.splitting import (
            SplitSpec,
            severity_scores,
        )

        spec = SplitSpec(severity=mode, slo_s=slo_s)
        return severity_scores(spec, self.summaries, self.timelines)

    def worst_member(self, mode: str = "err_peak",
                     slo_s: Optional[float] = None) -> int:
        """The most-severe member — the fleet's postmortem subject
        (the runner dumps its policies/rollout/timeline artifacts
        with a member + seed stamp so the bad day replays solo)."""
        return int(np.argmax(self.severity(mode, slo_s)))

    def member_quantiles(self, qs=DOC_QUANTILES, window: bool = True
                         ) -> np.ndarray:
        """(N, len(qs)) per-member latency quantiles, from each
        member's (windowed, when ``window``) histogram.  A member
        whose trim window accumulated nothing (a run shorter than the
        collector's 62s skip) falls back to its full-run histogram —
        empty-window quantiles would read as ~0 latency."""
        from isotope_tpu_torch.metrics.histogram import (
            quantile_from_histogram,
        )

        full = _np(self.summaries.latency_hist)
        if window:
            win = _np(self.summaries.win_latency_hist)
            hists = np.where(
                (win.sum(axis=1) > 0)[:, None], win, full
            )
        else:
            hists = full
        return np.stack(
            [quantile_from_histogram(h, qs) for h in hists]
        )

    def quantile_band(self, q: float = 0.99,
                      band=(0.1, 0.5, 0.9)) -> dict:
        """The across-member spread of one latency quantile: the
        ensemble's answer to "how uncertain is my p99?"."""
        per_member = self.member_quantiles((q,))[:, 0]
        lo, mid, hi = np.quantile(per_member, band)
        return {
            "quantile": float(q),
            "members": int(self.members),
            "band": [float(b) for b in band],
            "lo_s": float(lo),
            "mid_s": float(mid),
            "hi_s": float(hi),
            "min_s": float(per_member.min()),
            "max_s": float(per_member.max()),
        }

    def slo_violation(self, slo_s: float, quantile: float = 0.99,
                      confidence: float = 0.95,
                      splitting: Optional[dict] = None) -> dict:
        """P(member's latency quantile exceeds ``slo_s``) with a
        Wilson confidence interval over the member count.

        At ZERO observed violations the Wilson interval degenerates
        to ``[0, upper]`` — the exact regime importance splitting
        exists for — so when a ``splitting`` block (the splitting
        estimator, ROADMAP item 9) is available its estimate is reported
        alongside instead of leaving only the one-sided bound."""
        per_member = self.member_quantiles((quantile,))[:, 0]
        n = self.members
        k = int((per_member > float(slo_s)).sum())
        lo, hi = wilson_interval(k, n, confidence)
        out = {
            "slo_s": float(slo_s),
            "quantile": float(quantile),
            "members": int(n),
            "violations": k,
            "p_violation": k / max(n, 1),
            "confidence": float(confidence),
            "ci_lo": lo,
            "ci_hi": hi,
        }
        if k == 0 and splitting is not None:
            out["p_splitting"] = float(splitting.get("p", 0.0))
            out["splitting_ci"] = [
                float(splitting.get("ci_lo", 0.0)),
                float(splitting.get("ci_hi", hi)),
            ]
            out["note"] = (
                "zero observed violations: the Wilson interval is "
                "one-sided; p_splitting is the importance-splitting "
                "estimate of the tail"
            )
        return out

    def error_rate_stats(self) -> dict:
        """Across-member client error-share distribution."""
        counts = _np(self.summaries.count).astype(np.float64)
        errs = _np(self.summaries.error_count).astype(np.float64)
        shares = errs / np.maximum(counts, 1.0)
        return {
            "mean": float(shares.mean()),
            "min": float(shares.min()),
            "max": float(shares.max()),
        }

    def pooled(self):
        """All members merged into ONE RunSummary (the solo-shaped
        view the runner reports when an ensemble served the case)."""
        from isotope_tpu_torch.sim.summary import reduce_stacked

        return reduce_stacked(self.summaries)

    def to_doc(self, label: str = "",
               slo_s: Optional[float] = None,
               qs: Sequence[float] = DOC_QUANTILES,
               splitting: Optional[dict] = None) -> dict:
        """The ``isotope-ensemble/v2`` artifact document.

        ``splitting`` attaches a rare-event estimate block
        (``isotope-splitting/v1``, ROADMAP item 9) behind the
        schema-versioned ``splitting`` key; protected fleets
        additionally record per-member severity and the worst
        member's identity (the postmortem pointer)."""
        mq = self.member_quantiles(qs)
        counts = _np(self.summaries.count).astype(np.float64)
        errs = _np(self.summaries.error_count).astype(np.float64)
        hops = _np(self.summaries.hop_events).astype(np.float64)
        doc = {
            "schema": DOC_SCHEMA,
            "label": label,
            "members": int(self.members),
            "chunk": int(self.chunk),
            "spec": self.spec.to_dict(),
            "offered_qps": [float(x) for x in self.offered_qps],
            "quantiles": [float(q) for q in qs],
            "member_quantiles_s": [
                [float(x) for x in row] for row in mq
            ],
            "member_counts": [float(x) for x in counts],
            "member_error_counts": [float(x) for x in errs],
            "member_hop_events": [float(x) for x in hops],
            "quantile_band_p99": self.quantile_band(0.99),
            "error_share": self.error_rate_stats(),
        }
        if self.protected or self.timelines is not None:
            sev = self.severity()
            worst = int(np.argmax(sev))
            doc["protected"] = self.protected
            doc["severity"] = [float(x) for x in sev]
            doc["worst_member"] = worst
            # valid for fold_in-derived fleets; callers that supplied
            # explicit member_keys (the runner's control member 0)
            # must override this with their own key recipe
            doc["worst_member_seed"] = int(self.spec.seeds[worst])
        if self.member_chaos is not None:
            doc["member_chaos"] = True
        if slo_s is not None:
            doc["slo"] = self.slo_violation(slo_s, splitting=splitting)
        if splitting is not None:
            doc["splitting"] = splitting
        return doc


def doc_member_quantiles(doc: dict) -> np.ndarray:
    """Round-trip reader: the (N, Q) per-member quantile table out of
    an ``isotope-ensemble/v1`` or ``v2`` document (runner artifact)."""
    if doc.get("schema") not in DOC_SCHEMAS:
        raise ValueError(
            f"not an {DOC_SCHEMA} document: {doc.get('schema')!r}"
        )
    return np.asarray(doc["member_quantiles_s"], np.float64)


def parse_jitter_spec(text: Optional[str]) -> dict:
    """Parse the CLI seed-jitter spec ``"qps=0.1,cpu=0.05,error=0.2"``
    into :meth:`EnsembleSpec.from_jitter` kwargs."""
    out = {"qps_jitter": 0.0, "cpu_jitter": 0.0, "error_jitter": 0.0}
    if not text:
        return out
    keys = {"qps": "qps_jitter", "cpu": "cpu_jitter",
            "error": "error_jitter", "err": "error_jitter",
            "seed": "jitter_seed"}
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad jitter spec entry {part!r} (expected "
                "axis=value, axes: qps, cpu, error, seed)"
            )
        k, v = part.split("=", 1)
        k = k.strip().lower()
        if k not in keys:
            raise ValueError(
                f"unknown jitter axis {k!r} (expected qps, cpu, "
                "error, or seed)"
            )
        out[keys[k]] = (
            int(v) if keys[k] == "jitter_seed" else float(v)
        )
    return out
