"""Pluggable load-balancing laws: the per-station wait model menu.

The port of ``isotope_tpu.sim.lb``.  Each backend of an Envoy data
plane owns its own queue and the *balancing policy* decides which
backend a request joins, which changes the waiting-time law itself, not
just its parameters.  The laws are per-service, declared in the
topology YAML ``policies:`` block::

    policies:
      defaults:
        lb: least_request                # scalar shorthand
      worker:
        lb: {policy: least_request, choices_d: 3, panic_threshold: 40%}
      store:
        lb: {policy: wrr, weights: [3, 1, 1, 1]}
      cache:
        lb: {policy: ring_hash, hash_skew: 1.2}

Laws (each stays in the engine's coin + exponential sampling form —
``(p_wait, wait_rate)`` per station):

- ``fifo`` — the shared-queue M/M/k law, untouched (the neutral law);
- ``least_request`` — Envoy's default, power-of-``choices_d``-choices:
  the mean-field law (Mitzenmacher), where the fraction of backends
  holding >= i jobs is ``rho^((d^i - 1)/(d - 1))``; ``P(wait) = rho^d``
  and the mean-field mean wait, the conditional wait sampled as an
  exponential.  ``d = 1`` is uniform-random per-backend dispatch
  (independent M/M/1s) exactly;
- ``ring_hash`` — consistent-hash stickiness with key-popularity skew:
  backend ``b`` attracts share ``(b+1)^(-hash_skew)``; the station is a
  share-weighted mixture of per-backend M/M/1 stations, matched in
  ``P(wait)`` and mean wait;
- ``wrr`` — weighted round-robin: the same mixture law with declared
  per-backend ``weights`` (cycled over the pool);
- **panic routing** (any law, ``panic_threshold``): when the healthy
  fraction of a service's pool (after chaos kills) drops below the
  threshold, Envoy routes to ALL backends; requests landing on dead
  backends fast-fail (the 500 path: no queue, no script, nothing
  downstream) and the survivors keep their undegraded per-backend load.

The host layer (decode, tables, the numpy mirror of the laws and the
report) is a copy of the reference's; the device layer is torch on an
explicit device.  ``lb`` absent, or an all-``fifo`` table with no
panic, leaves the engine's tensors and launches unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from isotope_tpu_torch.sim import queueing
from isotope_tpu_torch.sim.queueing import _MAX_RHO, QueueParams
from isotope_tpu_torch.models.decode import (
    field as _field,
    fraction as _frac,
    integer as _int,
    keyword as _keyword,
    number as _num,
)
from isotope_tpu_torch.models.errors import config_path


# -- configuration (the `lb:` entries of the `policies:` block) ------------


KINDS = ("fifo", "least_request", "ring_hash", "wrr")
KIND_FIFO, KIND_LEAST_REQUEST, KIND_RING_HASH, KIND_WRR = range(4)


@dataclasses.dataclass(frozen=True)
class LbPolicy:
    """One service's load-balancing law (Envoy's LB menu subset)."""

    policy: str = "fifo"
    choices_d: int = 2            # least_request: the power-of-d fan
    hash_skew: float = 1.0        # ring_hash: Zipf exponent over arcs
    weights: Tuple[float, ...] = ()  # wrr: per-backend weights
    panic_threshold: float = 0.0  # 0 disables panic routing

    _FIELDS = {
        "policy", "choices_d", "hash_skew", "weights", "panic_threshold",
    }

    @classmethod
    def decode(cls, value) -> "LbPolicy":
        if isinstance(value, str):
            value = {"policy": value}
        if not isinstance(value, dict):
            raise ValueError(
                f"lb must be a policy name or a mapping: {value!r}"
            )
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(f"unknown lb fields: {sorted(unknown)}")
        field = functools.partial(_field, value)
        policy = field("policy", lambda v: _keyword(v, KINDS), "fifo")

        def weights_list(v):
            if not isinstance(v, (list, tuple)) or not v:
                raise ValueError(
                    f"expected a non-empty list of weights: {v!r}"
                )
            out = tuple(_num(w) for w in v)
            if any(w <= 0 for w in out):
                raise ValueError(f"weights must be positive: {v!r}")
            return out

        out = cls(
            policy=policy,
            choices_d=field("choices_d", _int, 2),
            hash_skew=field("hash_skew", _num, 1.0),
            weights=field("weights", weights_list, ()),
            panic_threshold=field("panic_threshold", _frac, 0.0),
        )
        # per-law fields stay on their law: a `choices_d` on a ring-hash
        # service is a config typo, not a silent default
        if "choices_d" in value and policy != "least_request":
            with config_path("choices_d"):
                raise ValueError(
                    f"choices_d only applies to least_request "
                    f"(policy is {policy!r})"
                )
        if "hash_skew" in value and policy != "ring_hash":
            with config_path("hash_skew"):
                raise ValueError(
                    f"hash_skew only applies to ring_hash "
                    f"(policy is {policy!r})"
                )
        if "weights" in value and policy != "wrr":
            with config_path("weights"):
                raise ValueError(
                    f"weights only applies to wrr (policy is {policy!r})"
                )
        if out.choices_d < 1:
            with config_path("choices_d"):
                raise ValueError("choices_d must be >= 1")
        if out.hash_skew < 0:
            with config_path("hash_skew"):
                raise ValueError("hash_skew must be >= 0")
        return out

    @property
    def kind(self) -> int:
        return KINDS.index(self.policy)

    @property
    def active(self) -> bool:
        return self.policy != "fifo" or self.panic_threshold > 0.0


@dataclasses.dataclass(frozen=True)
class LbSet:
    """The decoded ``lb:`` entries of a topology's ``policies:`` block.

    Same defaults discipline as :class:`~isotope_tpu.sim.policies.
    PolicySet`: ``policies.defaults.lb`` seeds every service, a
    per-service ``lb:`` replaces it wholesale, an explicit ``lb: null``
    disables the default for that service.
    """

    per_service: Dict[str, Optional[LbPolicy]]
    defaults: Optional[LbPolicy]

    @classmethod
    def decode(cls, raw: dict, service_names) -> "LbSet":
        if not isinstance(raw, dict):
            raise ValueError(f"policies must be a mapping: {raw!r}")
        names = list(service_names)
        with config_path("policies"):
            default: Optional[LbPolicy] = None
            d = raw.get("defaults")
            if isinstance(d, dict) and d.get("lb") is not None:
                with config_path("defaults"), config_path("lb"):
                    default = LbPolicy.decode(d["lb"])
            per: Dict[str, Optional[LbPolicy]] = {}
            for key, value in raw.items():
                if key == "defaults":
                    continue
                if key not in names:
                    raise ValueError(
                        f"policies target unknown service {key!r}"
                    )
                if not isinstance(value, dict) or "lb" not in value:
                    continue
                with config_path(key), config_path("lb"):
                    per[key] = (
                        None if value["lb"] is None
                        else LbPolicy.decode(value["lb"])
                    )
        return cls(per_service=per, defaults=default)

    def for_service(self, name: str) -> Optional[LbPolicy]:
        if name in self.per_service:
            return self.per_service[name]
        return self.defaults

    @property
    def empty(self) -> bool:
        """True when NO service declares any lb law at all."""
        return self.defaults is None and not any(
            p is not None for p in self.per_service.values()
        )


def lint_lb(
    raw: dict, service_names
) -> Tuple[Optional["LbSet"], List[Tuple[str, str]]]:
    """Tolerant decode for the vet linter (the policies.lint_policies
    idiom): decode errors become findings instead of crashes."""
    try:
        return LbSet.decode(raw, service_names), []
    except ValueError as e:
        return None, [("decode", str(e))]


# -- dense per-service tables (compiler/compile.compile_lb) ----------------


@dataclasses.dataclass(frozen=True)
class LbTables:
    """The ``lb:`` entries lowered to dense per-service arrays in
    compiled service order — the device-constant form the engine's
    wait-law selection consumes (cache-keyed like the breaker/budget
    tables)."""

    names: Tuple[str, ...]
    static_replicas: np.ndarray   # (S,) i64 — topology numReplicas
    kind: np.ndarray              # (S,) i32 — KIND_* (fifo default)
    choices_d: np.ndarray         # (S,) f64
    hash_skew: np.ndarray         # (S,) f64
    panic_threshold: np.ndarray   # (S,) f64, 0 = panic off
    weights: np.ndarray           # (S, Wmax) f64, NaN-padded
    wlen: np.ndarray              # (S,) i64 — declared weight count

    @property
    def num_services(self) -> int:
        return len(self.names)

    @property
    def any_lr(self) -> bool:
        return bool((self.kind == KIND_LEAST_REQUEST).any())

    @property
    def any_mix(self) -> bool:
        return bool(
            ((self.kind == KIND_RING_HASH) | (self.kind == KIND_WRR))
            .any()
        )

    @property
    def any_panic(self) -> bool:
        return bool((self.panic_threshold > 0.0).any())

    @property
    def active(self) -> bool:
        """False when every service is fifo with panic off — the
        engine then skips the law selection entirely (but the tables
        still key the executable cache, so the <= 1 ULP neutral pin is
        about the selection math, not table presence)."""
        return self.any_lr or self.any_mix or self.any_panic

    def signature(self) -> str:
        """Stable identity for executable-cache keys."""
        parts = [f"{self.names!r}"]
        for f in dataclasses.fields(self)[1:]:
            parts.append(np.asarray(getattr(self, f.name)).tobytes().hex())
        return "lb:" + "|".join(parts)

    def backend_profile(self, k_max: int) -> np.ndarray:
        """(S, k_max) unnormalized per-backend attraction weights.

        The profile spans the WIDEST pool any law can see (the engine's
        Erlang ``k_max``, autoscaler max included); the device law
        masks columns past the current pool size and renormalizes, so
        a scale-up extends the ring / weight cycle consistently:
        ring-hash arcs keep their Zipf ranks, wrr weights cycle
        (``weights[b % len]`` — new pods inherit the declared
        pattern).  fifo / least_request rows are uniform (their laws
        never read the profile)."""
        S = self.num_services
        prof = np.ones((S, k_max), np.float64)
        b = np.arange(k_max, dtype=np.float64)
        for s in range(S):
            if self.kind[s] == KIND_RING_HASH:
                prof[s] = (b + 1.0) ** (-self.hash_skew[s])
            elif self.kind[s] == KIND_WRR:
                n = int(self.wlen[s])
                w = self.weights[s, :n]
                prof[s] = w[np.arange(k_max) % n]
        return prof


def build_tables(lbs: LbSet, services) -> LbTables:
    """Lower a decoded LbSet against a compiled ServiceTable."""
    names = tuple(services.names)
    S = len(names)
    kind = np.zeros(S, np.int32)
    choices = np.full(S, 2.0)
    skew = np.ones(S)
    panic = np.zeros(S)
    pols = [lbs.for_service(n) for n in names]
    wmax = max([len(p.weights) for p in pols if p is not None] + [1])
    weights = np.full((S, wmax), np.nan)
    wlen = np.zeros(S, np.int64)
    for s, p in enumerate(pols):
        if p is None:
            continue
        kind[s] = p.kind
        choices[s] = float(p.choices_d)
        skew[s] = float(p.hash_skew)
        panic[s] = float(p.panic_threshold)
        if p.weights:
            weights[s, : len(p.weights)] = p.weights
            wlen[s] = len(p.weights)
        elif p.kind == KIND_WRR:
            # wrr without declared weights is uniform round-robin
            weights[s, 0] = 1.0
            wlen[s] = 1
    return LbTables(
        names=names,
        static_replicas=np.asarray(services.replicas, np.int64),
        kind=kind,
        choices_d=choices,
        hash_skew=skew,
        panic_threshold=panic,
        weights=weights,
        wlen=wlen,
    )


# -- device-side laws ------------------------------------------------------

#: truncation of the mean-field tail sum; terms decay doubly
#: exponentially for d >= 2 (the d = 1 geometric residue is summed in
#: closed form), so 8 terms are exact to f32 resolution
_LR_TERMS = 8


class DeviceLb(NamedTuple):
    """LbTables as tensors on one device (plus the dense backend
    profile resolved against the engine's ``k_max``)."""

    is_lr: torch.Tensor            # (S,) bool
    is_mix: torch.Tensor           # (S,) bool — ring_hash | wrr
    choices_d: torch.Tensor        # (S,) f32
    panic_threshold: torch.Tensor  # (S,) f32
    profile: torch.Tensor          # (S, k_max) f32 backend attraction


def effective_profile(
    t: LbTables,
    k_max: int,
    degraded: Optional[Tuple[int, float]] = None,
) -> np.ndarray:
    """The backend-attraction profile the run executes:
    :meth:`LbTables.backend_profile`, with a ``(backend, factor)``
    weight collapse applied when ``degraded`` is given.  One source for
    the device tables and the host feedback mirror.  The engine passes
    ``None``: the ``lb.degraded_backend`` fault site is not ported
    (ROADMAP.md queue 1: framework services)."""
    prof = t.backend_profile(k_max)
    if degraded is not None:
        b, factor = degraded
        if 0 <= b < k_max:
            prof = prof.copy()
            prof[:, b] = prof[:, b] * factor
    return prof


def device_tables(t: LbTables, k_max: int, device) -> DeviceLb:
    """The tables as tensors on ``device``."""
    prof = effective_profile(t, k_max)

    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return DeviceLb(
        is_lr=put(t.kind == KIND_LEAST_REQUEST, torch.bool),
        is_mix=put(
            (t.kind == KIND_RING_HASH) | (t.kind == KIND_WRR), torch.bool
        ),
        choices_d=put(t.choices_d, torch.float32),
        panic_threshold=put(t.panic_threshold, torch.float32),
        profile=put(prof, torch.float32),
    )


def wait_params(
    tables: LbTables,
    dlb: DeviceLb,
    arrival_rate: torch.Tensor,  # (..., S)
    service_rate: float,         # per-server mu
    replicas: torch.Tensor,      # (..., S) int
    k_max: int,
) -> QueueParams:
    """Per-station sampling parameters under the per-service LB laws.

    Starts from the shared-queue M/M/k parameters (the fifo law) and
    overlays the least-request and mixture laws where configured; fifo
    rows pass through ``queueing.mmk_params`` untouched.  Aggregate
    ``utilization`` keeps the station-level ``lambda / (k mu)`` reading
    for every law; ``unstable`` flags the HOT BACKEND under a mixture (a
    skewed ring saturates its hottest arc long before the aggregate
    does).  Float32 in the reference's order of operations."""
    base = queueing.mmk_params(arrival_rate, service_rate, replicas, k_max)
    lam = arrival_rate.to(torch.float32)
    mu = torch.full_like(lam, service_rate)
    kf = replicas.to(torch.float32)
    p_wait, rate = base.p_wait, base.wait_rate
    unstable = base.unstable

    rho_raw = lam / (kf * mu)
    # the same near-saturation clamp as the fifo law, floored away from
    # zero so log/exp stay finite on unreached services
    rho = torch.clamp(rho_raw, 1e-9, _MAX_RHO)

    if tables.any_lr:
        d = dlb.choices_d
        logr = torch.log(rho)
        dm1 = torch.clamp(d - 1.0, min=1e-6)
        s_sum = torch.zeros_like(rho)
        for i in range(1, _LR_TERMS + 1):
            # tail-fraction exponents (d^i - 1)/(d - 1); d = 1 -> i
            e_i = torch.where(d > 1.5, (d**i - 1.0) / dm1, float(i))
            s_sum = s_sum + torch.exp(e_i * logr)
        # d = 1 (random per-backend dispatch): geometric residue past
        # the truncation, so the law is the exact M/M/1 at every rho
        s_sum = s_sum + torch.where(
            d < 1.5,
            torch.exp(float(_LR_TERMS + 1) * logr) / (1.0 - rho),
            0.0,
        )
        # mean jobs per backend minus the in-service term -> queued
        q_len = torch.clamp(s_sum - rho, min=1e-12)
        p_lr = torch.exp(d * logr)                   # P(all d busy)
        mean_w = q_len / (rho * mu)                  # Little, per server
        rate_lr = p_lr / torch.clamp(mean_w, min=1e-30)
        p_wait = torch.where(dlb.is_lr, p_lr, p_wait)
        rate = torch.where(dlb.is_lr, rate_lr, rate)

    if tables.any_mix:
        K = dlb.profile.shape[1]
        cols = torch.arange(K, dtype=torch.float32, device=lam.device)
        mask = cols < kf[..., None]                  # (..., S, K)
        w = dlb.profile * mask
        share = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
        lam_b = lam[..., None] * share
        rho_b_raw = lam_b / mu[..., None]            # per-backend M/M/1
        rho_b = torch.clamp(rho_b_raw, max=_MAX_RHO)
        p_mix = (share * rho_b).sum(-1)
        mean_mix = (
            share * rho_b / (mu[..., None] * (1.0 - rho_b))
        ).sum(-1)
        rate_mix = p_mix / torch.clamp(mean_mix, min=1e-30)
        hot = ((rho_b_raw >= 1.0) & (share > 0)).any(-1)
        p_wait = torch.where(dlb.is_mix, p_mix, p_wait)
        rate = torch.where(dlb.is_mix, rate_mix, rate)
        unstable = torch.where(dlb.is_mix, hot, unstable)

    return QueueParams(
        p_wait=p_wait,
        wait_rate=torch.clamp(rate, min=1e-20),
        utilization=base.utilization,
        unstable=unstable,
    )


def panic_split(
    dlb: DeviceLb,
    arrival_rate: torch.Tensor,  # (..., S)
    alive: torch.Tensor,         # (..., S) healthy replicas (may be 0)
    total: torch.Tensor,         # (..., S) pool size incl. downed
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Envoy panic-threshold routing, per (phase, service).

    Below the threshold the mesh routes to ALL backends: the share
    landing on dead ones (``1 - healthy_frac``) fast-fails (the caller
    draws the panic coin against it), and the wait law's offered load
    scales by ``healthy_frac``.  Returns ``(lambda_for_wait_law,
    panic_fail_prob)``."""
    frac = torch.clamp(alive / torch.clamp(total, min=1.0), 0.0, 1.0)
    panic = (dlb.panic_threshold > 0.0) & (frac < dlb.panic_threshold)
    lam_out = torch.where(panic, arrival_rate * frac, arrival_rate)
    p_fail = torch.where(panic, 1.0 - frac, 0.0)
    return lam_out, p_fail


# -- numpy mirror (sim/feedback.py's visit fixed point) --------------------


def np_wait_stats(
    tables: LbTables,
    profile: np.ndarray,   # (S, k_max) from backend_profile
    lam: np.ndarray,       # (S,)
    mu: float,
    k: np.ndarray,         # (S,) >= 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Host mirror of :func:`wait_params` for the retry-storm fixed
    point: ``(p_wait, wait_rate)`` under the per-service laws, so the
    static visit estimates see the same skewed per-backend waits the
    engine samples (a hot ring-hash arc times out long before the
    aggregate M/M/k says so)."""
    from isotope_tpu_torch.sim.feedback import np_mmk

    lam = np.asarray(lam, np.float64)
    k = np.asarray(np.maximum(k, 1.0), np.float64)
    p_wait, rate, _ = np_mmk(lam, mu, k)
    rho = np.clip(lam / (k * mu), 1e-9, _MAX_RHO)

    lr = tables.kind == KIND_LEAST_REQUEST
    if lr.any():
        d = tables.choices_d
        s_sum = np.zeros_like(rho)
        dm1 = np.maximum(d - 1.0, 1e-6)
        for i in range(1, _LR_TERMS + 1):
            e_i = np.where(d > 1.5, (d**i - 1.0) / dm1, float(i))
            s_sum = s_sum + rho**e_i
        s_sum = s_sum + np.where(
            d < 1.5, rho ** (_LR_TERMS + 1) / (1.0 - rho), 0.0
        )
        q_len = np.maximum(s_sum - rho, 1e-12)
        p_lr = rho**d
        mean_w = q_len / (rho * mu)
        p_wait = np.where(lr, p_lr, p_wait)
        rate = np.where(lr, p_lr / np.maximum(mean_w, 1e-30), rate)

    mix = (tables.kind == KIND_RING_HASH) | (tables.kind == KIND_WRR)
    if mix.any():
        K = profile.shape[1]
        mask = np.arange(K)[None, :] < k[:, None]
        w = profile * mask
        share = w / np.maximum(w.sum(-1, keepdims=True), 1e-30)
        rho_b = np.minimum(lam[:, None] * share / mu, _MAX_RHO)
        p_mix = (share * rho_b).sum(-1)
        mean_mix = (share * rho_b / (mu * (1.0 - rho_b))).sum(-1)
        p_wait = np.where(mix, p_mix, p_wait)
        rate = np.where(
            mix, p_mix / np.maximum(mean_mix, 1e-30), rate
        )
    return p_wait, np.maximum(rate, 1e-30)


# -- host-side reporting ---------------------------------------------------


def to_doc(tables: LbTables, tl=None, pol=None, max_windows: int = 64) -> dict:
    """The ``lb.json`` artifact (``isotope-lb/v1``): per-service law,
    its parameters and the static per-backend load-split vector.  The
    per-window split of the reference (``tl``, a timeline summary, and
    ``pol``, a policy summary) is not ported."""
    if tl is not None:
        raise NotImplementedError(
            "to_doc(tl=...) is not ported to isotope_tpu_torch yet "
            "(ROADMAP.md queue 1: item 8, observability)"
        )
    if pol is not None:
        raise NotImplementedError(
            "to_doc(pol=...) is not ported to isotope_tpu_torch yet "
            "(ROADMAP.md queue 1: item 7, protected layers)"
        )
    k_max = int(tables.static_replicas.max(initial=1))
    profile = tables.backend_profile(k_max)
    services: Dict[str, dict] = {}
    for s, name in enumerate(tables.names):
        kind = int(tables.kind[s])
        panic = float(tables.panic_threshold[s])
        if kind == KIND_FIFO and panic <= 0.0:
            continue
        k_s = int(tables.static_replicas[s])
        w = profile[s, :k_s]
        share = (w / max(w.sum(), 1e-30)).tolist()
        doc = {
            "policy": KINDS[kind],
            "replicas": k_s,
            "share": [round(v, 6) for v in share],
        }
        if kind == KIND_LEAST_REQUEST:
            doc["choices_d"] = int(tables.choices_d[s])
        if kind == KIND_RING_HASH:
            doc["hash_skew"] = float(tables.hash_skew[s])
        if kind == KIND_WRR:
            n = int(tables.wlen[s])
            doc["weights"] = list(tables.weights[s, :n])
        if panic > 0.0:
            doc["panic_threshold"] = panic
        services[name] = doc
    return {
        "schema": "isotope-lb/v1",
        "k_max": k_max,
        "services": services,
    }


def format_table(doc: dict) -> str:
    """Human-readable per-backend load-split table (CLI stderr)."""
    lines = ["lb:"]
    for name, svc in doc.get("services", {}).items():
        bits = [f"{name:<20} {svc['policy']}"]
        if "choices_d" in svc:
            bits.append(f"d={svc['choices_d']}")
        if "hash_skew" in svc:
            bits.append(f"skew={svc['hash_skew']:g}")
        if "panic_threshold" in svc:
            bits.append(f"panic<{svc['panic_threshold']:.0%}")
        share = svc.get("share", [])
        bits.append(
            "share [" + " ".join(f"{v:.2f}" for v in share) + "]"
        )
        hops = svc.get("backend_hops")
        if hops:
            bits.append(
                "hops [" + " ".join(f"{v:g}" for v in hops) + "]"
            )
        lines.append("  ".join(bits))
    return "\n".join(lines)
