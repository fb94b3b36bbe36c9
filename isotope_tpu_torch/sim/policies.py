"""In-graph resilience policies: the mesh-policy control plane, in torch.

The port of ``isotope_tpu.sim.policies``.  Per-service policy state
rides the protected block loop (``Simulator.run_policies``), observes
the flight recorder's windows (``metrics/timeline.py``) accumulated in
the same loop, and actuates on the next block's physics:

- **circuit breakers** (Envoy ``max_pending_requests`` /
  ``max_connections``): when a service's observed mean queue depth or
  in-flight concurrency overflows its caps, the overflow fraction of
  arriving requests is SHED — a shed request takes the error path (fast
  500, skips the script, sends nothing downstream) and *not the queue*
  (zero wait draw), and the wait law's offered load is scaled by the
  admitted fraction;
- **outlier ejection**: a run of erroring windows totaling the
  ``consecutive_errors`` threshold ejects one replica's capacity for a
  baseline interval (``base_ejection_s``), shrinking the effective ``k``
  of the M/M/k wait law, bounded by ``max_ejection_fraction``;
- **retry budgets** (Envoy ``retry_budget``): observed retry arrivals
  beyond ``budget_percent`` of active requests (plus
  ``min_retries_concurrent``) truncate the attempt fan — attempts past
  the first run only with the budgeted probability.  The same budget is
  threaded into the ``sim/feedback.py`` offered-load fixed point so the
  static visit estimates respect it too;
- an **HPA-style autoscaler**: per-service replica counts react to the
  per-window busy-share occupancy integral with a sync period, a
  scale-down stabilization window and per-sync step limits; capacity
  composes with the chaos phases' down deltas.

Discretization: the recorder OBSERVES at window granularity and the
loop ACTUATES at block granularity — the state advanced through the
windows block ``b`` completed shapes block ``b+1`` (one block of
actuation lag, the scrape-interval lag a real HPA/Envoy stack has).

The host half (decode with the reference's messages, ``PolicyTables``,
``build_tables``, ``lint_policies``, ``to_doc``, ``format_table``) is a
copy.  The device half is elementwise float32 torch over (S,) state
vectors.  Where the reference sweeps every window of the grid with a
masked ``lax.scan`` on every block, :func:`advance` reads the completed
window count once per block and applies the law only to the windows
completed since the last call; the others would pass the state through
unchanged, so the state and the per-window series are the same.

Everything is off by default: a Simulator built without policy tables
runs exactly the ops it ran before.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from isotope_tpu_torch.models.decode import (
    duration_s as _dur,
    field as _field,
    fraction as _frac,
    integer as _int,
    number as _num,
)
from isotope_tpu_torch.models.errors import config_path


# -- policy configuration (the topology YAML `policies:` block) -----------


@dataclasses.dataclass(frozen=True)
class CircuitBreakerPolicy:
    """Envoy-style connection-pool caps + outlier ejection.

    ``max_pending`` caps the observed mean QUEUED requests,
    ``max_connections`` the observed mean in-flight concurrency; either
    overflowing sheds the overflow fraction.  ``consecutive_errors``
    (errors accumulated over a run of erroring windows) ejects one
    replica for ``base_ejection_s`` seconds, up to
    ``max_ejection_fraction`` of the current replicas.  ``None`` /
    ``0`` disables the respective mechanism.
    """

    max_pending: Optional[float] = None
    max_connections: Optional[float] = None
    consecutive_errors: int = 0
    base_ejection_s: float = 30.0
    max_ejection_fraction: float = 0.5

    _FIELDS = {
        "max_pending", "max_connections", "consecutive_errors",
        "base_ejection", "max_ejection_fraction",
    }

    @classmethod
    def decode(cls, value: dict) -> "CircuitBreakerPolicy":
        if not isinstance(value, dict):
            raise ValueError(f"breaker must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(f"unknown breaker fields: {sorted(unknown)}")

        field = functools.partial(_field, value)

        out = cls(
            max_pending=field("max_pending", _num, None),
            max_connections=field("max_connections", _num, None),
            consecutive_errors=field("consecutive_errors", _int, 0),
            base_ejection_s=field("base_ejection", _dur, 30.0),
            max_ejection_fraction=field(
                "max_ejection_fraction", _frac, 0.5
            ),
        )
        for name in ("max_pending", "max_connections"):
            v = getattr(out, name)
            if v is not None and v <= 0:
                with config_path(name):
                    raise ValueError(f"{name} must be positive: {v!r}")
        if out.consecutive_errors < 0:
            with config_path("consecutive_errors"):
                raise ValueError("consecutive_errors must be >= 0")
        if out.base_ejection_s <= 0:
            with config_path("base_ejection"):
                raise ValueError("base_ejection must be positive")
        return out


@dataclasses.dataclass(frozen=True)
class RetryBudgetPolicy:
    """Envoy ``retry_budget``: concurrent retries may not exceed
    ``budget_percent`` of active requests, with a
    ``min_retries_concurrent`` floor so quiet services can still retry.
    A budget of 0 suppresses all retries once any are observed."""

    budget_percent: float = 0.2      # stored as a fraction in [0, 1]
    min_retries_concurrent: float = 3.0

    _FIELDS = {"budget_percent", "min_retries_concurrent"}

    @classmethod
    def decode(cls, value: dict) -> "RetryBudgetPolicy":
        if not isinstance(value, dict):
            raise ValueError(f"retry_budget must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(
                f"unknown retry_budget fields: {sorted(unknown)}"
            )

        field = functools.partial(_field, value)

        out = cls(
            budget_percent=field("budget_percent", _frac, 0.2),
            min_retries_concurrent=field(
                "min_retries_concurrent", _num, 3.0
            ),
        )
        if out.min_retries_concurrent < 0:
            with config_path("min_retries_concurrent"):
                raise ValueError("min_retries_concurrent must be >= 0")
        return out


@dataclasses.dataclass(frozen=True)
class AutoscalerPolicy:
    """HPA-style per-service replica controller.

    At each sync (every ``sync_period_s`` of sim time) the desired
    count is ``ceil(current * utilization / target_utilization)``
    (the HPA formula), clamped to ``[min_replicas, max_replicas]`` and
    to at most ``scale_up_step`` up / ``scale_down_step`` down per
    sync; a scale-DOWN additionally requires the desired count to have
    sat below current continuously for ``stabilization_window_s``.
    """

    min_replicas: int = 1
    max_replicas: int = 8
    target_utilization: float = 0.6
    sync_period_s: float = 15.0
    stabilization_window_s: float = 60.0
    scale_up_step: int = 4
    scale_down_step: int = 1

    _FIELDS = {
        "min_replicas", "max_replicas", "target_utilization",
        "sync_period", "stabilization_window", "scale_up_step",
        "scale_down_step",
    }

    @classmethod
    def decode(cls, value: dict) -> "AutoscalerPolicy":
        if not isinstance(value, dict):
            raise ValueError(f"autoscaler must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(
                f"unknown autoscaler fields: {sorted(unknown)}"
            )

        field = functools.partial(_field, value)

        out = cls(
            min_replicas=field("min_replicas", _int, 1),
            max_replicas=field("max_replicas", _int, 8),
            target_utilization=field("target_utilization", _frac, 0.6),
            sync_period_s=field("sync_period", _dur, 15.0),
            stabilization_window_s=field(
                "stabilization_window", _dur, 60.0
            ),
            scale_up_step=field("scale_up_step", _int, 4),
            scale_down_step=field("scale_down_step", _int, 1),
        )
        if out.min_replicas < 1:
            with config_path("min_replicas"):
                raise ValueError("min_replicas must be >= 1")
        if out.target_utilization <= 0:
            with config_path("target_utilization"):
                raise ValueError("target_utilization must be positive")
        if out.sync_period_s <= 0:
            with config_path("sync_period"):
                raise ValueError("sync_period must be positive")
        if out.scale_up_step < 1 or out.scale_down_step < 1:
            raise ValueError("scale steps must be >= 1")
        return out


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """The resilience policies attached to one service (any subset)."""

    breaker: Optional[CircuitBreakerPolicy] = None
    retry_budget: Optional[RetryBudgetPolicy] = None
    autoscaler: Optional[AutoscalerPolicy] = None

    # ``lb`` shares the block but is decoded/compiled by sim/lb.py
    # (compiler/compile.compile_lb) into its own tables — listed here
    # only so the strict unknown-field check admits it
    _FIELDS = {"breaker", "retry_budget", "autoscaler", "lb"}

    @classmethod
    def decode(
        cls, value: dict, default: "ServicePolicy"
    ) -> "ServicePolicy":
        """Decode one service's entry; ``default`` seeds each policy
        block, an explicit ``null`` disables it for this service."""
        if value is None:
            value = {}
        if not isinstance(value, dict):
            raise ValueError(f"service policy must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(f"unknown policy fields: {sorted(unknown)}")

        def block(key, decode, fallback):
            if key not in value:
                return fallback
            if value[key] is None:
                return None  # explicit null disables the default
            with config_path(key):
                return decode(value[key])

        return cls(
            breaker=block(
                "breaker", CircuitBreakerPolicy.decode, default.breaker
            ),
            retry_budget=block(
                "retry_budget", RetryBudgetPolicy.decode,
                default.retry_budget,
            ),
            autoscaler=block(
                "autoscaler", AutoscalerPolicy.decode, default.autoscaler
            ),
        )


@dataclasses.dataclass(frozen=True)
class PolicySet:
    """The decoded ``policies:`` block of a topology YAML.

    Schema::

        policies:
          defaults:               # applies to EVERY service
            retry_budget: {budget_percent: 20%}
          worker:                 # per-service overrides (block-wise)
            breaker: {max_pending: 8, consecutive_errors: 5}
            autoscaler: {min_replicas: 2, max_replicas: 16}
          frontend:
            retry_budget: null    # explicit null disables the default

    ``defaults`` seeds every service; a per-service entry replaces the
    named policy blocks wholesale (an explicit ``null`` disables one).
    """

    per_service: Dict[str, ServicePolicy]
    defaults: ServicePolicy

    @classmethod
    def decode(cls, raw: dict, service_names) -> "PolicySet":
        if not isinstance(raw, dict):
            raise ValueError(f"policies must be a mapping: {raw!r}")
        names = list(service_names)
        with config_path("policies"):
            with config_path("defaults"):
                default = ServicePolicy.decode(
                    raw.get("defaults") or {}, ServicePolicy()
                )
            per: Dict[str, ServicePolicy] = {}
            for key, value in raw.items():
                if key == "defaults":
                    continue
                if key not in names:
                    raise ValueError(
                        f"policies target unknown service {key!r}"
                    )
                with config_path(key):
                    per[key] = ServicePolicy.decode(value, default)
        return cls(per_service=per, defaults=default)

    def for_service(self, name: str) -> ServicePolicy:
        return self.per_service.get(name, self.defaults)

    @property
    def empty(self) -> bool:
        pols = list(self.per_service.values()) + [self.defaults]
        return all(
            p.breaker is None
            and p.retry_budget is None
            and p.autoscaler is None
            for p in pols
        )


# -- dense per-service tables (compiled by compiler/compile.py) -----------


_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PolicyTables:
    """The ``policies:`` block lowered to dense per-service arrays in
    compiled service order — the device-constant form the engine's
    policy scan consumes.  Sentinels: ``inf`` caps / thresholds disable
    the respective mechanism for a service."""

    names: Tuple[str, ...]
    static_replicas: np.ndarray       # (S,) i64 — topology numReplicas
    # breaker
    max_pending: np.ndarray           # (S,) f64, inf = uncapped
    max_connections: np.ndarray       # (S,) f64, inf = uncapped
    consecutive_errors: np.ndarray    # (S,) f64, inf = ejection off
    base_ejection_s: np.ndarray       # (S,) f64
    max_eject_frac: np.ndarray        # (S,) f64
    # retry budget
    has_budget: np.ndarray            # (S,) bool
    budget_frac: np.ndarray           # (S,) f64
    budget_min: np.ndarray            # (S,) f64
    # autoscaler
    has_hpa: np.ndarray               # (S,) bool
    min_replicas: np.ndarray          # (S,) f64
    max_replicas: np.ndarray          # (S,) f64
    target_util: np.ndarray           # (S,) f64
    sync_period_s: np.ndarray         # (S,) f64
    stabilization_s: np.ndarray       # (S,) f64
    up_step: np.ndarray               # (S,) f64
    down_step: np.ndarray             # (S,) f64

    @property
    def num_services(self) -> int:
        return len(self.names)

    @property
    def any_breaker(self) -> bool:
        return bool(
            np.isfinite(self.max_pending).any()
            or np.isfinite(self.max_connections).any()
        )

    @property
    def any_ejection(self) -> bool:
        return bool(np.isfinite(self.consecutive_errors).any())

    @property
    def any_budget(self) -> bool:
        return bool(self.has_budget.any())

    @property
    def any_hpa(self) -> bool:
        return bool(self.has_hpa.any())

    @property
    def k_max(self) -> int:
        """The widest station the dynamic wait law can reach (sets the
        Erlang recursion length next to the static replica max)."""
        k = int(self.static_replicas.max(initial=1))
        if self.any_hpa:
            k = max(k, int(self.max_replicas[self.has_hpa].max()))
        return k

    def signature(self) -> str:
        """Stable identity for executable-cache keys."""
        fields = dataclasses.fields(self)
        parts = [f"{self.names!r}"]
        for f in fields[1:]:
            parts.append(np.asarray(getattr(self, f.name)).tobytes().hex())
        return "policies:" + "|".join(parts)


def build_tables(pols: PolicySet, services) -> PolicyTables:
    """Lower a decoded PolicySet against a compiled ServiceTable."""
    names = tuple(services.names)
    S = len(names)

    def arr(fill):
        return np.full(S, fill, np.float64)

    static = np.asarray(services.replicas, np.int64)
    max_pending = arr(_INF)
    max_conns = arr(_INF)
    consec = arr(_INF)
    eject_s = arr(30.0)
    eject_frac = arr(0.5)
    has_budget = np.zeros(S, bool)
    budget = arr(0.0)
    budget_min = arr(0.0)
    has_hpa = np.zeros(S, bool)
    min_r = static.astype(np.float64)
    max_r = static.astype(np.float64)
    target = arr(0.6)
    sync_s = arr(15.0)
    stab_s = arr(60.0)
    up_step = arr(1.0)
    down_step = arr(1.0)
    for s, name in enumerate(names):
        p = pols.for_service(name)
        if p.autoscaler is not None and (
            p.autoscaler.min_replicas > p.autoscaler.max_replicas
        ):
            # vet reports this as VET-T011; compiling without vet must
            # still fail loudly instead of clipping into an empty range
            raise ValueError(
                f"policies.{name}.autoscaler: min_replicas="
                f"{p.autoscaler.min_replicas} > max_replicas="
                f"{p.autoscaler.max_replicas}"
            )
        if p.breaker is not None:
            b = p.breaker
            if b.max_pending is not None:
                max_pending[s] = b.max_pending
            if b.max_connections is not None:
                max_conns[s] = b.max_connections
            if b.consecutive_errors > 0:
                consec[s] = float(b.consecutive_errors)
            eject_s[s] = b.base_ejection_s
            eject_frac[s] = b.max_ejection_fraction
        if p.retry_budget is not None:
            has_budget[s] = True
            budget[s] = p.retry_budget.budget_percent
            budget_min[s] = p.retry_budget.min_retries_concurrent
        if p.autoscaler is not None:
            a = p.autoscaler
            has_hpa[s] = True
            min_r[s] = float(a.min_replicas)
            max_r[s] = float(a.max_replicas)
            target[s] = a.target_utilization
            sync_s[s] = a.sync_period_s
            stab_s[s] = a.stabilization_window_s
            up_step[s] = float(a.scale_up_step)
            down_step[s] = float(a.scale_down_step)
    return PolicyTables(
        names=names,
        static_replicas=static,
        max_pending=max_pending,
        max_connections=max_conns,
        consecutive_errors=consec,
        base_ejection_s=eject_s,
        max_eject_frac=eject_frac,
        has_budget=has_budget,
        budget_frac=budget,
        budget_min=budget_min,
        has_hpa=has_hpa,
        min_replicas=min_r,
        max_replicas=max_r,
        target_util=target,
        sync_period_s=sync_s,
        stabilization_s=stab_s,
        up_step=up_step,
        down_step=down_step,
    )


def lint_policies(
    raw: dict, service_names
) -> Tuple[Optional[PolicySet], List[Tuple[str, str]]]:
    """Decode a raw ``policies:`` block tolerantly for the vet linter.

    Returns ``(PolicySet | None, [(rule_hint, message), ...])`` — decode
    errors become findings instead of crashes (``rule_hint`` is
    ``"decode"``; semantic rules are checked by the caller against the
    decoded set).
    """
    try:
        return PolicySet.decode(raw, service_names), []
    except ValueError as e:
        return None, [("decode", str(e))]


# -- device-side state / control law --------------------------------------

import torch  # noqa: E402

F32 = torch.float32


class DeviceTables(NamedTuple):
    """PolicyTables as float32 tensors on the run's device."""

    static_replicas: torch.Tensor    # (S,)
    max_pending: torch.Tensor        # (S,) inf = uncapped
    max_connections: torch.Tensor    # (S,)
    consecutive_errors: torch.Tensor  # (S,) inf = off
    base_ejection_s: torch.Tensor
    max_eject_frac: torch.Tensor
    has_budget: torch.Tensor         # (S,) bool
    budget_frac: torch.Tensor
    budget_min: torch.Tensor
    has_hpa: torch.Tensor            # (S,) bool
    min_replicas: torch.Tensor
    max_replicas: torch.Tensor
    target_util: torch.Tensor
    sync_period_s: torch.Tensor
    stabilization_s: torch.Tensor
    up_step: torch.Tensor
    down_step: torch.Tensor


def device_tables(t: PolicyTables, device="cpu") -> DeviceTables:
    def f(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def b(x):
        return torch.tensor(np.asarray(x, bool), device=device)

    return DeviceTables(
        static_replicas=f(t.static_replicas),
        max_pending=f(t.max_pending),
        max_connections=f(t.max_connections),
        consecutive_errors=f(t.consecutive_errors),
        base_ejection_s=f(t.base_ejection_s),
        max_eject_frac=f(t.max_eject_frac),
        has_budget=b(t.has_budget),
        budget_frac=f(t.budget_frac),
        budget_min=f(t.budget_min),
        has_hpa=b(t.has_hpa),
        min_replicas=f(t.min_replicas),
        max_replicas=f(t.max_replicas),
        target_util=f(t.target_util),
        sync_period_s=f(t.sync_period_s),
        stabilization_s=f(t.stabilization_s),
        up_step=f(t.up_step),
        down_step=f(t.down_step),
    )


class PolicyState(NamedTuple):
    """Per-service control state carried from block to block."""

    replicas: torch.Tensor       # (S,) f32 — autoscaler's actuated count
    ejected: torch.Tensor        # (S,) f32 — replicas currently ejected
    eject_timer_s: torch.Tensor  # (S,) f32 — sim seconds until return
    err_streak: torch.Tensor     # (S,) f32 — errors over consecutive
    #                              erroring windows (ejection trigger)
    shed: torch.Tensor           # (S,) f32 in [0,1] — breaker shed frac
    was_open: torch.Tensor       # (S,) bool — breaker ever tripped
    retry_allow: torch.Tensor    # (S,) f32 in [0,1] — budgeted retry prob
    down_streak_s: torch.Tensor  # (S,) f32 — time desired < current
    next_sync_s: torch.Tensor    # (S,) f32 — next autoscaler sync time
    last_window: int             # last processed window (host integer)
    trips: torch.Tensor          # (S,) f32 — breaker open transitions
    ejections: torch.Tensor      # (S,) f32 — ejection events
    scale_events: torch.Tensor   # (S,) f32 — autoscaler actuations


class PolicyFx(NamedTuple):
    """The policy state's effect on one block's physics."""

    replicas: torch.Tensor      # (S,) f32 — effective replica count >= 1
    shed: torch.Tensor          # (S,) f32 — admission-shed probability
    retry_allow: torch.Tensor   # (S,) f32 — attempt>=1 survival prob
    # panic-routing inputs (sim/lb.py): the actuated pool size and its
    # UNfloored healthy remainder (replicas minus ejections)
    total: Optional[torch.Tensor] = None   # (S,) f32
    alive: Optional[torch.Tensor] = None   # (S,) f32


class PolicySummary(NamedTuple):
    """Per-window actuation series + event counters.

    Series hold the state in effect at each window's END (after that
    window's control update); unprocessed windows are zero with
    ``windows_done`` 0."""

    window_s: torch.Tensor       # scalar f32
    replicas: torch.Tensor       # (S, W) f32 — actuated replicas
    effective: torch.Tensor      # (S, W) f32 — replicas minus ejected
    shed: torch.Tensor           # (S, W) f32
    retry_allow: torch.Tensor    # (S, W) f32
    ejected: torch.Tensor        # (S, W) f32
    breaker_open: torch.Tensor   # (S, W) f32 (0/1)
    windows_done: torch.Tensor   # (W,) f32 (0/1)
    trips: torch.Tensor          # (S,) f32
    ejections: torch.Tensor      # (S,) f32
    scale_events: torch.Tensor   # (S,) f32

    @property
    def num_windows(self) -> int:
        return int(self.windows_done.shape[0])


def init_state(dt: DeviceTables, lag_periods: int = 0) -> PolicyState:
    """The initial policy state.

    ``lag_periods`` delays the autoscaler's FIRST sync by that many
    sync periods (the control loop missing N syncs at startup)."""
    z = torch.zeros_like(dt.static_replicas)
    replicas0 = torch.where(
        dt.has_hpa,
        torch.minimum(
            torch.maximum(dt.static_replicas, dt.min_replicas),
            dt.max_replicas,
        ),
        dt.static_replicas,
    )
    return PolicyState(
        replicas=replicas0,
        ejected=z,
        eject_timer_s=z,
        err_streak=z,
        shed=z,
        was_open=torch.zeros_like(dt.has_hpa),
        retry_allow=torch.ones_like(z),
        down_streak_s=z,
        next_sync_s=dt.sync_period_s * float(np.float32(1 + lag_periods)),
        last_window=-1,
        trips=z,
        ejections=z,
        scale_events=z,
    )


def effects(state: PolicyState) -> PolicyFx:
    """What the NEXT block's physics sees: integer-actuated replicas
    minus ejected capacity (floored at 1 server), the breaker's shed
    probability, and the budgeted retry survival probability."""
    total = torch.round(state.replicas)
    alive = total - torch.round(state.ejected)
    return PolicyFx(
        replicas=torch.clamp(alive, min=1.0),
        shed=state.shed,
        retry_allow=state.retry_allow,
        total=total,
        alive=alive,
    )


def zeros_summary(spec, num_services: int, device="cpu") -> PolicySummary:
    W = spec.num_windows
    S = num_services

    def z(*shape):
        return torch.zeros(shape, dtype=F32, device=device)

    return PolicySummary(
        window_s=torch.full((), spec.window_s, dtype=F32, device=device),
        replicas=z(S, W),
        effective=z(S, W),
        shed=z(S, W),
        retry_allow=z(S, W),
        ejected=z(S, W),
        breaker_open=z(S, W),
        windows_done=z(W),
        trips=z(S),
        ejections=z(S),
        scale_events=z(S),
    )


def observe_block(res, spec, retry_hop_mask: torch.Tensor) -> torch.Tensor:
    """(S, W) executed RETRY hops (attempt >= 1) of one block, binned by
    hop start — the budget law's numerator, an observation channel the
    flight recorder doesn't carry; additive across blocks."""
    from isotope_tpu_torch.metrics import timeline as timeline_mod

    T = spec.num_windows * spec.window_s
    s_c = torch.clamp(res.hop_start, 0.0, T)
    retries = (res.hop_sent & retry_hop_mask[None, :]).to(torch.int64)
    return timeline_mod._service_window_bins(spec, s_c, (retries,))[
        :, 0, :, 0
    ].to(F32)


def completed_windows(t_complete: torch.Tensor, spec) -> int:
    """``floor(t_complete / window_s)``, a float32 division on the
    device as the reference computes it, read once per block.  (The
    divisor is a device tensor: on the card a Python float divisor
    becomes a product with its reciprocal, one rounding off.)"""
    dtw = torch.full((), spec.window_s, dtype=F32, device=t_complete.device)
    return int(torch.floor(t_complete.to(F32) / dtw).item())


def advance(
    state: PolicyState,
    dt_tables: DeviceTables,
    tl_acc,                      # TimelineSummary accumulator
    retry_acc: torch.Tensor,     # (S, W) retry-arrival accumulator
    t_complete: torch.Tensor,    # scalar f32 — sim time every request
    #                              of the run so far has passed
    spec,                        # timeline.TimelineSpec
    stuck_breaker: bool = False,
    downed_w: Optional[torch.Tensor] = None,  # (S, W) chaos-downed count
) -> Tuple[PolicyState, PolicySummary]:
    """Advance the control loop through every newly COMPLETED window:
    the windows ``(state.last_window, floor(t_complete / window_s))``,
    in order (the module docstring's one read per block).  The returned
    PolicySummary delta holds the actuation series for exactly those
    windows, zeros elsewhere.

    ``stuck_breaker``: a tripped breaker never closes (its shed
    fraction only ratchets up).
    """
    dev = state.replicas.device
    W = spec.num_windows
    S = state.replicas.shape[0]
    # the window width as a float32 operand, as the reference's
    # jnp.float32(window_s); the divisions take it as a device tensor
    # (completed_windows)
    dtw = float(np.float32(spec.window_s))
    dtw_t = torch.full((), dtw, dtype=F32, device=dev)
    done_below = completed_windows(t_complete, spec)
    delta = zeros_summary(spec, S, dev)
    live = range(state.last_window + 1, min(done_below, W))
    if len(live) == 0:
        return state, delta
    arr_w = tl_acc.svc_arrivals.to(F32)
    err_w = tl_acc.svc_errors.to(F32)
    busy_w = tl_acc.svc_busy_s
    infl_w = tl_acc.svc_inflight_s
    d = dt_tables
    st = state
    for w in live:
        arr = arr_w[:, w]
        err = err_w[:, w]
        queue = torch.clamp(infl_w[:, w] - busy_w[:, w], min=0.0) / dtw_t
        conc = infl_w[:, w] / dtw_t
        retries = retry_acc[:, w]

        # -- outlier ejection: errors over consecutive erroring windows;
        # a SHEDDING breaker holds the streak (shed requests take the
        # error path, so counting them would self-reinforce)
        shedding = st.shed > 0.0
        streak = torch.where(
            shedding,
            st.err_streak,
            torch.where(err > 0, st.err_streak + err, 0.0),
        )
        current = torch.clamp(torch.round(st.replicas), min=1.0)
        can_eject = (
            torch.isfinite(d.consecutive_errors)
            & ~shedding
            & (streak >= d.consecutive_errors)
            & (st.ejected + 1.0
               <= torch.floor(d.max_eject_frac * current) + 1e-6)
        )
        ejected = st.ejected + torch.where(can_eject, 1.0, 0.0)
        timer = torch.where(
            can_eject,
            d.base_ejection_s,
            torch.clamp(st.eject_timer_s - dtw, min=0.0),
        )
        # baseline interval over: every ejected replica returns
        restored = (timer <= 0.0) & (ejected > 0.0)
        ejected = torch.where(restored, 0.0, ejected)
        streak = torch.where(can_eject, 0.0, streak)

        # -- circuit breaker: shed the overflow past either cap, from the
        # observation divided back by the admitted fraction (the demand
        # reconstruction); the 0.98 ceiling keeps it conditioned
        admit = torch.clamp(1.0 - st.shed, min=0.02)
        over = torch.maximum(
            queue / (admit * d.max_pending),
            conc / (admit * d.max_connections),
        )
        open_now = over > 1.0
        shed_target = torch.where(
            open_now,
            torch.clamp(1.0 - 1.0 / torch.clamp(over, min=1.0), 0.0, 0.98),
            0.0,
        )
        shed_new = (
            torch.maximum(shed_target, st.shed) if stuck_breaker
            else shed_target
        )
        # a TRIP is a closed -> open transition (shed was 0)
        trips = st.trips + torch.where(open_now & (st.shed <= 0.0), 1.0, 0.0)
        was_open = st.was_open | open_now

        # -- retry budget: allow = headroom / UNSUPPRESSED demand
        headroom = d.budget_frac * arr + d.budget_min
        demand = retries / torch.clamp(st.retry_allow, min=1e-3)
        allow = torch.where(
            d.has_budget & (demand > headroom),
            torch.clamp(headroom / torch.clamp(demand, min=1e-6), 0.0, 1.0),
            1.0,
        )

        # -- autoscaler: HPA formula at sync boundaries, utilization over
        # the ALIVE capacity (actuated minus ejected minus chaos-downed)
        w_end = float(np.float32(np.float32(w + 1) * np.float32(dtw)))
        down_now = downed_w[:, w] if downed_w is not None else 0.0
        alive_raw = current - torch.round(st.ejected) - down_now
        alive = torch.clamp(alive_raw, min=1.0)
        util = busy_w[:, w] / (dtw * alive)
        desired = torch.minimum(
            torch.maximum(
                torch.ceil(current * util / d.target_util), d.min_replicas
            ),
            d.max_replicas,
        )
        # no ready pods during a full kill: hold the count, the
        # stabilization streak and the sync clock
        no_pods = alive_raw < 0.5
        down_streak = torch.where(
            no_pods,
            st.down_streak_s,
            torch.where(desired < current, st.down_streak_s + dtw, 0.0),
        )
        do_sync = d.has_hpa & (w_end >= st.next_sync_s) & ~no_pods
        scale_up = do_sync & (desired > current)
        scale_down = (
            do_sync
            & (desired < current)
            & (down_streak >= d.stabilization_s)
        )
        new_count = torch.where(
            scale_up,
            torch.minimum(desired, current + d.up_step),
            torch.where(
                scale_down,
                torch.maximum(desired, current - d.down_step),
                st.replicas,
            ),
        )
        next_sync = torch.where(
            do_sync, st.next_sync_s + d.sync_period_s, st.next_sync_s
        )
        scale_events = st.scale_events + torch.where(
            scale_up | scale_down, 1.0, 0.0
        )
        st = PolicyState(
            replicas=new_count,
            ejected=ejected,
            eject_timer_s=timer,
            err_streak=streak,
            shed=shed_new,
            was_open=was_open,
            retry_allow=allow,
            down_streak_s=down_streak,
            next_sync_s=next_sync,
            last_window=w,
            trips=trips,
            ejections=st.ejections + torch.where(can_eject, 1.0, 0.0),
            scale_events=scale_events,
        )
        fx = effects(st)
        delta.replicas[:, w] = st.replicas
        delta.effective[:, w] = fx.replicas
        delta.shed[:, w] = st.shed
        delta.retry_allow[:, w] = st.retry_allow
        delta.ejected[:, w] = st.ejected
        delta.breaker_open[:, w] = (st.shed > 0.0).to(F32)
    delta.windows_done[live.start:live.stop] = 1.0
    delta = delta._replace(
        trips=st.trips - state.trips,
        ejections=st.ejections - state.ejections,
        scale_events=st.scale_events - state.scale_events,
    )
    return st, delta


def accumulate_summary(
    acc: PolicySummary, delta: PolicySummary
) -> PolicySummary:
    """Fold one block's per-window delta into the carried summary (each
    window is processed exactly once, so sums reconstruct the series)."""
    return PolicySummary(
        acc.window_s, *(a + b for a, b in zip(acc[1:], delta[1:]))
    )


# -- host-side reporting ---------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def to_doc(
    compiled, pol: PolicySummary, tables: PolicyTables
) -> dict:
    """The ``policies.json`` artifact (``isotope-policies/v1``):
    per-service actuation series plus sim-time ONSETS — the first
    breaker trip, first scale event, and recovery (shed back to 0)
    windows — so a chaos phase's breaker-trip -> budget-cap ->
    autoscaler-recovery cascade reads directly off the document."""
    names = compiled.services.names
    dt = float(pol.window_s)
    done = _np(pol.windows_done) > 0
    reps = _np(pol.replicas)
    eff = _np(pol.effective)
    shed = _np(pol.shed)
    allow = _np(pol.retry_allow)
    ejected = _np(pol.ejected)
    open_w = _np(pol.breaker_open)
    trips = _np(pol.trips)
    ejections = _np(pol.ejections)
    scale_events = _np(pol.scale_events)
    W = pol.num_windows
    # processed windows form a prefix of the grid; the series are
    # truncated to it — beyond ``windows_done`` the state was never
    # advanced (zero-filled on device), which would read as replicas=0
    # / allow=0
    k = int(done.sum())

    def onset(mask_row) -> Optional[float]:
        idx = np.nonzero(mask_row & done)[0]
        return round(float(idx[0]) * dt, 6) if len(idx) else None

    services: Dict[str, dict] = {}
    for s, name in enumerate(names):
        protected = (
            np.isfinite(tables.max_pending[s])
            or np.isfinite(tables.max_connections[s])
            or np.isfinite(tables.consecutive_errors[s])
            or bool(tables.has_budget[s])
            or bool(tables.has_hpa[s])
        )
        if not protected:
            continue
        trip_t = onset(open_w[s] > 0)
        recover_t = None
        if trip_t is not None:
            after = (np.arange(W) * dt > trip_t) & done
            closed = after & (shed[s] <= 0)
            idx = np.nonzero(closed)[0]
            recover_t = (
                round(float(idx[0]) * dt, 6) if len(idx) else None
            )
        services[name] = {
            "replicas": [round(float(v), 3) for v in reps[s][:k]],
            "effective_replicas": [
                round(float(v), 3) for v in eff[s][:k]
            ],
            "shed": [round(float(v), 6) for v in shed[s][:k]],
            "retry_allow": [
                round(float(v), 6) for v in allow[s][:k]
            ],
            "ejected": [round(float(v), 3) for v in ejected[s][:k]],
            "breaker_trips": float(trips[s]),
            "ejections": float(ejections[s]),
            "scale_events": float(scale_events[s]),
            "breaker_trip_onset_s": trip_t,
            "breaker_recovery_s": recover_t,
            # baseline = the INITIAL actuated count (init_state), not
            # the first window's post-update value — a scale landing
            # in window 0 is still an onset
            "first_scale_onset_s": onset(
                np.abs(
                    reps[s]
                    - (
                        float(np.clip(
                            tables.static_replicas[s],
                            tables.min_replicas[s],
                            tables.max_replicas[s],
                        ))
                        if tables.has_hpa[s]
                        else float(tables.static_replicas[s])
                    )
                ) > 1e-6
            ),
            "peak_replicas": float(reps[s].max(initial=0.0)),
        }
    return {
        "schema": "isotope-policies/v1",
        "window_s": dt,
        "num_windows": W,
        "windows_done": int(done.sum()),
        "services": services,
    }


def format_table(doc: dict) -> str:
    """Human-readable policy actuation table (CLI stderr rendering)."""
    from isotope_tpu_torch.metrics.timeline import sparkline

    lines = [
        f"policies: {doc['windows_done']}/{doc['num_windows']} windows "
        f"x {doc['window_s']:g}s"
    ]
    for name, svc in doc.get("services", {}).items():
        bits = [f"{name:<20} replicas {sparkline(svc['replicas'])}"]
        if svc["breaker_trips"]:
            bits.append(
                f"trips {svc['breaker_trips']:.0f}"
                + (f" @{svc['breaker_trip_onset_s']:g}s"
                   if svc["breaker_trip_onset_s"] is not None else "")
            )
        if svc["ejections"]:
            bits.append(f"ejections {svc['ejections']:.0f}")
        if svc["scale_events"]:
            bits.append(
                f"scales {svc['scale_events']:.0f} "
                f"peak {svc['peak_replicas']:.0f}"
            )
        if any(a < 1.0 for a in svc["retry_allow"]):
            bits.append("budget-capped")
        lines.append("  ".join(bits))
    return "\n".join(lines)
