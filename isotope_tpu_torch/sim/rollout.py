"""Reactive canary rollouts: closed-loop progressive delivery, in torch.

The port of ``isotope_tpu.sim.rollout``.  A topology ``rollouts:`` block
declares, per service, a two-version (baseline/canary) deployment: a
**step schedule** of traffic weights (e.g. 1% -> 5% -> 25% -> 100%), a
**bake time** per step, **SLO gates** (canary error share and a
mean-latency proxy vs the baseline arm, with min-sample guards), and a
**rollback policy** (cooldown + bounded retries).

Canary physics are real: the canary arm carries its own
``error_rate`` / ``cpu_time`` / ``replicas`` overrides, a request hop
routes to the canary with the CURRENT weight (a per-hop version coin),
the canary arm is its own M/M/k station fed the split-off load, and a
chaos kill on a rolled-out service takes the CANARY replicas first.

The controller observes a per-version channel — the flight recorder's
(S, W) series extended to (S, 2, W): per-service, per-ARM, per-window
arrivals / errors / latency sums / executed hops (the latency means
divide by EXECUTED hops only, so chaos-refused calls feed the error
gate without diluting the latency gate) — and advances window by
window in the protected block loop (``Simulator.run_rollouts``): it
**PROMOTES** when a bake window passes its gates, **HOLDS** while
either arm lacks ``min_samples``, and **ROLLS BACK** (weight -> 0,
cooldown, bounded retry count) the moment a gate trips.  Observation is
window-granular and actuation block-granular, as in
``sim/policies.py``.

The host half (decode with the reference's messages, ``RolloutTables``,
``build_tables``, ``lint_rollouts``, ``to_doc``, ``format_table``) is a
copy; the device half is elementwise float32 torch over (S,) vectors,
applied only to the windows completed since the last block (the
``sim/policies.py`` reading).

Everything is off by default: a Simulator built without rollout tables
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


# -- rollout configuration (the topology YAML `rollouts:` block) -----------


_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class RolloutGates:
    """The per-step SLO gates a bake window must pass to promote.

    The error gate compares the canary arm's ERROR SHARE against the
    baseline arm's over the current step's accumulated samples:
    it trips when ``share_canary > max_error_ratio * share_baseline +
    error_slack`` (the additive slack keeps a zero-error baseline from
    tripping on one noisy canary 500) or when the absolute
    ``max_error_share`` is exceeded.  The latency gate compares the
    arms' mean-latency proxies (windowed latency sums / counts):
    ``mean_canary > max_latency_ratio * mean_baseline`` trips it.
    Gates only evaluate once BOTH arms hold ``min_samples`` executed
    hops — the min-sample guard that makes a 1% step statistically
    honest.  ``inf`` disables a gate.
    """

    max_error_ratio: float = 2.0
    error_slack: float = 0.01
    max_error_share: float = _INF
    max_latency_ratio: float = 2.0
    min_samples: float = 50.0

    _FIELDS = {
        "max_error_ratio", "error_slack", "max_error_share",
        "max_latency_ratio", "min_samples",
    }

    @classmethod
    def decode(cls, value: dict) -> "RolloutGates":
        if not isinstance(value, dict):
            raise ValueError(f"gates must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(f"unknown gates fields: {sorted(unknown)}")

        field = functools.partial(_field, value)

        out = cls(
            max_error_ratio=field("max_error_ratio", _num, 2.0),
            error_slack=field("error_slack", _frac, 0.01),
            max_error_share=field("max_error_share", _frac, _INF),
            max_latency_ratio=field("max_latency_ratio", _num, 2.0),
            min_samples=field("min_samples", _num, 50.0),
        )
        if out.max_error_ratio <= 0 or out.max_latency_ratio <= 0:
            raise ValueError("gate ratios must be positive")
        if out.min_samples < 1:
            with config_path("min_samples"):
                raise ValueError("min_samples must be >= 1")
        return out


@dataclasses.dataclass(frozen=True)
class RollbackPolicy:
    """What happens after a gate trips: the canary weight snaps to 0,
    the rollout cools down for ``cooldown_s`` sim seconds, and then
    restarts from step 0 — at most ``max_retries`` times (0 = one
    strike and the rollout stays reverted)."""

    cooldown_s: float = 30.0
    max_retries: int = 0

    _FIELDS = {"cooldown", "max_retries"}

    @classmethod
    def decode(cls, value: dict) -> "RollbackPolicy":
        if not isinstance(value, dict):
            raise ValueError(f"rollback must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(
                f"unknown rollback fields: {sorted(unknown)}"
            )

        field = functools.partial(_field, value)

        out = cls(
            cooldown_s=field("cooldown", _dur, 30.0),
            max_retries=field("max_retries", _int, 0),
        )
        if out.cooldown_s <= 0:
            with config_path("cooldown"):
                raise ValueError("cooldown must be positive")
        if out.max_retries < 0:
            with config_path("max_retries"):
                raise ValueError("max_retries must be >= 0")
        return out


@dataclasses.dataclass(frozen=True)
class CanaryOverrides:
    """The canary arm's OWN physics — what makes a bad push bad.

    ``None`` inherits the baseline service's value.  ``replicas``
    defaults to 1 (a canary deployment is one pod until promoted)."""

    error_rate: Optional[float] = None
    cpu_time_s: Optional[float] = None
    replicas: int = 1

    _FIELDS = {"error_rate", "cpu_time", "replicas"}

    @classmethod
    def decode(cls, value: dict) -> "CanaryOverrides":
        if not isinstance(value, dict):
            raise ValueError(f"canary must be a mapping: {value!r}")
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(f"unknown canary fields: {sorted(unknown)}")

        field = functools.partial(_field, value)

        out = cls(
            error_rate=field("error_rate", _frac, None),
            cpu_time_s=field("cpu_time", _dur, None),
            replicas=field("replicas", _int, 1),
        )
        if out.cpu_time_s is not None and out.cpu_time_s <= 0:
            with config_path("cpu_time"):
                raise ValueError("cpu_time must be positive")
        if out.replicas < 1:
            with config_path("replicas"):
                raise ValueError("replicas must be >= 1")
        return out


@dataclasses.dataclass(frozen=True)
class ServiceRollout:
    """One service's progressive-delivery declaration.

    A rollout is ACTIVE only when it declares a non-empty ``steps``
    schedule; an entry carrying canary overrides but no steps never
    actuates (the vet linter flags it, VET-T018)."""

    steps: Tuple[float, ...] = ()
    bake_s: float = 30.0
    gates: RolloutGates = RolloutGates()
    rollback: RollbackPolicy = RollbackPolicy()
    canary: CanaryOverrides = CanaryOverrides()

    _FIELDS = {"steps", "bake", "gates", "rollback", "canary"}

    @property
    def active(self) -> bool:
        return len(self.steps) > 0

    @classmethod
    def decode(
        cls, value: dict, default: "ServiceRollout"
    ) -> "ServiceRollout":
        if value is None:
            value = {}
        if not isinstance(value, dict):
            raise ValueError(
                f"service rollout must be a mapping: {value!r}"
            )
        unknown = set(value) - cls._FIELDS
        if unknown:
            raise ValueError(f"unknown rollout fields: {sorted(unknown)}")

        def block(key, decode, fallback):
            if key not in value or value[key] is None:
                return fallback
            with config_path(key):
                return decode(value[key])

        steps = default.steps
        if "steps" in value and value["steps"] is not None:
            raw = value["steps"]
            if not isinstance(raw, (list, tuple)) or not raw:
                with config_path("steps"):
                    raise ValueError(
                        f"steps must be a non-empty list: {raw!r}"
                    )
            decoded = []
            for i, s in enumerate(raw):
                with config_path(f"steps[{i}]"):
                    w = _frac(s)
                    if not 0.0 < w <= 1.0:
                        raise ValueError(
                            f"step weight must lie in (0, 100%]: {s!r}"
                        )
                    decoded.append(w)
            steps = tuple(decoded)
        return cls(
            steps=steps,
            bake_s=block("bake", _dur, default.bake_s),
            gates=block("gates", RolloutGates.decode, default.gates),
            rollback=block(
                "rollback", RollbackPolicy.decode, default.rollback
            ),
            canary=block(
                "canary", CanaryOverrides.decode, default.canary
            ),
        )


@dataclasses.dataclass(frozen=True)
class RolloutSet:
    """The decoded ``rollouts:`` block of a topology YAML.

    Schema::

        rollouts:
          defaults:              # seeds bake/gates/rollback (no steps)
            bake: 10s
            gates: {min_samples: 100}
          worker:
            steps: [1%, 5%, 25%, 50%, 100%]
            rollback: {cooldown: 30s, max_retries: 1}
            canary: {error_rate: 0.3%, cpu_time: 90us, replicas: 2}

    ``defaults`` may not declare ``steps`` or ``canary`` — a schedule
    applying to EVERY service would silently canary the whole mesh."""

    per_service: Dict[str, ServiceRollout]
    defaults: ServiceRollout

    @classmethod
    def decode(cls, raw: dict, service_names) -> "RolloutSet":
        if not isinstance(raw, dict):
            raise ValueError(f"rollouts must be a mapping: {raw!r}")
        names = list(service_names)
        with config_path("rollouts"):
            raw_defaults = raw.get("defaults") or {}
            with config_path("defaults"):
                if not isinstance(raw_defaults, dict):
                    raise ValueError(
                        f"defaults must be a mapping: {raw_defaults!r}"
                    )
                banned = {"steps", "canary"} & set(raw_defaults)
                if banned:
                    raise ValueError(
                        f"rollout defaults may not declare "
                        f"{sorted(banned)} (a schedule applying to "
                        "every service would canary the whole mesh)"
                    )
                default = ServiceRollout.decode(
                    raw_defaults, ServiceRollout()
                )
            per: Dict[str, ServiceRollout] = {}
            for key, value in raw.items():
                if key == "defaults":
                    continue
                if key not in names:
                    raise ValueError(
                        f"rollouts target unknown service {key!r}"
                    )
                with config_path(key):
                    per[key] = ServiceRollout.decode(value, default)
        return cls(per_service=per, defaults=default)

    def for_service(self, name: str) -> ServiceRollout:
        return self.per_service.get(name, self.defaults)

    @property
    def empty(self) -> bool:
        return not any(r.active for r in self.per_service.values())


def lint_rollouts(
    raw: dict, service_names
) -> Tuple[Optional[RolloutSet], List[Tuple[str, str]]]:
    """Decode a raw ``rollouts:`` block tolerantly for the vet linter
    (the sim/policies.py ``lint_policies`` idiom): decode errors become
    findings instead of crashes."""
    try:
        return RolloutSet.decode(raw, service_names), []
    except ValueError as e:
        return None, [("decode", str(e))]


# -- dense per-service tables (compiler/compile.compile_rollouts) ----------


@dataclasses.dataclass(frozen=True)
class RolloutTables:
    """The ``rollouts:`` block lowered to dense per-service arrays in
    compiled service order — the device-constant form the engine's
    rollout scan consumes.  ``steps`` is right-padded with each row's
    final weight so a promoted-past-the-end index stays at 100%."""

    names: Tuple[str, ...]
    has_rollout: np.ndarray        # (S,) bool
    steps: np.ndarray              # (S, M) f64
    num_steps: np.ndarray          # (S,) i64 — 0 = inactive
    bake_s: np.ndarray             # (S,) f64
    cooldown_s: np.ndarray         # (S,) f64
    max_retries: np.ndarray        # (S,) f64
    err_ratio: np.ndarray          # (S,) f64, inf = off
    err_slack: np.ndarray          # (S,) f64
    err_share: np.ndarray          # (S,) f64, inf = off
    lat_ratio: np.ndarray          # (S,) f64, inf = off
    min_samples: np.ndarray        # (S,) f64
    canary_error_rate: np.ndarray  # (S,) f64 — baseline-substituted
    canary_cpu_s: np.ndarray       # (S,) f64 — nan = inherit cpu_time
    canary_replicas: np.ndarray    # (S,) i64

    @property
    def num_services(self) -> int:
        return len(self.names)

    @property
    def max_steps(self) -> int:
        return int(self.steps.shape[1])

    @property
    def any_error_override(self) -> bool:
        """True when any canary arm can 500 — the engine must draw the
        error coins (and track errors) even on error-free baselines."""
        return bool(
            (self.canary_error_rate[self.has_rollout] > 0.0).any()
        )

    @property
    def any_cpu_override(self) -> bool:
        return bool(np.isfinite(self.canary_cpu_s).any())

    @property
    def k_max(self) -> int:
        """Widest canary station (extends the Erlang recursion length
        next to the static/autoscaled maxima)."""
        if not self.has_rollout.any():
            return 1
        return int(self.canary_replicas[self.has_rollout].max())

    def signature(self) -> str:
        """Stable identity for executable-cache keys."""
        fields = dataclasses.fields(self)
        parts = [f"{self.names!r}"]
        for f in fields[1:]:
            parts.append(np.asarray(getattr(self, f.name)).tobytes().hex())
        return "rollouts:" + "|".join(parts)


def build_tables(rset: RolloutSet, services) -> RolloutTables:
    """Lower a decoded RolloutSet against a compiled ServiceTable."""
    names = tuple(services.names)
    S = len(names)
    M = max(
        [len(rset.for_service(n).steps) for n in names] + [1]
    )

    def arr(fill):
        return np.full(S, fill, np.float64)

    has = np.zeros(S, bool)
    steps = np.zeros((S, M), np.float64)
    num_steps = np.zeros(S, np.int64)
    bake = arr(30.0)
    cooldown = arr(30.0)
    retries = arr(0.0)
    err_ratio = arr(_INF)
    err_slack = arr(0.0)
    err_share = arr(_INF)
    lat_ratio = arr(_INF)
    min_samples = arr(1.0)
    can_err = np.asarray(services.error_rate, np.float64).copy()
    can_cpu = arr(np.nan)
    can_reps = np.ones(S, np.int64)
    for s, name in enumerate(names):
        r = rset.for_service(name)
        if not r.active:
            continue
        has[s] = True
        k = len(r.steps)
        steps[s, :k] = r.steps
        steps[s, k:] = r.steps[-1]
        num_steps[s] = k
        bake[s] = r.bake_s
        cooldown[s] = r.rollback.cooldown_s
        retries[s] = float(r.rollback.max_retries)
        g = r.gates
        err_ratio[s] = g.max_error_ratio
        err_slack[s] = g.error_slack
        err_share[s] = g.max_error_share
        lat_ratio[s] = g.max_latency_ratio
        min_samples[s] = g.min_samples
        if r.canary.error_rate is not None:
            can_err[s] = r.canary.error_rate
        if r.canary.cpu_time_s is not None:
            can_cpu[s] = r.canary.cpu_time_s
        can_reps[s] = r.canary.replicas
    return RolloutTables(
        names=names,
        has_rollout=has,
        steps=steps,
        num_steps=num_steps,
        bake_s=bake,
        cooldown_s=cooldown,
        max_retries=retries,
        err_ratio=err_ratio,
        err_slack=err_slack,
        err_share=err_share,
        lat_ratio=lat_ratio,
        min_samples=min_samples,
        canary_error_rate=can_err,
        canary_cpu_s=can_cpu,
        canary_replicas=can_reps,
    )


# -- device-side state / control law --------------------------------------

import torch  # noqa: E402

F32 = torch.float32

#: RolloutState.phase codes — float32 state values
PHASE_ROLLING = 0.0   # a step is baking (or holding for samples)
PHASE_DONE = 1.0      # promoted through the whole schedule
PHASE_COOLDOWN = 2.0  # rolled back; retry pending after the cooldown
PHASE_FAILED = 3.0    # rolled back with retries exhausted (weight 0)

PHASE_NAMES = {0: "rolling", 1: "done", 2: "cooldown", 3: "failed"}


class DeviceTables(NamedTuple):
    """RolloutTables as float32 tensors on the run's device."""

    has_rollout: torch.Tensor     # (S,) bool
    steps: torch.Tensor           # (S, M)
    num_steps: torch.Tensor       # (S,)
    bake_s: torch.Tensor
    cooldown_s: torch.Tensor
    max_retries: torch.Tensor
    err_ratio: torch.Tensor       # inf = off
    err_slack: torch.Tensor
    err_share: torch.Tensor       # inf = off
    lat_ratio: torch.Tensor       # inf = off
    min_samples: torch.Tensor


def device_tables(t: RolloutTables, device="cpu") -> DeviceTables:
    def f(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return DeviceTables(
        has_rollout=torch.tensor(np.asarray(t.has_rollout, bool),
                                 device=device),
        steps=f(t.steps),
        num_steps=f(t.num_steps),
        bake_s=f(t.bake_s),
        cooldown_s=f(t.cooldown_s),
        max_retries=f(t.max_retries),
        err_ratio=f(t.err_ratio),
        err_slack=f(t.err_slack),
        err_share=f(t.err_share),
        lat_ratio=f(t.lat_ratio),
        min_samples=f(t.min_samples),
    )


class RolloutState(NamedTuple):
    """Per-service rollout-controller state carried from block to block."""

    phase: torch.Tensor        # (S,) f32 — PHASE_* code
    step: torch.Tensor         # (S,) f32 — current schedule index
    weight: torch.Tensor       # (S,) f32 — actuated canary traffic weight
    bake_t: torch.Tensor       # (S,) f32 — sim seconds into the step
    cooldown_t: torch.Tensor   # (S,) f32 — rollback cooldown remaining
    retries_left: torch.Tensor  # (S,) f32
    # per-arm observation accumulators over the CURRENT step
    cnt_b: torch.Tensor        # (S,) f32 — baseline arrivals (incl. refused)
    cnt_c: torch.Tensor        # (S,) f32 — canary arrivals (incl. refused)
    err_b: torch.Tensor        # (S,) f32
    err_c: torch.Tensor        # (S,) f32
    lat_b: torch.Tensor        # (S,) f32 — latency sums (proxy numerator)
    lat_c: torch.Tensor        # (S,) f32
    exe_b: torch.Tensor        # (S,) f32 — EXECUTED hops (latency denom)
    exe_c: torch.Tensor        # (S,) f32
    last_window: int           # last processed window (host integer)


class RolloutFx(NamedTuple):
    """The rollout state's effect on one block's physics."""

    weight: torch.Tensor  # (S,) f32 — canary admission weight in [0, 1]


class RolloutSummary(NamedTuple):
    """Per-window actuation series + per-version observation series.

    The weight/step/phase series hold the state at each window's END;
    event series mark the window a promote/hold/rollback landed in.
    ``ver_*`` are the (S, 2, W) per-arm window series (version 0 =
    baseline, 1 = canary), attached from the observation accumulator
    after the run."""

    window_s: torch.Tensor      # scalar f32
    weight: torch.Tensor        # (S, W) f32
    step: torch.Tensor          # (S, W) f32
    phase: torch.Tensor         # (S, W) f32 — PHASE_* codes
    promotions: torch.Tensor    # (S, W) f32 (0/1 events)
    holds: torch.Tensor         # (S, W) f32
    rollbacks: torch.Tensor     # (S, W) f32
    windows_done: torch.Tensor  # (W,) f32 (0/1)
    ver_arrivals: torch.Tensor  # (S, 2, W) f32 — executed hops per arm
    ver_errors: torch.Tensor    # (S, 2, W) f32
    ver_latency_s: torch.Tensor  # (S, 2, W) f32 — hop-latency sums

    @property
    def num_windows(self) -> int:
        return int(self.windows_done.shape[0])


def init_state(dt: DeviceTables) -> RolloutState:
    """The initial rollout state: every active rollout starts at step
    0's weight with its full retry budget."""
    z = torch.zeros_like(dt.num_steps)
    return RolloutState(
        phase=z,
        step=z,
        weight=torch.where(dt.has_rollout, dt.steps[:, 0], 0.0),
        bake_t=z,
        cooldown_t=z,
        retries_left=dt.max_retries,
        cnt_b=z, cnt_c=z, err_b=z, err_c=z, lat_b=z, lat_c=z,
        exe_b=z, exe_c=z,
        last_window=-1,
    )


def effects(state: RolloutState) -> RolloutFx:
    """What the NEXT block's physics sees: the canary admission weight
    (0 for un-rolled-out services, and 0 during cooldown/failed)."""
    return RolloutFx(weight=state.weight)


def zeros_summary(spec, num_services: int, device="cpu") -> RolloutSummary:
    W = spec.num_windows
    S = num_services

    def z(*shape):
        return torch.zeros(shape, dtype=F32, device=device)

    return RolloutSummary(
        window_s=torch.full((), spec.window_s, dtype=F32, device=device),
        weight=z(S, W),
        step=z(S, W),
        phase=z(S, W),
        promotions=z(S, W),
        holds=z(S, W),
        rollbacks=z(S, W),
        windows_done=z(W),
        ver_arrivals=z(S, 2, W),
        ver_errors=z(S, 2, W),
        ver_latency_s=z(S, 2, W),
    )


def observe_block(res, spec) -> torch.Tensor:
    """(S, 2, W, 4) per-service, per-ARM window sums of one block —
    channels (arrived hops incl. refused, hop 500s, hop-latency sum,
    EXECUTED hops), binned by hop start (``SimResults.hop_canary`` is
    the per-hop version coin); additive across blocks."""
    from isotope_tpu_torch.metrics import timeline as timeline_mod

    if res.hop_canary is None:
        raise ValueError(
            "rollout observation needs SimResults.hop_canary (produced "
            "by rollout-actuated blocks)"
        )
    T = spec.num_windows * spec.window_s
    s_c = torch.clamp(res.hop_start, 0.0, T)
    exe = res.hop_sent.to(torch.int64)
    err = (res.hop_sent & res.hop_error).to(torch.int64)
    lat = exe * timeline_mod.fixed_point(res.hop_latency)
    sent = exe
    if res.hop_refused is not None:
        # a would-send hop whose target arm was chaos-downed transport-
        # failed: the gate sees it as an arrival and an error, with no
        # latency sample
        ref = res.hop_refused.to(torch.int64)
        sent = sent + ref
        err = err + ref
    obs = timeline_mod.versioned_service_windows(
        spec, s_c, res.hop_canary, (sent, err, lat, exe)
    ).to(torch.float64)
    obs[..., 2] *= timeline_mod.TIME_UNIT
    return obs.to(F32)


def advance(
    state: RolloutState,
    dt_tables: DeviceTables,
    obs_acc: torch.Tensor,       # (S, 2, W, 4) per-arm accumulator
    t_complete: torch.Tensor,    # scalar f32 — sim time every request
    #                              of the run so far has passed
    spec,                        # timeline.TimelineSpec
) -> Tuple[RolloutState, RolloutSummary]:
    """Advance the rollout controller through every newly COMPLETED
    window, in order (``sim/policies.advance``'s reading).  Per window,
    for each service with an active rollout:

    1. while ROLLING, fold the window's per-arm observations into the
       step accumulators and advance the bake clock;
    2. evaluate the gates once both arms hold ``min_samples`` — a trip
       ROLLS BACK immediately (weight 0, cooldown armed, retry budget
       decremented; an exhausted budget parks the rollout FAILED);
    3. a bake window that elapses with passing gates PROMOTES to the
       next step (past the last step: DONE at the final weight); one
       that elapses still short of samples HOLDS;
    4. while COOLING DOWN, burn the cooldown clock; expiry restarts the
       schedule from step 0.
    """
    from isotope_tpu_torch.sim.policies import completed_windows

    dev = state.weight.device
    W = spec.num_windows
    S = state.weight.shape[0]
    # the window width as a float32 scalar operand, as the reference's
    # jnp.float32(window_s)
    dtw = float(np.float32(spec.window_s))
    done_below = completed_windows(t_complete, spec)
    delta = zeros_summary(spec, S, dev)
    live = range(state.last_window + 1, min(done_below, W))
    if len(live) == 0:
        return state, delta
    d = dt_tables
    M = d.steps.shape[1]
    cnt_w = obs_acc[:, :, :, 0]
    err_w = obs_acc[:, :, :, 1]
    lat_w = obs_acc[:, :, :, 2]
    exe_w = obs_acc[:, :, :, 3]

    def weight_at(step):
        idx = torch.clamp(step, 0.0, M - 1.0).to(torch.int64)[:, None]
        return torch.gather(d.steps, 1, idx)[:, 0]

    st = state
    for w in live:
        rolling = d.has_rollout & (st.phase == PHASE_ROLLING)
        cooling = d.has_rollout & (st.phase == PHASE_COOLDOWN)

        roll_f = rolling.to(F32)
        cnt_b = st.cnt_b + roll_f * cnt_w[:, 0, w]
        cnt_c = st.cnt_c + roll_f * cnt_w[:, 1, w]
        err_b = st.err_b + roll_f * err_w[:, 0, w]
        err_c = st.err_c + roll_f * err_w[:, 1, w]
        lat_b = st.lat_b + roll_f * lat_w[:, 0, w]
        lat_c = st.lat_c + roll_f * lat_w[:, 1, w]
        exe_b = st.exe_b + roll_f * exe_w[:, 0, w]
        exe_c = st.exe_c + roll_f * exe_w[:, 1, w]
        bake = st.bake_t + roll_f * dtw

        # -- gates, once min-samples are met.  At a full-traffic step the
        # baseline arm is starved by construction: the guard degrades to
        # canary-only and the ratio gates disarm with it, while the
        # absolute error-share gate stays armed
        cur_w = weight_at(st.step)
        enough_c = cnt_c >= d.min_samples
        enough_b = cnt_b >= d.min_samples
        enough = enough_c & (enough_b | (cur_w >= 1.0))
        share_c = err_c / torch.clamp(cnt_c, min=1.0)
        share_b = err_b / torch.clamp(cnt_b, min=1.0)
        # latency means divide by EXECUTED hops only
        mean_c = lat_c / torch.clamp(exe_c, min=1.0)
        mean_b = lat_b / torch.clamp(exe_b, min=1.0)
        err_trip = (share_c > d.err_share) | (
            torch.isfinite(d.err_ratio)
            & enough_b
            & (share_c > d.err_ratio * share_b + d.err_slack)
        )
        lat_trip = (
            torch.isfinite(d.lat_ratio)
            & enough_b
            & (mean_b > 0.0)
            & (mean_c > d.lat_ratio * mean_b)
        )
        trip = rolling & enough & (err_trip | lat_trip)

        # -- promote / hold at the bake boundary
        baked = bake >= d.bake_s
        promote = rolling & ~trip & enough & baked
        hold = rolling & ~trip & ~enough & baked
        new_step = st.step + promote.to(F32)
        finished = promote & (new_step >= d.num_steps)

        # -- rollback: trip -> weight 0, cooldown, bounded retries
        retries_left = st.retries_left - trip.to(F32)
        rb_cool = trip & (retries_left >= 0.0)
        rb_fail = trip & (retries_left < 0.0)

        # -- cooldown countdown / restart
        cd = torch.where(
            cooling, torch.clamp(st.cooldown_t - dtw, min=0.0),
            st.cooldown_t,
        )
        restart = cooling & (cd <= 0.0)

        phase = torch.where(
            finished, PHASE_DONE,
            torch.where(
                rb_fail, PHASE_FAILED,
                torch.where(
                    rb_cool, PHASE_COOLDOWN,
                    torch.where(restart, PHASE_ROLLING, st.phase),
                ),
            ),
        )
        step = torch.where(
            finished, d.num_steps - 1.0,
            torch.where(trip | restart, 0.0, new_step),
        )
        # a step transition (promote / trip / restart) resets the bake
        # clock and the per-step accumulators
        reset = promote | trip | restart

        def acc(v):
            return torch.where(reset, 0.0, v)

        weight = torch.where(
            d.has_rollout & (
                (phase == PHASE_ROLLING) | (phase == PHASE_DONE)
            ),
            weight_at(step),
            0.0,
        )
        st = RolloutState(
            phase=phase,
            step=step,
            weight=weight,
            bake_t=torch.where(reset, 0.0, bake),
            cooldown_t=torch.where(rb_cool, d.cooldown_s, cd),
            retries_left=torch.where(trip, retries_left, st.retries_left),
            cnt_b=acc(cnt_b), cnt_c=acc(cnt_c),
            err_b=acc(err_b), err_c=acc(err_c),
            lat_b=acc(lat_b), lat_c=acc(lat_c),
            exe_b=acc(exe_b), exe_c=acc(exe_c),
            last_window=w,
        )
        delta.weight[:, w] = st.weight
        delta.step[:, w] = st.step
        delta.phase[:, w] = st.phase
        delta.promotions[:, w] = promote.to(F32)
        delta.holds[:, w] = hold.to(F32)
        delta.rollbacks[:, w] = trip.to(F32)
    delta.windows_done[live.start:live.stop] = 1.0
    return st, delta


def accumulate_summary(
    acc: RolloutSummary, delta: RolloutSummary
) -> RolloutSummary:
    """Fold one block's per-window delta into the carried summary (the
    ``ver_*`` channels ride zero here and are attached from the
    observation accumulator after the run)."""
    return RolloutSummary(
        acc.window_s, *(a + b for a, b in zip(acc[1:], delta[1:]))
    )


def attach_observations(
    summary: RolloutSummary, obs_acc: torch.Tensor
) -> RolloutSummary:
    """Attach the final (S, 2, W, 4) observation accumulator's channels
    as the summary's per-version window series."""
    return summary._replace(
        ver_arrivals=obs_acc[:, :, :, 0],
        ver_errors=obs_acc[:, :, :, 1],
        ver_latency_s=obs_acc[:, :, :, 2],
    )


# -- host-side reporting ---------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def to_doc(
    compiled, roll: RolloutSummary, tables: RolloutTables
) -> dict:
    """The ``rollout.json`` artifact (``isotope-rollout/v1``): per-
    service weight/step trajectories, per-arm observed error shares,
    and sim-time ONSETS for every promote / hold / rollback — the
    closed-loop evidence a progressive-delivery run produces."""
    names = compiled.services.names
    dt = float(roll.window_s)
    done = _np(roll.windows_done) > 0
    k = int(done.sum())
    weight = _np(roll.weight)
    step = _np(roll.step)
    phase = _np(roll.phase)
    promo = _np(roll.promotions)
    holds = _np(roll.holds)
    rb = _np(roll.rollbacks)
    arr = _np(roll.ver_arrivals)
    errs = _np(roll.ver_errors)

    def onsets(mask_row) -> List[float]:
        idx = np.nonzero(mask_row & done)[0]
        return [round(float(i) * dt, 6) for i in idx]

    services: Dict[str, dict] = {}
    for s, name in enumerate(names):
        if not tables.has_rollout[s]:
            continue
        cb, cc = arr[s, 0], arr[s, 1]
        eb, ec = errs[s, 0], errs[s, 1]
        share_c = np.where(cc > 0, ec / np.maximum(cc, 1.0), 0.0)
        share_b = np.where(cb > 0, eb / np.maximum(cb, 1.0), 0.0)
        final_phase = int(phase[s][done][-1]) if k else 0
        promote_t = onsets(promo[s] > 0)
        rollback_t = onsets(rb[s] > 0)
        services[name] = {
            "steps": [
                round(float(v), 6)
                for v in tables.steps[s][: int(tables.num_steps[s])]
            ],
            "weight": [round(float(v), 6) for v in weight[s][:k]],
            "step": [int(v) for v in step[s][:k]],
            "state": PHASE_NAMES.get(final_phase, str(final_phase)),
            "final_weight": (
                round(float(weight[s][done][-1]), 6) if k else 0.0
            ),
            "promotions": float(promo[s][done].sum()),
            "holds": float(holds[s][done].sum()),
            "rollbacks": float(rb[s][done].sum()),
            "promote_onsets_s": promote_t,
            "first_hold_onset_s": (
                onsets(holds[s] > 0)[0]
                if (holds[s][done] > 0).any()
                else None
            ),
            "rollback_onsets_s": rollback_t,
            "canary_samples": float(cc[:k].sum()),
            "canary_error_share": [
                round(float(v), 6) for v in share_c[:k]
            ],
            "baseline_error_share": [
                round(float(v), 6) for v in share_b[:k]
            ],
        }
    return {
        "schema": "isotope-rollout/v1",
        "window_s": dt,
        "num_windows": int(roll.num_windows),
        "windows_done": k,
        "services": services,
    }


def format_table(doc: dict) -> str:
    """Human-readable rollout trajectory table (CLI stderr rendering)."""
    from isotope_tpu_torch.metrics.timeline import sparkline

    lines = [
        f"rollouts: {doc['windows_done']}/{doc['num_windows']} windows "
        f"x {doc['window_s']:g}s"
    ]
    for name, svc in doc.get("services", {}).items():
        bits = [
            f"{name:<20} weight {sparkline(svc['weight'])} "
            f"-> {svc['final_weight']:.0%} [{svc['state']}]"
        ]
        if svc["promotions"]:
            first = svc["promote_onsets_s"][0]
            bits.append(
                f"promotes {svc['promotions']:.0f} (first @{first:g}s)"
            )
        if svc["holds"]:
            bits.append(f"holds {svc['holds']:.0f}")
        if svc["rollbacks"]:
            t = svc["rollback_onsets_s"][0]
            bits.append(
                f"rollbacks {svc['rollbacks']:.0f} @{t:g}s"
            )
        lines.append("  ".join(bits))
    return "\n".join(lines)
