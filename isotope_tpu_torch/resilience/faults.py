"""Deterministic engine-level fault injection, and the fleets' chaos jitter.

The port of ``isotope_tpu.resilience.faults``.  Every recovery path of
the run supervisor (retry, the degradation ladder, the numeric
sentinels) must be exercisable on the CPU in tests, not only on a card
that happens to run out of memory.

Spec syntax (``$ISOTOPE_FAULT_INJECT`` or :func:`install`)::

    ISOTOPE_FAULT_INJECT=oom:engine.run:1,nan:segment:2

comma-separated ``kind:site[:arg]`` entries:

- ``oom:<site>[:count]`` — raise a ``RESOURCE_EXHAUSTED``-shaped fault
  the first ``count`` times ``check(site)`` runs (default 1);
- ``transient:<site>[:count]`` — same, ``UNAVAILABLE``-shaped;
- ``corrupt:<site>[:count]`` — same, shaped like a corrupted cache
  entry (deterministic);
- ``nan:segment:<index>`` — poison the output of segment ``<index>`` of
  the upward sweep with NaN (``arg`` is the segment index, not a count;
  the port sweeps every level on its own, so segment ``i`` is level
  ``i``); exercises the numeric sentinels and detail-mode localization;
- ``stuck:policies.stuck_breaker`` — a tripped circuit breaker never
  closes (``policies.advance(stuck_breaker=)``);
- ``lag:policies.autoscaler_lag[:N]`` — the autoscaler misses its first
  ``N`` sync periods (``policies.init_state(lag_periods=)``);
- ``degrade:lb.degraded_backend[:B]`` — backend ``B``'s (default 0)
  attraction weight collapses to ``DEGRADED_FACTOR``
  (``lb.effective_profile(degraded=)``).

The wired sites are the engine's: ``engine.build`` (``Simulator``
construction) and ``engine.run`` (the entry of every run:
``run``, ``run_summary``, ``run_attributed``, ``run_timeline``,
``run_policies``, ``run_rollouts``, ``run_ensemble`` and the protected
fleets), the sharded runner's (``parallel/sharded.py``, where the
reference checks them: ``sharded.args_put`` while a run's argument
tables are built, ``sharded.compute`` before the shards' scan,
``sharded.dcn_collective`` before it on a mesh with a ``slice`` axis,
``sharded.gather`` after the merge), and the policy and lb layers'
sites: the standard kinds at
``policies.stuck_breaker`` / ``policies.autoscaler_lag`` raise at the
entry of a protected run or fleet with policy tables, at
``lb.degraded_backend`` at the entry of a run with active lb laws.
The reference's XLA cache site parses as in the reference and then
raises ``NotImplementedError`` (the port has no compiled-executable
cache), so a plan never silently fails to fire.  ``check(site)`` with no plan armed
is one boolean test: the default path gains no work and no sync point.

The second half is the chaos jitter of the fleets (numpy only):
:class:`ChaosJitterSpec`, :func:`parse_chaos_jitter`,
:func:`member_event_seeds` and :func:`jitter_chaos_events` give every
fleet member its own bad day, bit for bit the reference's schedules.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.resilience.taxonomy import (
    DETERMINISTIC,
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    InjectedFault,
)

ENV_FAULT_INJECT = "ISOTOPE_FAULT_INJECT"

KINDS = ("oom", "transient", "corrupt", "nan", "stuck", "lag",
         "degrade")

#: the reference's instrumented ``check(site)`` sites — the closed
#: universe a spec may target: a typo'd site raises at parse time with
#: this list instead of silently never firing.  ``nan`` targets the
#: pseudo-site ``segment``.
VALID_SITES = (
    "engine.build",
    "engine.run",
    "sharded.args_put",
    "sharded.compute",
    "sharded.dcn_collective",
    "sharded.gather",
    "cache.load",
    "policies.stuck_breaker",
    "policies.autoscaler_lag",
    "lb.degraded_backend",
)

#: the reference's sites whose layer the port has not wired yet, and
#: the ROADMAP item that wires them
_UNWIRED = {
    "cache.load": "none: the port has no compiled-executable cache",
}


def _refuse_unwired(kind: str, site: str) -> None:
    item = _UNWIRED.get(site)
    if item is not None:
        raise NotImplementedError(
            f"fault {kind}:{site} is not wired in isotope_tpu_torch "
            f"(ROADMAP.md: {item})"
        )


#: fault kind -> (message template, taxonomy class).  Messages imitate
#: the real failure text so the taxonomy classifies injected faults by
#: the same patterns as real ones (the explicit class is a backstop).
_SHAPES = {
    "oom": (
        "RESOURCE_EXHAUSTED: out of memory while running {site} "
        "(injected fault)",
        RESOURCE_EXHAUSTED,
    ),
    "transient": (
        "UNAVAILABLE: injected transient fault at {site}",
        TRANSIENT,
    ),
    "corrupt": (
        "corrupted persistent-cache entry at {site}: digest mismatch "
        "(injected fault, unpickling failed)",
        DETERMINISTIC,
    ),
}


@dataclasses.dataclass
class _Entry:
    kind: str
    site: str
    arg: int          # fire count (oom/transient/corrupt) or segment (nan)
    remaining: int


class FaultPlan:
    """A parsed, mutable injection plan (per-entry fire budgets)."""

    def __init__(self, entries: List[_Entry]):
        self.entries = entries
        self._by_site: Dict[str, List[_Entry]] = {}
        for e in entries:
            if e.kind not in ("nan", "stuck", "lag", "degrade"):
                self._by_site.setdefault(e.site, []).append(e)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries: List[_Entry] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) not in (2, 3):
                raise ValueError(
                    f"bad fault spec {part!r} (want kind:site[:arg])"
                )
            kind, site = bits[0].strip(), bits[1].strip()
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {KINDS})"
                )
            arg = int(bits[2]) if len(bits) == 3 else (
                0 if kind in ("nan", "degrade") else 1
            )
            if kind == "nan" and site != "segment":
                raise ValueError(
                    f"nan faults target segments (nan:segment:<idx>), "
                    f"got site {site!r}"
                )
            if kind == "stuck" and site != "policies.stuck_breaker":
                raise ValueError(
                    "stuck faults target the breaker "
                    "(stuck:policies.stuck_breaker), got site "
                    f"{site!r}"
                )
            if kind == "lag" and site != "policies.autoscaler_lag":
                raise ValueError(
                    "lag faults target the autoscaler "
                    "(lag:policies.autoscaler_lag[:N]), got site "
                    f"{site!r}"
                )
            if kind == "degrade" and site != "lb.degraded_backend":
                raise ValueError(
                    "degrade faults target the lb layer "
                    "(degrade:lb.degraded_backend[:B]), got site "
                    f"{site!r}"
                )
            if kind != "nan" and site not in VALID_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} — the plan would "
                    f"never fire (valid sites: "
                    f"{', '.join(VALID_SITES)})"
                )
            _refuse_unwired(kind, site)
            behavioral = kind in ("nan", "stuck", "lag", "degrade")
            entries.append(
                _Entry(kind=kind, site=site, arg=arg,
                       remaining=0 if behavioral else arg)
            )
        return cls(entries)

    def pop(self, site: str) -> Optional[_Entry]:
        """The first live entry at ``site``, its budget decremented."""
        for e in self._by_site.get(site, ()):
            if e.remaining > 0:
                e.remaining -= 1
                return e
        return None

    def nan_segment(self) -> Optional[int]:
        for e in self.entries:
            if e.kind == "nan":
                return e.arg
        return None

    def stuck_breaker(self) -> bool:
        return any(e.kind == "stuck" for e in self.entries)

    def autoscaler_lag(self) -> int:
        for e in self.entries:
            if e.kind == "lag":
                return max(e.arg, 1)
        return 0

    #: the collapse factor of a degraded backend's attraction weight —
    #: small but nonzero: the pod still advertises (gray failure), it
    #: just draws ~no traffic
    DEGRADED_FACTOR = 0.01

    def lb_degraded_backend(self):
        for e in self.entries:
            if e.kind == "degrade":
                return (max(e.arg, 0), self.DEGRADED_FACTOR)
        return None

    def signature(self) -> str:
        """Stable identity of the part of the plan that changes what a
        run computes (the NaN poisoning and the behavioral kinds;
        host-side faults only raise)."""
        parts = []
        seg = self.nan_segment()
        if seg is not None:
            parts.append(f"nan:segment:{seg}")
        if self.stuck_breaker():
            parts.append("stuck:policies.stuck_breaker")
        lag = self.autoscaler_lag()
        if lag:
            parts.append(f"lag:policies.autoscaler_lag:{lag}")
        deg = self.lb_degraded_backend()
        if deg is not None:
            parts.append(f"degrade:lb.degraded_backend:{deg[0]}")
        return ",".join(parts)


_plan: Optional[FaultPlan] = None
_env_loaded = False


def _load_env() -> None:
    global _plan, _env_loaded
    _env_loaded = True
    spec = os.environ.get(ENV_FAULT_INJECT)
    if spec:
        _plan = FaultPlan.parse(spec)
        telemetry.counter_inc("fault_plan_armed", 0.0)  # visibility key


def install(spec: str) -> FaultPlan:
    """Arm a plan programmatically (tests); replaces any existing one."""
    global _plan, _env_loaded
    _plan = FaultPlan.parse(spec)
    _env_loaded = True
    return _plan


def clear() -> None:
    """Disarm injection (and stop re-reading the environment)."""
    global _plan, _env_loaded
    _plan = None
    _env_loaded = True


def active() -> bool:
    if not _env_loaded:
        _load_env()
    return _plan is not None


def check(site: str) -> None:
    """Raise the planned fault for ``site``, if any budget remains.

    Called unconditionally from the instrumented phases; with no plan
    armed this is one boolean test.
    """
    if not _env_loaded:
        _load_env()
    if _plan is None:
        return
    entry = _plan.pop(site)
    if entry is None:
        return
    telemetry.counter_inc("faults_injected")
    telemetry.counter_inc(f"faults_injected.{entry.kind}")
    msg, fault_class = _SHAPES[entry.kind]
    raise InjectedFault(msg.format(site=site), fault_class)


def nan_segment() -> Optional[int]:
    """The segment index of the upward sweep to poison with NaN, or
    None (read by ``Simulator._simulate_core``)."""
    if not _env_loaded:
        _load_env()
    return None if _plan is None else _plan.nan_segment()


def stuck_breaker() -> bool:
    """Behavioral policy chaos: tripped breakers never close (read by
    the protected block loop, ``sim/policies.advance``)."""
    if not _env_loaded:
        _load_env()
    return False if _plan is None else _plan.stuck_breaker()


def autoscaler_lag() -> int:
    """Behavioral policy chaos: sync periods the autoscaler misses at
    startup (0 = off; read by ``sim/policies.init_state``)."""
    if not _env_loaded:
        _load_env()
    return 0 if _plan is None else _plan.autoscaler_lag()


def lb_degraded_backend():
    """Behavioral lb chaos: ``(backend, factor)`` collapsing that
    backend's attraction weight, or None (read when a Simulator builds
    its lb tables, ``sim/lb.effective_profile``)."""
    if not _env_loaded:
        _load_env()
    return None if _plan is None else _plan.lb_degraded_backend()


def signature() -> str:
    """The plan's identity as far as it changes what a run computes."""
    if not _env_loaded:
        _load_env()
    return "" if _plan is None else _plan.signature()


# -- per-member chaos schedules (chaos fleets, sim/ensemble.py) ---------------
#
# The workload chaos schedule (sim/config.ChaosEvent) is one fixed bad
# day; a Monte Carlo fleet wants every member to survive a DIFFERENT
# bad day.  ChaosJitterSpec perturbs each event's kill timing, target,
# and magnitude per member — deterministically from per-event seeds
# derived by the fold_in discipline — while preserving the schedule's
# phase-cut STRUCTURE (same number of distinct cuts, same order), so
# every member's phase tables stay shape-aligned (compiler/compile.py
# ``compile_chaos_members`` stacks them).


@dataclasses.dataclass(frozen=True)
class ChaosJitterSpec:
    """Per-member chaos-schedule perturbations.

    - ``time``: log-space sigma of a mean-preserving lognormal factor
      on each distinct event boundary (kill start / recovery time);
      jittered boundaries are re-ranked to the solo order, so the cut
      count and ordering — the traced program's shape — never change;
    - ``magnitude``: log-space sigma on each event's ``replicas_down``
      (rounded, clamped to ``[1, replicas(target)]``);
    - ``target``: probability an event re-targets a service drawn
      uniformly from ``pool`` (default: the set of services the solo
      schedule already targets);
    - ``seed``: the jitter stream root; member ``m``'s event ``e``
      draws from ``SeedSequence([seed, member_event_seed])`` so the
      same spec reproduces bit-identical schedules on every host, and
      the splitting estimator can resample events independently.

    ``time == magnitude == target == 0`` is the identity: every
    member keeps the solo schedule (pinned byte-identical).
    """

    time: float = 0.0
    magnitude: float = 0.0
    target: float = 0.0
    pool: tuple = ()
    seed: int = 0

    def __post_init__(self):
        for name in ("time", "magnitude"):
            if getattr(self, name) < 0:
                raise ValueError(f"chaos jitter {name} must be >= 0")
        if not 0.0 <= self.target <= 1.0:
            raise ValueError("chaos jitter target must lie in [0, 1]")
        object.__setattr__(self, "pool", tuple(self.pool))

    @property
    def identity(self) -> bool:
        return (
            self.time == 0.0
            and self.magnitude == 0.0
            and self.target == 0.0
        )

    def to_dict(self) -> dict:
        return {
            "time": self.time, "magnitude": self.magnitude,
            "target": self.target, "pool": list(self.pool),
            "seed": self.seed,
        }


def parse_chaos_jitter(text: Optional[str]):
    """Parse ``"time=0.2,magnitude=0.5,target=0.3,seed=7"`` into a
    :class:`ChaosJitterSpec` (None for empty/``off``)."""
    if not text or str(text).strip().lower() in ("off", "0", "false"):
        return None
    kw: Dict[str, object] = {}
    keys = {"time": float, "magnitude": float, "mag": float,
            "target": float, "seed": int}
    names = {"mag": "magnitude"}
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad chaos jitter entry {part!r} (expected "
                f"key=value; keys: {', '.join(sorted(keys))})"
            )
        k, v = part.split("=", 1)
        k = k.strip().lower()
        if k not in keys:
            raise ValueError(
                f"unknown chaos jitter key {k!r} (expected one of "
                f"{', '.join(sorted(keys))})"
            )
        kw[names.get(k, k)] = keys[k](v.strip())
    return ChaosJitterSpec(**kw)


def member_event_seeds(spec: ChaosJitterSpec, member_seed: int,
                       num_events: int):
    """The (E,) per-event jitter seeds of one fleet member — the
    components the splitting estimator's proposal kernel resamples
    independently (the splitting estimator, ROADMAP item 9)."""
    import numpy as np

    rng = np.random.default_rng(
        np.random.SeedSequence([int(spec.seed), int(member_seed) &
                                0x7FFFFFFF])
    )
    return rng.integers(1, 2**31 - 1, size=max(num_events, 1),
                        dtype=np.int64)


def jitter_chaos_events(chaos, spec: ChaosJitterSpec, event_seeds,
                        replicas_by_name):
    """One member's jittered schedule: same event count, same distinct
    cut count, same cut ORDER as the solo schedule (the shape-aligned
    contract the stacked fleet tables need).

    Ties are preserved: boundaries sharing one solo value share one
    jitter draw (first event wins), so coinciding cuts never split
    into extra phases.  Re-ranking (sort the jittered values, assign
    by solo rank) keeps ``start < end`` per event and the global
    ordering intact even when draws cross."""
    import numpy as np

    chaos = tuple(chaos)
    if not chaos:
        return chaos
    seeds = np.asarray(event_seeds, np.int64)
    if seeds.shape != (len(chaos),):
        raise ValueError(
            f"event_seeds must have shape ({len(chaos)},); got "
            f"{seeds.shape}"
        )
    # distinct solo boundary values, in order (0 is never a boundary
    # here unless an event starts at 0 — it stays pinned at 0)
    values = sorted({float(ev.start_s) for ev in chaos}
                    | {float(ev.end_s) for ev in chaos})
    factor: Dict[float, float] = {}
    jittered = []
    for ev, s in zip(chaos, seeds):
        rng = np.random.default_rng(
            np.random.SeedSequence([int(spec.seed), int(s)])
        )
        # fixed draw layout regardless of arming: the axes' streams
        # stay independent of which jitters are on
        z_start, z_end, z_mag = rng.standard_normal(3)
        u_flip, u_pick = rng.random(2)
        for v, z in ((float(ev.start_s), z_start),
                     (float(ev.end_s), z_end)):
            if v not in factor:
                factor[v] = (
                    float(np.exp(spec.time * z
                                 - 0.5 * spec.time * spec.time))
                    if spec.time > 0 else 1.0
                )
        target = ev.service
        if spec.target > 0 and u_flip < spec.target:
            pool = spec.pool or tuple(sorted(
                {e.service for e in chaos}
            ))
            target = pool[min(int(u_pick * len(pool)), len(pool) - 1)]
        reps = int(replicas_by_name[target])
        down = ev.replicas_down
        if spec.magnitude > 0:
            base = reps if down is None else int(down)
            mag = float(np.exp(
                spec.magnitude * z_mag
                - 0.5 * spec.magnitude * spec.magnitude
            ))
            down = int(np.clip(round(base * mag), 1, reps))
        elif down is not None and target != ev.service:
            # a re-targeted kill keeps its size but never exceeds the
            # new pool; the identity spec leaves the event untouched
            down = min(int(down), reps)
        jittered.append((ev, target, down))
    # re-rank: jittered values sorted ascending map back to the solo
    # ranks, preserving order/count (a crossing draw swaps magnitudes,
    # not structure)
    jit_vals = np.sort([v * factor[v] for v in values])
    remap = {v: float(jv) for v, jv in zip(values, jit_vals)}
    out = []
    for ev, target, down in jittered:
        out.append(dataclasses.replace(
            ev, service=target,
            start_s=remap[float(ev.start_s)],
            end_s=remap[float(ev.end_s)],
            replicas_down=down,
        ))
    return tuple(out)
