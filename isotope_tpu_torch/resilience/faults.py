"""Per-member chaos schedules of the chaos fleets (``sim/ensemble.py``).

The chaos-jitter part of ``isotope_tpu.resilience.faults``, copied on the
host (numpy only) so the port imports nothing of the JAX package:
:class:`ChaosJitterSpec`, :func:`parse_chaos_jitter`,
:func:`member_event_seeds` and :func:`jitter_chaos_events` give every
fleet member its own bad day, bit for bit the reference's schedules.
The engine fault-injection sites of that module (``check``,
``nan_segment``, ``stuck_breaker``, ...) are ROADMAP item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


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
