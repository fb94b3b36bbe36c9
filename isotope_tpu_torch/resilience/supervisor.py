"""The run supervisor: bounded retry, backoff, and the OOM ladder.

The port of ``isotope_tpu.resilience.supervisor``.  Two primitives,
composed by the sweep driver (runner/run.py):

- :func:`call_with_retries` retries TRANSIENT failures with exponential
  backoff and *deterministic* jitter (hash of site + attempt — two
  resumed sweeps desynchronize their retry storms identically, and
  tests reproduce exact schedules; the values are the reference's);
- :func:`run_ladder` walks an ordered list of execution rungs, moving
  down one rung per RESOURCE_EXHAUSTED failure.  :func:`execution_rungs`
  builds the ladder of one case: ``scan`` (the memory-sized block),
  then ``half-block`` (half the block: the same requests in twice the
  blocks, half the live event tensors).  Every rung runs on the
  Simulator's own device: no rung moves a case to the CPU.  The
  reference's last rung, ``cpu-eager`` (``jax.disable_jit`` on the same
  device, which also survives a compile-time OOM), has no counterpart:
  the port compiles nothing, so it would be the half-block rung again.

  Every descent increments ``degradations_total`` (Prometheus:
  ``isotope_engine_degradations_total``); the rung that finally served
  the run is recorded as ``degraded_to`` in telemetry metadata and run
  records.  DETERMINISTIC failures propagate immediately — the caller
  records the case as failed and the sweep continues.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.resilience.taxonomy import (
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    classify,
)

ENV_MAX_RETRIES = "ISOTOPE_MAX_RETRIES"
ENV_NO_DEGRADE = "ISOTOPE_NO_DEGRADE"


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs of the supervisor (CLI ``--max-retries`` / ``--no-degrade``,
    env ``ISOTOPE_MAX_RETRIES`` / ``ISOTOPE_NO_DEGRADE``)."""

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    degrade: bool = True
    # injectable clock for tests (sleep=lambda s: None)
    sleep: Callable[[float], None] = time.sleep

    @classmethod
    def from_env(
        cls,
        max_retries: Optional[int] = None,
        degrade: Optional[bool] = None,
    ) -> "ResiliencePolicy":
        if max_retries is None:
            max_retries = int(os.environ.get(ENV_MAX_RETRIES, "3"))
        if degrade is None:
            degrade = os.environ.get(ENV_NO_DEGRADE, "").strip().lower() \
                not in ("1", "true", "yes", "on")
        return cls(max_retries=max_retries, degrade=degrade)


def backoff_seconds(site: str, attempt: int,
                    policy: ResiliencePolicy) -> float:
    """Exponential backoff with deterministic jitter in [0.5x, 1.0x].

    The jitter fraction is a hash of (site, attempt): reproducible
    run-to-run, yet decorrelated across sites so N phases retrying the
    same hiccup don't stampede in lockstep.
    """
    base = min(
        policy.backoff_base_s * (2.0 ** attempt), policy.backoff_cap_s
    )
    h = hashlib.sha256(f"{site}:{attempt}".encode()).digest()
    frac = int.from_bytes(h[:4], "big") / 2**32  # [0, 1)
    return base * (0.5 + 0.5 * frac)


def call_with_retries(fn: Callable[[], object], site: str,
                      policy: ResiliencePolicy):
    """Run ``fn``, retrying TRANSIENT failures up to ``max_retries``.

    RESOURCE_EXHAUSTED and DETERMINISTIC failures propagate to the
    caller (the ladder / the sweep driver decide what happens next).
    """
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            if classify(e) != TRANSIENT or attempt >= policy.max_retries:
                raise
            delay = backoff_seconds(site, attempt, policy)
            telemetry.counter_inc("retries_total")
            telemetry.counter_inc(f"retries.{site}")
            telemetry.phase_add("resilience.backoff", delay)
            policy.sleep(delay)
            attempt += 1


def run_ladder(
    rungs: Sequence[Tuple[str, Callable[[], object]]],
    policy: ResiliencePolicy,
    site_prefix: str = "run",
) -> Tuple[object, Optional[str]]:
    """Execute the first rung that survives, degrading on OOM.

    ``rungs`` is an ordered ``(name, thunk)`` list; rung 0 is the
    undegraded path.  Each rung gets its own transient-retry budget.
    Returns ``(result, degraded_to)`` with ``degraded_to=None`` when
    rung 0 served the run.  With ``policy.degrade`` off (or rungs
    exhausted) the RESOURCE_EXHAUSTED failure propagates.
    """
    last = len(rungs) - 1
    for level, (name, thunk) in enumerate(rungs):
        try:
            out = call_with_retries(
                thunk, site=f"{site_prefix}.{name}", policy=policy
            )
        except Exception as e:
            if (
                classify(e) == RESOURCE_EXHAUSTED
                and policy.degrade
                and level < last
            ):
                telemetry.counter_inc("degradations_total")
                telemetry.gauge_set("engine_degraded_level", level + 1)
                continue
            raise
        if level > 0:
            telemetry.set_meta("degraded_to", name)
        return out, (name if level > 0 else None)
    raise AssertionError("run_ladder: empty rung list")  # pragma: no cover


def finish(summary, label: str = "run"):
    """Wait for a run's summary and hold it to the numeric sentinels,
    so deferred device errors AND poisoned outputs surface inside the
    supervised scope (a CUDA error otherwise escapes to the caller
    after the ladder already returned)."""
    from isotope_tpu_torch.resilience import sentinels

    if summary.count.device.type == "cuda":
        torch.cuda.synchronize(summary.count.device)
    sentinels.check_summary(summary, label)
    return summary


def rung_blocks(block_size: int) -> List[Tuple[str, int]]:
    """``(name, block)`` of each rung of the ladder, in order: ``scan``
    at ``block_size``, then ``half-block`` at half of it (256 at least).
    Every ladder and every replay of the rung that served a case reads
    its blocking here."""
    return [("scan", block_size), ("half-block", max(256, block_size // 2))]


def execution_rungs(
    sim,
    load,
    num_requests: int,
    source,
    block_size: int,
    collector=None,
    trim: bool = True,
    attribution: Optional[str] = None,
) -> List[Tuple[str, Callable[[], object]]]:
    """The degradation ladder of one sweep case, on ``sim``'s device.

    Each thunk returns ``(summary, attribution summary or None)``,
    blocks on the result and runs the numeric sentinels.
    ``attribution`` (``"on"`` / ``"tail"``) makes every rung the
    attributed run (:meth:`Simulator.run_attributed`: the same draws and
    blocking as the plain run, so the same summary): the blame pass
    rides the rung that serves the case.
    """
    def _scan(block):
        def thunk():
            if attribution is None:
                out = sim.run_summary(load, num_requests, source,
                                      block_size=block,
                                      collector=collector, trim=trim)
                return finish(out), None
            summary, attr = sim.run_attributed(
                load, num_requests, source, block_size=block,
                collector=collector, trim=trim,
                tail=attribution == "tail",
            )
            return finish(summary), attr
        return thunk

    return [(name, _scan(block)) for name, block in rung_blocks(block_size)]
