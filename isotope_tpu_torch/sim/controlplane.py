"""Control-plane config-push convergence model (pilot load test).

The port of ``isotope_tpu.sim.controlplane``.  The reference's pilot
scale test (perf/load/pilot/load_test.py) creates N ServiceEntries x M
endpoints and measures how long until every Envoy's cluster count
reflects them (:33-44 polls config dumps) — convergence time as a
function of config size and fleet size.

The simulation model is the xDS push pipeline as a queueing system:

- a debounce window, then pilot generates the pushed config (cost grows
  with N x M — endpoints dominate memory/CPU);
- pushes fan out to P proxies through a bounded concurrent-push budget
  (istiod's PILOT_PUSH_THROTTLE), each push taking a sampled
  transfer+ACK latency that also grows with config size;
- a proxy has converged when its push ACKs.  Convergence quantiles are
  read off the completion times.

The reference assigns pushes with a ``lax.scan`` over the push queue (the
greedy earliest-free-channel assignment); here it is a host loop over
the proxies in float32, the reference's precision, with a heap keyed by
(free time, channel), which takes the lowest channel among equally free
ones as ``argmin`` does.  The lognormal jitter's normals come from a
seeded ``torch.Generator`` (:func:`push_normals`), or are passed in.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PilotModel:
    """Pilot/istiod push-pipeline parameters."""

    debounce_s: float = 0.1            # PILOT_DEBOUNCE_AFTER
    push_throttle: int = 100           # concurrent pushes
    gen_s_per_endpoint: float = 2e-6   # config generation CPU
    push_base_s: float = 5e-3          # per-push floor (RTT + ACK)
    push_s_per_endpoint: float = 1e-6  # transfer cost per endpoint
    push_jitter: float = 0.3           # lognormal sigma on push latency

    def __post_init__(self):
        if self.push_throttle <= 0:
            raise ValueError("push_throttle must be positive")


@dataclasses.dataclass(frozen=True)
class ConvergenceResult:
    ack_times_s: np.ndarray  # (P,) per-proxy convergence times

    def quantile_s(self, q) -> np.ndarray:
        return np.quantile(self.ack_times_s, q)

    @property
    def max_s(self) -> float:
        return float(self.ack_times_s.max())

    def converged_fraction(self, t: float) -> float:
        return float((self.ack_times_s <= t).mean())

    def window_series(self, window_s: float, num_windows: int) -> dict:
        """Project the per-proxy ACK times onto a data-plane timeline's
        window axis (``metrics/timeline.py``): per-window ACK counts and
        the cumulative converged fraction at each window end."""
        from isotope_tpu_torch.metrics.timeline import controlplane_windows

        return controlplane_windows(self.ack_times_s, window_s, num_windows)


def push_normals(num_proxies: int, seed: int = 0, device="cpu"
                 ) -> torch.Tensor:
    """The (P,) unit normals of one push's lognormal jitter, from a
    ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn((num_proxies,), generator=g, device=device,
                       dtype=torch.float32)


def push_convergence(
    model: PilotModel,
    num_entries: int,
    endpoints_per_entry: int,
    num_proxies: int,
    *,
    seed: int = 0,
    z: Optional[torch.Tensor] = None,
    device="cpu",
) -> ConvergenceResult:
    """Convergence times for one config push to ``num_proxies`` Envoys;
    ``z``: the jitter's (P,) unit normals (default
    :func:`push_normals` of ``seed``)."""
    if num_proxies <= 0:
        raise ValueError("num_proxies must be positive")
    endpoints = num_entries * endpoints_per_entry
    ready = model.debounce_s + endpoints * model.gen_s_per_endpoint
    mean_push = model.push_base_s + endpoints * model.push_s_per_endpoint

    if z is None:
        z = push_normals(num_proxies, seed, device)
    sigma = model.push_jitter
    # lognormal with the configured mean, in float32
    durations = (
        mean_push * torch.exp(sigma * z - 0.5 * sigma * sigma)
    ).cpu().numpy().astype(np.float32)

    c = min(model.push_throttle, num_proxies)
    ready32 = np.float32(ready)
    free = [(ready32, i) for i in range(c)]  # already a heap
    acks = np.empty(num_proxies, np.float32)
    for p, dur in enumerate(durations):
        # greedy: the next push takes the earliest-free channel
        t_free, ch = heapq.heappop(free)
        end = np.float32(max(t_free, ready32) + dur)
        heapq.heappush(free, (end, ch))
        acks[p] = end
    return ConvergenceResult(ack_times_s=acks.astype(np.float64))


def convergence_sweep(
    model: PilotModel,
    entry_counts,
    endpoints_per_entry: int,
    num_proxies: int,
    seed: int = 0,
    device="cpu",
):
    """The reference test's measurement: convergence vs ServiceEntry
    count (load_test.py's N axis).  Entry count ``i`` draws its jitter
    from seed ``(seed, i)``.  Returns rows of p50/p99/max."""
    rows = []
    for i, n in enumerate(entry_counts):
        seed_i = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        res = push_convergence(
            model, n, endpoints_per_entry, num_proxies, seed=seed_i,
            device=device,
        )
        p50, p99 = res.quantile_s([0.5, 0.99])
        rows.append(
            {
                "num_entries": int(n),
                "endpoints": int(n * endpoints_per_entry),
                "proxies": int(num_proxies),
                "p50_s": float(p50),
                "p99_s": float(p99),
                "max_s": res.max_s,
            }
        )
    return rows
