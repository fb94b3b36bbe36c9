"""M/M/k queueing model for service stations, in torch.

The port of ``isotope_tpu.sim.queueing``: each service is an M/M/k
station (k = NumReplicas servers, per-server rate mu = 1 / cpu_time,
offered load lambda = root RPS x expected visits), whose waiting time
is exactly

    P(W > t) = C(k, a) * exp(-(k*mu - lambda) * t)

with ``C`` the Erlang-C delay probability and a = lambda/mu.  Sampling
a wait is one uniform: a coin against C(k, a) and, below it, the
conditional exponential.  All arithmetic is float32 in the reference's
op order, so the tables agree with the JAX package to a few ULP.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Stations at/over capacity have no stationary distribution; we pin them
# just under saturation so the sim stays finite and flag them instead.
_MAX_RHO = 0.9999


def erlang_b(a: torch.Tensor, k_max: int) -> torch.Tensor:
    """Erlang-B blocking probability B(j, a) for j = 1..k_max.

    Uses the stable recursion B(j) = a*B(j-1) / (j + a*B(j-1)), B(0) = 1.
    Returns shape (k_max, *a.shape); row j-1 holds B(j, a).
    """
    a = a.to(torch.float32)
    b = torch.ones_like(a)
    rows = []
    for j in range(1, k_max + 1):
        b = a * b / (float(j) + a * b)
        rows.append(b)
    return torch.stack(rows)


class QueueParams(NamedTuple):
    """Per-station sampling parameters (all shaped like ``replicas``)."""

    p_wait: torch.Tensor       # Erlang-C delay probability C(k, a)
    wait_rate: torch.Tensor    # k*mu - lambda: rate of the conditional wait
    utilization: torch.Tensor  # rho = lambda / (k*mu)
    unstable: torch.Tensor     # bool: offered load >= capacity


def mmk_params(
    arrival_rate: torch.Tensor,
    service_rate,
    replicas: torch.Tensor,
    k_max: int,
) -> QueueParams:
    """Erlang-C sampling parameters for each station.

    ``arrival_rate``: lambda per station (float32); ``service_rate``: mu
    per server (a float, or an (S,) tensor: the canary arms' own rates);
    ``replicas``: integer k per station; ``k_max``: the static max k
    (sets the recursion length).
    """
    lam = arrival_rate.to(torch.float32)
    if isinstance(service_rate, torch.Tensor):
        mu = service_rate.to(torch.float32)
    else:
        mu = torch.tensor(service_rate, dtype=torch.float32,
                          device=lam.device)
    k = replicas.to(torch.int64)
    kf = k.to(torch.float32)

    rho_raw = lam / (kf * mu)
    unstable = rho_raw >= 1.0
    rho = torch.clamp(rho_raw, max=_MAX_RHO)
    a = rho * kf  # effective (possibly clamped) offered load in erlangs

    b_rows = erlang_b(a, k_max)                       # (k_max, *S)
    b_k = torch.gather(b_rows, 0, (k - 1)[None, ...])[0]
    p_wait = b_k / (1.0 - rho * (1.0 - b_k))
    wait_rate = kf * mu * (1.0 - rho)
    return QueueParams(
        p_wait=p_wait,
        wait_rate=wait_rate,
        utilization=rho_raw,
        unstable=unstable,
    )


def sample_wait_conditional(
    p_wait: torch.Tensor,
    wait_rate: torch.Tensor,
    uniform: torch.Tensor,
) -> torch.Tensor:
    """Single-tensor wait draw via the conditional-uniform trick.

    Given U ~ U[0,1), conditional on U < p the ratio U/p is again U[0,1),
    so one uniform yields both the Erlang-C delay coin and the
    conditional Exp(wait_rate) wait.
    """
    ratio = uniform / torch.clamp(p_wait, min=1e-30)
    # the floor stays in the f32 normal range, so u == 0 cannot give inf
    return torch.where(
        uniform < p_wait,
        -torch.log(torch.clamp(ratio, min=1e-20)) / wait_rate,
        torch.zeros((), dtype=uniform.dtype, device=uniform.device),
    )
