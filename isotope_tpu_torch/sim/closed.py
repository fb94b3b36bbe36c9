"""Finite-population queueing model for the saturated closed loop.

Fortio's ``-qps max`` mode (the reference's default experiment:
``isotope/example-config.toml`` sets ``qps = "max"`` with 64
connections; built by perf/benchmark/runner/runner.py:255-268) keeps
exactly C requests in flight: each connection fires its next request the
moment the previous one returns.  The in-system population is therefore
hard-bounded at C, and the open-loop M/M/k stationary wait law — whose
conditional wait is an unbounded exponential with rate k*mu - lambda —
cannot represent the truncated sojourn distribution (engine p99 was +79%
vs the DES oracle before this model; ORACLE.md r3).

This module models the run as a **closed product-form network**:

- one FIFO station per service with load-dependent completion rate
  mu_s(j) = min(j, k_s) * mu  (k_s = NumReplicas, the M/M/k station);
- one delay (infinite-server) station — load-dependent rate j / Z —
  aggregating wire time and sleeps;
- population N = connections, visit ratios v_s = expected hops per
  root request.

Three pieces make the sampled latencies track the DES oracle:

1. **Exact load-dependent MVA** (Reiser-Lavenberg) yields the network
   throughput lambda(N) — Fortio's measured ``-qps max`` ActualQPS —
   and per-station queue-length marginals.  By the arrival theorem a
   request arriving at station s sees the stationary distribution with
   population N-1, so its wait is the mixture P(wait=0) = P(j < k_s),
   wait | j >= k_s ~ Erlang(j - k_s + 1, k_s * mu), which the engine
   samples via a per-station quantile polynomial in v = -log(1 - u)
   (Horner with per-hop coefficient rows: zero gathers).
2. **Fork-join cycle weights.**  MVA's cycle sums visits serially, but
   concurrent siblings overlap in time, so each member of an m-wide
   concurrent group contributes ~H_m/m of its response to the cycle
   (H_m the harmonic number: E[max of m iid Exp] = H_m * E[one]).  The
   weights scale only the cycle denominator — station utilizations
   keep the full visit ratios (every branch really executes).
3. **The population copula.**  Station queue lengths under a fixed
   population are negatively correlated (sum_s j_s + j_delay = N - 1
   exactly), so summing independently-sampled waits along a path
   overestimates the tail (+38% on chain3 p99).  The exact identity
   Var(sum_s j_s) = Var(j_delay) pins the average pairwise correlation
       rho = (Var_d - sum Var_s) / ((sum sigma_s)^2 - sum sigma_s^2)
   which the engine realizes as a mean-centering Gaussian copula over
   the active hops' wait draws.

For exponential service and FIFO stations the network is BCMP
product-form, so chains are modeled exactly up to the copula's
equicorrelation approximation; the measured envelope is gated in
tests/test_oracle.py.

A copy of ``isotope_tpu.sim.closed`` (numpy and scipy only): the
port's saturated closed loop builds its tables with it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
from scipy.special import gammainc

# shared wait-quantile polynomial degree (tables_from_pi and the
# engine's degenerate-row stubs must agree on the coefficient count)
DEFAULT_QUANTILE_DEGREE = 10


class ClosedTables(NamedTuple):
    """Per-population sampling tables (see ``closed_network_tables``)."""

    throughput: float     # lambda(N): the network's saturated QPS
    p_zero: np.ndarray    # (S,) P(wait == 0) seen at arrival
    coef: np.ndarray      # (D+1, S) wait-quantile polynomial in v
    mean_wait: np.ndarray  # (S,) E[wait] at arrival (diagnostics)
    sigma: np.ndarray     # (S,) std of the queue census at arrival
    var_delay: float      # Var(j_delay): the census-sum variance target


def convolution_marginals(
    visits: np.ndarray,
    replicas: np.ndarray,
    mu: float,
    delay_s: float,
    population: int,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Exact product-form solution via Buzen's convolution algorithm.

    Returns (lambda(N), pi, pi_delay) where ``pi[s, j]`` /
    ``pi_delay[j]`` are queue-length distributions under population
    N-1 — what an arriving customer sees (arrival theorem).

    Load-dependent exact MVA is numerically unstable for multi-server
    stations: its per-population marginals rely on ``P(0|n) = 1 - sum``
    cancellations that corrupt catastrophically once a station's tail
    mass approaches 1 (observed: a k=2 station's computed throughput
    DROPPED below k=1's).  The convolution form has no cancellation —
    every term is a nonneg product — and stays exact with a common rate
    scale ``beta`` plus per-step max-normalization (tracked in log
    space):

        f_s(j)   = prod_{i<=j} beta * v_s / mu_s(i)     (station)
        f_d(j)   = (beta * Z)^j / j!                     (delay)
        G        = f_1 (*) ... (*) f_S (*) f_d
        lambda(N)= beta * G(N-1) / G(N)
        P_s(j|n) = f_s(j) * G_{-s}(n - j) / G(n)

    with ``G_{-s}`` assembled from prefix/suffix convolutions —
    O(S * N^2) total, like MVA.
    """
    v = np.asarray(visits, np.float64)
    k = np.asarray(replicas, np.float64)
    S = len(v)
    N = int(population)
    if N < 1:
        raise ValueError("population must be >= 1")
    z = max(float(delay_s), 1e-12)
    active = np.nonzero(v > 1e-15)[0]
    # common rate scale keeps the f magnitudes near 1
    beta = max(float((k * mu).max(initial=1.0)), 1.0 / z)

    def norm(c: np.ndarray, lg: float) -> Tuple[np.ndarray, float]:
        m = float(c.max())
        if m <= 0.0:
            return c, lg
        return c / m, lg + np.log(m)

    def log_station_f(s: int) -> np.ndarray:
        j = np.arange(1, N + 1, dtype=np.float64)
        rate = np.minimum(j, k[s]) * mu
        lf = np.empty(N + 1)
        lf[0] = 0.0
        lf[1:] = np.cumsum(np.log(beta * v[s] / rate))
        return lf

    def log_delay_f() -> np.ndarray:
        j = np.arange(1, N + 1, dtype=np.float64)
        lf = np.empty(N + 1)
        lf[0] = 0.0
        lf[1:] = np.cumsum(np.log(beta * z / j))
        return lf

    def from_log(lf: np.ndarray) -> Tuple[np.ndarray, float]:
        # factors span hundreds of orders of magnitude (beta*v/mu per
        # step can exceed 1 by k_max/k_s): exponentiate only after
        # centering on the max so nothing overflows
        m = float(lf.max())
        return np.exp(lf - m), m

    def conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return np.convolve(a, b)[: N + 1]

    # normalized factors (common log offsets cancel in the ratios below)
    fs: list = []
    lgs: list = []
    for s in active:
        f, lg = from_log(log_station_f(int(s)))
        fs.append(f)
        lgs.append(lg)
    fd, lgd = from_log(log_delay_f())
    fs.append(fd)
    lgs.append(lgd)
    M = len(fs)

    # prefix[i] = f_0 (*) ... (*) f_{i-1}; suffix[i] = f_i (*) ... last
    one = np.zeros(N + 1)
    one[0] = 1.0
    prefix = [(one, 0.0)]
    for i in range(M):
        c, lg = norm(conv(prefix[-1][0], fs[i]), prefix[-1][1] + lgs[i])
        prefix.append((c, lg))
    suffix = [(one, 0.0)]
    for i in reversed(range(M)):
        c, lg = norm(conv(fs[i], suffix[0][0]), lgs[i] + suffix[0][1])
        suffix.insert(0, (c, lg))
    g, _ = prefix[-1]
    if g[N] <= 0.0 or g[N - 1] <= 0.0:  # pragma: no cover - degenerate
        raise FloatingPointError("convolution underflow")
    lam = beta * g[N - 1] / g[N]

    # arriving-customer marginals at population N-1
    pi = np.zeros((S, N))
    pi[:, 0] = 1.0
    pi_d = np.zeros(N)
    pi_d[0] = 1.0
    n1 = N - 1
    for idx in range(M):
        gm = conv(prefix[idx][0], suffix[idx + 1][0])
        f = fs[idx]
        raw = f[: n1 + 1] * gm[n1::-1] if n1 >= 0 else f[:1]
        tot = float(raw.sum())
        marg = np.zeros(N)
        if tot > 0.0 and n1 >= 0:
            marg[: n1 + 1] = raw / tot
        else:
            marg[0] = 1.0
        if idx < len(active):
            pi[active[idx]] = marg
        else:
            pi_d = marg
    return lam, pi, pi_d


def mva_load_dependent(
    visits: np.ndarray,
    cycle_visits: np.ndarray,
    replicas: np.ndarray,
    mu: float,
    delay_s: float,
    population: int,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Exact MVA; returns (lambda(N), pi, pi_delay).

    ``pi[s, j]`` / ``pi_delay[j]`` are queue-length distributions under
    population N-1 — what an arriving customer sees (arrival theorem).
    ``visits`` drives utilization (the pi recursion); ``cycle_visits``
    weights the cycle denominator (fork-join overlap, see module doc).
    O(S * N^2) in float64; stations with ``visits == 0`` fall out
    naturally (their pi stays a point mass at 0).

    .. warning:: numerically unstable for multi-server (k > 1)
       stations near saturation — the production path uses
       :func:`convolution_marginals`; this remains as a cross-check
       for k == 1 networks.
    """
    v = np.asarray(visits, np.float64)
    cv = np.asarray(cycle_visits, np.float64)
    k = np.asarray(replicas, np.float64)
    S = len(v)
    N = int(population)
    if N < 1:
        raise ValueError("population must be >= 1")
    z = max(float(delay_s), 1e-12)
    # completion rate with j customers present, j = 1..N: the delay
    # "station" (row S) is an infinite server with rate j / Z
    j = np.arange(1, N + 1, dtype=np.float64)
    rate = np.empty((S + 1, N))
    rate[:S] = np.minimum(j[None, :], k[:, None]) * mu
    rate[S] = j / z
    v_all = np.concatenate([v, [1.0]])
    cv_all = np.concatenate([cv, [1.0]])

    pi_prev = np.zeros((S + 1, N + 1))  # distribution at population n-1
    pi_prev[:, 0] = 1.0
    pi_at_nm1 = pi_prev
    lam = 0.0
    for n in range(1, N + 1):
        # E[response per visit] = sum_j (j+1)/mu(j+1) * pi(j | n-1);
        # for the delay station this reduces to exactly Z.  The cycle
        # sums cv * W alone — cycle_visits already carries the reach
        # (visit ratio) times the fork-join overlap factor.
        w = (pi_prev[:, :n] * (j[None, :n] / rate[:, :n])).sum(axis=1)
        lam = n / float((cv_all * w).sum())
        pi = np.zeros((S + 1, N + 1))
        pi[:, 1 : n + 1] = (
            lam * v_all[:, None] / rate[:, :n] * pi_prev[:, :n]
        )
        # rounding can push the tail slightly negative; clamp then close
        np.clip(pi, 0.0, None, out=pi)
        pi[:, 0] = np.maximum(1.0 - pi[:, 1:].sum(axis=1), 0.0)
        if n == N:
            pi_at_nm1 = pi_prev
        pi_prev = pi
    return lam, pi_at_nm1[:S], pi_at_nm1[S]


def repairman_distribution(
    sources: int, k: int, mu: float, theta: float
) -> np.ndarray:
    """Stationary census of an M/M/k//N station (machine repairman).

    ``sources`` requests each cycle between a think phase of mean
    ``theta`` and this station; birth rate (N - j)/theta, death rate
    min(j, k) * mu.  Returns pi over j = 0..N (float64, normalized).
    """
    n = int(sources)
    pi = np.zeros(n + 1)
    # log-space recursion for numerical range
    logp = np.zeros(n + 1)
    for j_ in range(n):
        birth = (n - j_) / theta
        death = min(j_ + 1, k) * mu
        logp[j_ + 1] = logp[j_] + np.log(birth) - np.log(death)
    logp -= logp.max()
    pi = np.exp(logp)
    return pi / pi.sum()


def fork_join_decomposition(
    visits: np.ndarray,
    cycle_visits: np.ndarray,
    replicas: np.ndarray,
    mu: float,
    delay_s: float,
    population: int,
    iters: int = 200,
    tol: float = 1e-10,
) -> Tuple[float, np.ndarray, float]:
    """Per-station finite-source decomposition for fork-join graphs.

    MVA's single-token population constraint (sum_s j_s + j_d = N) is
    wrong under concurrent fan-out: a forked request holds one token at
    EACH branch station simultaneously, so every station's census is
    bounded by C on its own.  Decompose: station s is an M/M/k//C
    repairman queue whose per-source think time is the rest of the
    cycle, theta_s = cycle / v_s - W_s, with the cycle closed through
    the fork-join-weighted response sum (H_m/m overlap factors in
    ``cycle_visits``).  Damped fixed point; an arriving request sees
    the census with C-1 sources (finite-source arrival theorem).

    Returns (lambda(N), pi_seen[(S, N)], cycle_s).
    """
    v = np.asarray(visits, np.float64)
    cv = np.asarray(cycle_visits, np.float64)
    k = np.asarray(replicas, int)
    S = len(v)
    N = int(population)
    z = max(float(delay_s), 1e-12)
    w = np.full(S, 1.0 / mu)
    active = v > 1e-12
    pi_seen = np.zeros((S, N))
    cycle = z + float((cv * w).sum())
    for _ in range(iters):
        cycle_new = z + float((cv * w).sum())
        cycle = 0.5 * cycle + 0.5 * cycle_new
        w_new = w.copy()
        for s in range(S):
            if not active[s]:
                continue
            theta = max(cycle / v[s] - w[s], 1e-9)
            pi = repairman_distribution(N - 1, int(k[s]), mu, theta)
            pi_seen[s, : len(pi)] = pi
            j = np.arange(len(pi))
            mean_wait = float(
                (pi * np.maximum(j - k[s] + 1, 0)).sum()
            ) / (k[s] * mu)
            w_new[s] = mean_wait + 1.0 / mu
        if float(np.abs(w_new - w).max()) < tol / mu:
            w = w_new
            break
        w = 0.5 * w + 0.5 * w_new
    cycle = z + float((cv * w).sum())
    return N / cycle, pi_seen, cycle


def _erlang_mixture_quantiles(
    weights: np.ndarray, rate: float, v_grid: np.ndarray,
    scv: float = 1.0,
) -> np.ndarray:
    """Quantiles of the census-conditional wait mixture at the grid's
    conditional probabilities u = 1 - exp(-v) (weights sum to 1).

    A request seeing j >= k in queue waits for m = j - k + 1 service
    completions at aggregate rate k*mu.  For exponential service that
    wait is Erlang(m, rate); for general service it is a sum of m iid
    (residual) services — same mean m/rate, variance m * scv / rate^2 —
    matched here by Gamma(shape m/scv, rate rate/scv).  scv=1 recovers
    Erlang exactly; deterministic service (scv ~ 0) collapses the
    conditional wait onto its mean, which is what the DES shows (an
    exponential-stage tail overestimated M/D/k saturated p99 by +38%).
    """
    m = np.arange(1, len(weights) + 1, dtype=np.float64)
    u = -np.expm1(-v_grid)
    scv = min(max(float(scv), 1e-3), 25.0)
    shape = m / scv
    rate_g = rate / scv

    def cdf(t: np.ndarray) -> np.ndarray:
        # regularized lower incomplete gamma = Gamma(shape, rate_g) CDF
        return (
            weights[None, :] * gammainc(shape[None, :], rate_g * t[:, None])
        ).sum(axis=1)

    # bracket: mean + generous multiple of the largest-stage scale
    mean = float((weights * m).sum()) / rate
    hi = np.full(len(v_grid), max(mean * 4.0, 1.0 / rate))
    while (cdf(hi) < u).any():
        hi = np.where(cdf(hi) < u, hi * 2.0, hi)
    lo = np.zeros_like(hi)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < u
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def repairman_marginals(
    visits: np.ndarray,
    replicas: np.ndarray,
    mu: float,
    cycle_s: float,
    w_prev: np.ndarray,
    population: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One sweep of the finite-source decomposition at a known cycle.

    Given the request's current mean cycle time, each station's
    per-source think time is theta_s = cycle / v_s - W_s; returns the
    arriving-customer census (population - 1 sources) and the updated
    mean response W_s.  Used by the engine's self-consistent fork-join
    fixed point (the cycle is re-measured from the engine's own
    fork-join composition each iteration).
    """
    v = np.asarray(visits, np.float64)
    k = np.asarray(replicas, int)
    S = len(v)
    N = int(population)
    pi_seen = np.zeros((S, N))
    pi_seen[:, 0] = 1.0
    w_new = np.asarray(w_prev, np.float64).copy()
    for s in range(S):
        if v[s] <= 1e-12:
            continue
        theta = max(cycle_s / v[s] - w_prev[s], 1e-9)
        pi = repairman_distribution(N - 1, int(k[s]), mu, theta)
        pi_seen[s, : len(pi)] = pi
        j = np.arange(len(pi))
        mean_wait = float(
            (pi * np.maximum(j - k[s] + 1, 0)).sum()
        ) / (k[s] * mu)
        w_new[s] = mean_wait + 1.0 / mu
    return pi_seen, w_new


def census_sigma(pi: np.ndarray) -> np.ndarray:
    """Per-station standard deviation of census distributions
    ``pi[s, j]`` (rows are queue-length pmfs)."""
    jj = np.arange(pi.shape[1], dtype=np.float64)
    mean_j = (pi * jj).sum(axis=1)
    var_j = (pi * jj**2).sum(axis=1) - mean_j**2
    return np.sqrt(np.maximum(var_j, 0.0))


def compress_census(pi_row: np.ndarray, scv: float) -> np.ndarray:
    """QNA-style census reshaping for non-exponential service.

    The convolution/decomposition census assumes exponential service;
    the real queue-length fluctuation scales roughly with the
    arrival+service variability.  Two regimes:

    - scv >= 1: the open-network QNA form sqrt((1 + scv) / 2)
      (Poisson-ish arrival stream, ca^2 ~ 1) — heavy tails widen the
      census.
    - scv < 1: the closed saturated loop feeds each station with the
      DEPARTURES of its neighbors, whose variability collapses with
      the service scv (Whitt's departure interpolation at rho -> 1:
      cd^2 ~ cs^2), so ca^2 ~ scv and the factor is
      sqrt((scv + scv) / 2) = sqrt(scv) — reaching the deterministic
      pipeline's point census at scv -> 0 instead of QNA's 0.71
      floor, which left M/D/k saturated p99 at +25% (VERDICT r4).

    Both forms agree at scv = 1 (exponential: no reshaping).  Mass is
    remapped with linear interpolation (mean-preserving up to edge
    clipping).
    """
    scv = min(max(float(scv), 1e-3), 25.0)
    if abs(scv - 1.0) < 1e-9:
        return pi_row
    f = np.sqrt(scv) if scv < 1.0 else np.sqrt((1.0 + scv) / 2.0)
    n = len(pi_row)
    j = np.arange(n, dtype=np.float64)
    mean = float((pi_row * j).sum())
    tgt = np.clip(mean + (j - mean) * f, 0.0, n - 1)
    lo = np.floor(tgt).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    w_hi = np.clip(tgt - lo, 0.0, 1.0)
    out = np.zeros(n)
    np.add.at(out, lo, pi_row * (1.0 - w_hi))
    np.add.at(out, hi, pi_row * w_hi)
    s = out.sum()
    return out / s if s > 0 else pi_row


def tables_from_pi(
    pi: np.ndarray,
    replicas: np.ndarray,
    mu: float,
    degree: int = DEFAULT_QUANTILE_DEGREE,
    v_max: float = 16.0,
    scv: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p_zero, coef, mean_wait) quantile-polynomial tables from
    arriving-customer census distributions ``pi[s, j]``.

    The per-station conditional wait quantile W_s(v), v = -log(1 - u'),
    is least-squares fit with a degree-``degree`` polynomial over
    v in [0, v_max] (u' up to 1 - 1.1e-7); stations sharing the same
    (k, queue distribution) reuse one fit.
    """
    S = pi.shape[0]
    k = np.asarray(replicas, int)
    p_zero = np.empty(S)
    coef = np.zeros((degree + 1, S))
    mean_wait = np.zeros(S)
    # Exclude v = 0 from the fit and leave the intercept free: when the
    # census mixture sits at high stages (say ~40 — a single-replica
    # bottleneck under chaos), the true quantile leaps from 0 to the
    # mixture's bulk within u' ~ 1e-20; a polynomial dragged through an
    # exact W(0)=0 anchor undershoots the entire low-quantile region
    # (measured: sampled mean 3.46 ms vs the Little-law 4.92 ms).  The
    # free intercept ~= W(0.0625), distorting only ~6% mass near the
    # atom for low-stage mixtures where W really is ~0 there (the
    # engine clamps sampled waits at 0 either way).
    v_grid = np.linspace(0.0, v_max, 257)[1:]
    cache: Dict[bytes, Tuple[np.ndarray, float]] = {}
    for s in range(S):
        ks = int(k[s])
        p0 = float(pi[s, :ks].sum())
        # weights over m = j - k + 1 Erlang stages, j >= k
        w = pi[s, ks:]
        wsum = float(w.sum())
        if wsum <= 1e-12:
            p_zero[s] = 1.0
            continue
        w = w / wsum
        rate = ks * mu
        key = np.round(w, 12).tobytes() + bytes([ks & 0xFF])
        if key not in cache:
            t = _erlang_mixture_quantiles(w, rate, v_grid, scv)
            c = np.polynomial.polynomial.polyfit(v_grid, t, degree)
            m = np.arange(1, len(w) + 1)
            cache[key] = (c, float((w * m).sum()) / rate)
        c, cond_mean = cache[key]
        p_zero[s] = p0
        coef[:, s] = c
        mean_wait[s] = (1.0 - p0) * cond_mean
    return p_zero, coef, mean_wait


def closed_network_tables(
    visits: np.ndarray,
    cycle_visits: np.ndarray,
    replicas: np.ndarray,
    mu: float,
    delay_s: float,
    population: int,
    degree: int = DEFAULT_QUANTILE_DEGREE,
    v_max: float = 16.0,
    scv: float = 1.0,
) -> ClosedTables:
    """Exact product-form sampling tables for chain (no fork-join)
    graphs, via the numerically stable convolution algorithm
    (``cycle_visits`` equals ``visits`` on chains — forks are the only
    source of cycle reweighting, and concurrent graphs use the
    engine's self-consistent fixed point over ``repairman_marginals``
    instead: the single-token population constraint, and with it the
    variance identity, doesn't survive forks).
    """
    lam, pi, pi_d = convolution_marginals(
        visits, replicas, mu, delay_s, population
    )
    if abs(scv - 1.0) > 1e-9:
        pi = np.stack([compress_census(row, scv) for row in pi])
        pi_d = compress_census(pi_d, scv)
    p_zero, coef, mean_wait = tables_from_pi(
        pi, replicas, mu, degree, v_max, scv
    )

    if scv < 1.0 - 1e-9:
        # Low-variability limit: a deterministic closed network runs a
        # synchronized pipeline — throughput is exactly
        # min(N / C0, lambda*) (C0 the zero-wait cycle, lambda* the
        # capacity bound) with a DEGENERATE sojourn at N / lambda
        # (measured: the DES oracle's saturated M/D/1 chain has
        # p50 = p99 = N / capacity to the sample).  The exponential
        # product form undershoots that throughput (~4% on chain3) and
        # its census keeps residual burstiness, so blend the
        # throughput linearly in scv toward the pipeline bound and
        # rescale the wait tables so the mean sojourn obeys Little's
        # law at the blended rate.  scv = 1 recovers the product form
        # untouched; both corrections vanish there.
        v = np.asarray(visits, np.float64)
        cyc = np.asarray(cycle_visits, np.float64)
        k = np.asarray(replicas, np.float64)
        active = v > 1e-12
        lam_cap = float(np.min(k[active] * mu / v[active]))
        c0 = float((cyc / mu).sum()) + float(delay_s)
        lam_det = min(population / c0, lam_cap)
        g = max(float(scv), 0.0)
        lam_new = g * lam + (1.0 - g) * lam_det
        budget = max(population / lam_new - c0, 0.0)
        budget_tab = float((cyc * mean_wait).sum())
        if budget_tab > 1e-12:
            c = budget / budget_tab
            coef = coef * c
            mean_wait = mean_wait * c
        lam = lam_new

    # population copula inputs: Var(sum_s j_s) = Var(j_delay) exactly —
    # the engine shrinks the sigma-weighted z-combination to this target
    jd = np.arange(len(pi_d), dtype=np.float64)
    var_d = float((pi_d * jd**2).sum() - ((pi_d * jd).sum()) ** 2)
    return ClosedTables(
        throughput=lam,
        p_zero=p_zero,
        coef=coef,
        mean_wait=mean_wait,
        sigma=census_sigma(pi),
        var_delay=var_d,
    )
