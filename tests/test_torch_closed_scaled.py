"""The finite-population solve that scales (``sim/closed.py``:
``log_convolution_marginals``, ``quantile_tables``) against the
convolution path it stands in for, a plain log-space convolution and the
mean value analysis.

Where the convolution is right, the log-space solve gives its law to
float64 rounding: throughput, the arrival census of every station and of
the delay station, and the quantile tables fit to them (``coef``
relative to each station's largest coefficient, since the polynomial's
high terms are near 0).  Probabilities are held to 1e-12 absolute: a
saturated station's census is ``P(j >= 0) - P(j >= 1)`` in the
closed form, so a ``p_zero`` of 1.5e-7 keeps the log solve's absolute
precision (1.1e-7 of it), not a relative one.  Near its underflow the
convolution returns a wrong throughput before it raises; there the log
solve is held to a plain log-space convolution.  At the 1,000-station
chain's 10,000 connections, where the convolution raises, the solve
returns in seconds, its throughput is the mean value analysis's, its
marginals are distributions and each station's mean census is the
analysis's (Little's law at C - 1).
"""
import time

import numpy as np
import pytest
from scipy.special import gammaln, logsumexp

from isotope_tpu_torch.sim import closed

MU = 13_000.0
RTOL = 1e-9
PROB_ATOL = 1e-12


def _chain(stations, two_every=0, spread=False):
    """Visit ratios and replicas of a chain: visits 1 (or spread over
    0.5-1.5), every ``two_every``-th station with two replicas."""
    v = (np.linspace(0.5, 1.5, stations) if spread
         else np.ones(stations))
    k = np.ones(stations)
    if two_every:
        k[::two_every] = 2
    return v, k


def _tables(lam, pi, pi_d, k, fit):
    p_zero, coef, _ = fit(pi, k, MU)
    jd = np.arange(len(pi_d))
    var_d = (pi_d * jd**2).sum() - (pi_d * jd).sum() ** 2
    return lam, p_zero, coef, closed.census_sigma(pi), var_d


def _same_tables(new, old):
    lam, p_zero, coef, sigma, var_d = new
    lam_o, p_zero_o, coef_o, sigma_o, var_d_o = old
    np.testing.assert_allclose(lam, lam_o, rtol=RTOL)
    np.testing.assert_allclose(p_zero, p_zero_o, rtol=0, atol=PROB_ATOL)
    for s in range(coef.shape[1]):
        scale = float(np.abs(coef_o[:, s]).max())
        np.testing.assert_allclose(coef[:, s], coef_o[:, s], rtol=0,
                                   atol=RTOL * scale)
    np.testing.assert_allclose(sigma, sigma_o, rtol=RTOL)
    np.testing.assert_allclose(var_d, var_d_o, rtol=RTOL)


@pytest.mark.parametrize("stations,two,spread,delay,population", [
    (12, 0, True, 0.003, 64),
    (12, 3, True, 0.003, 64),
    (8, 0, True, 0.01, 500),
    (8, 2, False, 0.01, 500),
])
def test_the_log_space_solve_is_the_convolution(stations, two, spread, delay,
                                                population):
    v, k = _chain(stations, two, spread)
    old = closed.convolution_marginals(v, k, MU, delay, population)
    new = closed.log_convolution_marginals(v, k, MU, delay, population)
    np.testing.assert_allclose(new[0], old[0], rtol=RTOL)
    np.testing.assert_allclose(new[1], old[1], rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(new[2], old[2], rtol=0, atol=PROB_ATOL)
    _same_tables(_tables(*new, k, closed.quantile_tables),
                 _tables(*old, k, closed.tables_from_pi))


def plain_log_convolution(visits, replicas, mu, delay, population):
    """Throughput of Buzen's constants by direct log-space convolution,
    one station at a time, O(S * N^2)."""
    n = np.arange(population + 1)
    lg = n * np.log(delay) - gammaln(n + 1)
    j = np.arange(1, population + 1)
    for v, k in zip(visits, replicas):
        lf = np.concatenate([[0.0], np.cumsum(
            np.log(v / (np.minimum(j, k) * mu)))])
        lg = np.array([logsumexp(lg[:m + 1] + lf[m::-1])
                       for m in range(population + 1)])
    return float(np.exp(lg[-2] - lg[-1]))


def test_at_its_last_population_the_convolution_is_wrong():
    """60 stations, every other with two replicas, 50 ms of delay: the
    convolution returns at 766 connections and raises at 767, but from
    about 500 on its normalised products have lost terms."""
    v, k = _chain(60, 2)
    with pytest.raises(FloatingPointError, match="underflow"):
        closed.convolution_marginals(v, k, MU, 0.05, 767)
    for n, lost in ((500, 1e-6), (766, 0.5)):
        want = plain_log_convolution(v, k, MU, 0.05, n)
        old = closed.convolution_marginals(v, k, MU, 0.05, n)[0]
        lam, pi, pi_d = closed.log_convolution_marginals(v, k, MU, 0.05, n)
        np.testing.assert_allclose(lam, want, rtol=RTOL)
        assert abs(old - want) > lost * want
        np.testing.assert_allclose(pi.sum(1), 1.0, rtol=0, atol=PROB_ATOL)
        np.testing.assert_allclose(pi_d.sum(), 1.0, rtol=0, atol=PROB_ATOL)


def test_closed_network_tables_takes_the_scaled_solve_past_its_bound():
    v, k = _chain(12, 3, True)
    n = closed.CONVOLUTION_MAX_POPULATION + 1
    got = closed.closed_network_tables(v, v, k, MU, 0.003, n)
    lam, pi, pi_d = closed.convolution_marginals(v, k, MU, 0.003, n)
    want = _tables(lam, pi, pi_d, k, closed.tables_from_pi)
    _same_tables((got.throughput, got.p_zero, got.coef, got.sigma,
                  got.var_delay), want)
    # at the bound, the convolution path itself
    n = closed.CONVOLUTION_MAX_POPULATION
    got = closed.closed_network_tables(v, v, k, MU, 0.003, n)
    lam, pi, pi_d = closed.convolution_marginals(v, k, MU, 0.003, n)
    assert got.throughput == lam
    np.testing.assert_array_equal(
        got.coef, closed.tables_from_pi(pi, k, MU)[1])


def mva(visits, mu, delay, population):
    """Mean value analysis of single-server stations and a delay
    station: ``(X(n), Q(n))`` for ``n = 1 .. population``."""
    q = np.zeros(len(visits))
    xs, qs = [], []
    for n in range(1, population + 1):
        w = (1.0 + q) / mu
        x = n / (delay + float((visits * w).sum()))
        q = x * visits * w
        xs.append(x)
        qs.append(q)
    return np.asarray(xs), np.asarray(qs)


def test_ten_thousand_connections_on_a_thousand_stations():
    S, N, Z = 1000, 10_000, 0.4997
    v, k = np.ones(S), np.ones(S)
    t = time.perf_counter()
    lam, pi, pi_d = closed.log_convolution_marginals(v, k, MU, Z, N)
    p_zero, coef, _ = closed.quantile_tables(pi, k, MU)
    took = time.perf_counter() - t
    assert took < 120.0, took
    xs, qs = mva(v, MU, Z, N)
    np.testing.assert_allclose(lam, xs[-1], rtol=RTOL)
    assert np.isfinite(pi).all() and np.isfinite(coef).all()
    np.testing.assert_allclose(pi.sum(1), 1.0, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(pi_d.sum(), 1.0, rtol=0, atol=PROB_ATOL)
    # Little's law at C - 1: each station's mean census, and the delay
    # station's X(C - 1) * Z
    j = np.arange(N)
    np.testing.assert_allclose((pi * j).sum(1), qs[-2], rtol=RTOL)
    np.testing.assert_allclose((pi_d * j).sum(), xs[-2] * Z, rtol=RTOL)
    np.testing.assert_allclose((pi * j).sum() + (pi_d * j).sum(), N - 1,
                               rtol=RTOL)
    # 1,000 equal stations: one fit, 18% of arrivals find no queue
    assert (p_zero == p_zero[0]).all() and 0.1 < p_zero[0] < 0.3


def test_mixed_replicas_at_scale_hold_littles_law():
    """Two-replica stations take the leave-one-out products: 200
    stations, every fourth with two replicas, at 3,000 connections."""
    v, k = _chain(200, 4, True)
    lam, pi, pi_d = closed.log_convolution_marginals(v, k, MU, 0.2, 3000)
    np.testing.assert_allclose(pi.sum(1), 1.0, rtol=0, atol=PROB_ATOL)
    # utilization law at C - 1 seen from each station's census:
    # E[min(j, k)] = X(C - 1) v / mu, the same X for every station
    j = np.arange(3000)
    busy = (pi * np.minimum(j[None, :], k[:, None])).sum(1)
    x = busy * MU / v
    np.testing.assert_allclose(x, x[0], rtol=RTOL)
    np.testing.assert_allclose((pi_d * j).sum(), x[0] * 0.2, rtol=RTOL)
    assert x[0] < lam
