"""The plain reference of a simulated Fortio ``-qps max`` run.

Fortio's ``-qps max`` keeps exactly C requests in flight, so the mesh is
a closed product-form network (BCMP): one single-server FIFO station per
service, at rate ``mu = 1 / cpu_time``, visited ``v_s`` times a request,
and one delay station of mean ``Z`` that holds a request while it is on
the wire or asleep: the sum over hops of their reach times their round
trip and sleeps.  From that definition:

- **Normalising constants.**  ``G(n) = sum over j_1 + .. + j_S + j_d = n
  of prod_s x_s^j_s * Z^j_d / j_d!``, ``x_s = v_s / mu``, in log space.
  Stations with one visit ratio form a group of ``m`` whose product is
  closed form, ``binom(n + m - 1, m - 1) x^n``; the groups and the delay
  station join by direct log-space convolution.
- **Throughput** ``lambda = G(C - 1) / G(C)``: the requests a second the
  loop completes.
- **Arrival census** (arrival theorem: a request arriving at a station
  sees the network with C - 1 requests): ``P(j_s >= j) = x_s^j
  G(C - 1 - j) / G(C - 1)``, and the delay station's ``P(j_d = j) =
  Z^j / j! * G_-d(C - 1 - j) / G(C - 1)``, ``G_-d`` the stations' alone.
- **Wait law.**  A request that finds ``j >= 1`` ahead waits for ``j``
  service completions, Erlang(j, mu); with none ahead it waits 0.  A
  hop's conditional uniform ``u'`` above the zero-wait mass ``p0`` maps
  to the mixture's quantile at ``v = -log(1 - u')``, tabulated at
  ``TABLE_POINTS`` in ``v`` (dense near 0) by bisection on the survival
  function and read by linear interpolation: its own error is under
  1e-6 of the wait (``tests`` hold it against exact quantiles between
  its points).
- **Population copula.**  The census sums to C - 1, so the stations'
  counts are negatively correlated: ``Var(sum_s j_s) = Var(j_d)``.  With
  each hop's normal weighted by its station's census deviation
  ``sigma_h`` (shared among the station's hops), the sum's variance
  ``ss = sum sigma_h^2`` shrinks to ``Var(j_d)`` by taking ``c`` of the
  normals' projection on ``e = sigma / sqrt(ss)`` away: ``z' = (z - c e
  (e . z)) / sqrt(1 - (2c - c^2) e^2)``, ``c = 1 - sqrt(Var(j_d) / ss)``,
  which keeps each ``z'_h`` standard normal.
- The hop's own time is its wait plus its service draw times the CPU
  time, composed over the script by ``reference/sim.py``'s wire and
  sequential-step composition.

Single-server stations on chains (no concurrent calls) only; the law is
solved in float64 whatever ``dtype`` the per-hop arithmetic takes.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from portbench.reference.sim import Model

#: points of each wait-quantile table over ``v`` in [0, V_MAX], point
#: ``i`` at ``V_MAX * (i / (TABLE_POINTS - 1))^2``: dense where a mixture
#: of high stages rises steeply from 0
TABLE_POINTS = 16_385
V_MAX = 40.0
#: stages of a census past which less mass lies are left out of the wait
#: law (its survival is read down to exp(-V_MAX) = 4e-18)
STAGE_TAIL_MASS = 1e-30
#: rows of one chunk of the direct log-space convolution
CONV_ROWS = 1024


def log_convolve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``log (exp(a) (*) exp(b))`` truncated to ``len(a)`` terms: ``out[n]
    = logsumexp_{j <= n} a[j] + b[n - j]``, in chunks of rows."""
    size = len(a)
    j = torch.arange(size, device=a.device)
    out = torch.empty_like(a)
    for lo in range(0, size, CONV_ROWS):
        n = torch.arange(lo, min(lo + CONV_ROWS, size), device=a.device)
        back = n[:, None] - j[None, :]
        terms = a[None, :] + b[back.clamp(min=0)]
        terms = terms.masked_fill(back < 0, -torch.inf)
        out[lo:lo + len(n)] = torch.logsumexp(terms, 1)
    return out


class Law(NamedTuple):
    """The finite-population law of one configuration at C connections
    (float64 tensors on the model's device)."""

    throughput: float
    p0: torch.Tensor        # (S,) P(no wait) at arrival
    group: torch.Tensor     # (S,) each station's row of ``table``
    sigma: torch.Tensor     # (S,) std of its arrival census
    var_delay: float        # Var(j_d)
    table: torch.Tensor     # (G, TABLE_POINTS) wait quantiles


def solve(visits: np.ndarray, mu: float, delay_s: float, connections: int,
          device) -> Law:
    """The law of single-server stations with visit ratios ``visits``
    at rate ``mu`` and a delay station of mean ``delay_s``."""
    f64 = dict(dtype=torch.float64, device=device)
    N = int(connections)
    n = torch.arange(N + 1, **f64)
    v = torch.as_tensor(visits, **f64)
    S = len(v)
    active = v > 0
    lx_all = torch.log(torch.where(active, v, 1.0) / mu)
    lx, group = torch.unique(lx_all[active], return_inverse=True)
    counts = torch.bincount(group, minlength=len(lx)).to(torch.float64)
    # the stations' product, one closed-form group at a time
    lg_st = torch.full((N + 1,), -torch.inf, **f64)
    lg_st[0] = 0.0
    for lxg, m in zip(lx, counts):
        lg_grp = (torch.lgamma(n + m) - torch.lgamma(m)
                  - torch.lgamma(n + 1) + n * lxg)
        lg_st = log_convolve(lg_st, lg_grp)
    z = max(float(delay_s), 1e-12)
    lf_d = n * np.log(z) - torch.lgamma(n + 1)
    lg = log_convolve(lg_st, lf_d)
    throughput = float(torch.exp(lg[N - 1] - lg[N]))
    top = N - 1
    j = n[: top + 1]
    # arrival census of each group: P(j_s >= j), then its pmf
    back = torch.flip(lg[: top + 1], [0])
    tail = torch.exp(lx[:, None] * j[None, :] + back[None, :] - lg[top])
    pmf = tail - torch.cat([tail[:, 1:], torch.zeros_like(tail[:, :1])], 1)
    pmf = pmf.clamp(min=0.0)
    p0_grp = pmf[:, 0]
    mean = (pmf * j).sum(1)
    sigma_grp = ((pmf * j * j).sum(1) - mean * mean).clamp(min=0.0).sqrt()
    raw = lf_d[: top + 1] + torch.flip(lg_st[: top + 1], [0])
    pd = torch.exp(raw - raw.max())
    pd = pd / pd.sum()
    md = (pd * j).sum()
    var_delay = float((pd * j * j).sum() - md * md)
    table = torch.stack([quantile_table(pmf[g, 1:] / (1.0 - p0_grp[g]), mu)
                         for g in range(len(lx))]) if len(lx) else \
        torch.zeros((0, TABLE_POINTS), **f64)
    p0 = torch.ones(S, **f64)
    sigma = torch.zeros(S, **f64)
    grp = torch.zeros(S, dtype=torch.int64, device=device)
    p0[active] = p0_grp[group]
    sigma[active] = sigma_grp[group]
    grp[active] = group
    return Law(throughput=throughput, p0=p0, group=grp, sigma=sigma,
               var_delay=var_delay, table=table)


def grid(device, points: int = TABLE_POINTS) -> torch.Tensor:
    """The table's points in ``v``."""
    i = torch.arange(points, dtype=torch.float64, device=device)
    return V_MAX * (i / (points - 1)) ** 2


def quantile_table(w: torch.Tensor, mu: float, v=None) -> torch.Tensor:
    """Quantiles at ``v`` (u' = 1 - e^-v; default the table's points) of
    the wait mixture ``sum_m w[m - 1] Erlang(m, mu)``, by bisection on its
    survival function."""
    f64 = dict(dtype=w.dtype, device=w.device)
    v = grid(w.device) if v is None else v
    tail = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    keep = int(torch.nonzero(tail >= STAGE_TAIL_MASS).max()) + 1
    w = w[:keep]
    m = torch.arange(1, keep + 1, **f64)
    target = torch.exp(-v)

    def survival(t):
        return (w * torch.special.gammaincc(m, mu * t[:, None])).sum(1)

    hi = torch.full_like(v, 4.0 * float((w * m).sum()) / mu + 1.0 / mu)
    while bool((survival(hi) > target).any()):
        hi = torch.where(survival(hi) > target, 2.0 * hi, hi)
    lo = torch.zeros_like(hi)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        above = survival(mid) > target
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    return torch.where(v > 0, 0.5 * (lo + hi), 0.0)


def read_table(flat: torch.Tensor, row: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """The tables' quantile at ``v`` (any shape, in [0, V_MAX]) from the
    flattened (G * TABLE_POINTS,) tables, each element's table starting
    at ``row``: linear between the two points around it, in ``v``."""
    last = TABLE_POINTS - 1
    i = (torch.sqrt(v / V_MAX) * last).floor().long().clamp(0, last - 1)
    at = i.to(torch.float64)
    v_lo = V_MAX * (at / last) ** 2
    v_hi = V_MAX * ((at + 1) / last) ** 2
    frac = ((v - v_lo) / (v_hi - v_lo)).to(v.dtype)
    lo = flat[row + i].to(v.dtype)
    hi = flat[row + i + 1].to(v.dtype)
    return lo + frac * (hi - lo)


class ClosedModel(Model):
    """``reference/sim.Model``'s composition over hop times drawn from the
    finite-population law at ``connections``.

    ``Model.block`` is handed no open-loop wait (every station's delay
    probability is 0 here) and each hop's own time, wait and CPU, as its
    service stream in units of the CPU time.
    """

    def __init__(self, config: dict, connections: int, device="cpu",
                 dtype=torch.float64):
        super().__init__(config, device, dtype)
        tree, topo = self.tree, self.topo
        if (topo.replicas != 1).any():
            raise NotImplementedError("multi-server stations")
        if self.num_groups < tree.num_hops:
            raise NotImplementedError("concurrent calls (fork-join)")
        self.connections = int(connections)
        H = tree.num_hops
        reach = np.ones(H)
        for h in range(1, H):
            q = tree.parent[h]
            reach[h] = (reach[q] * tree.send_prob[h]
                        * (1.0 - topo.error_rate[tree.service[q]])
                        * topo.error_rate[tree.service[h]]
                        ** tree.attempt[h])
        sleeps = np.asarray([sum(s for s, _ in st) for st in tree.steps])
        delay = float((reach * (self.rtt.double().cpu().numpy()
                                + sleeps)).sum())
        law = solve(self.visits, self.mu, delay, self.connections,
                    self.device)
        self.throughput = law.throughput
        svc = torch.as_tensor(tree.service, device=self.device)
        hops_of = torch.bincount(svc, minlength=len(topo.names))
        sig = law.sigma[svc] / hops_of[svc]
        ss = float((sig * sig).sum())
        self.center = 0.0
        self.e = torch.zeros(H, dtype=torch.float64, device=self.device)
        self.scale = torch.ones_like(self.e)
        if ss > 0.0 and law.var_delay < ss:
            c = 1.0 - (max(law.var_delay, 0.0) / ss) ** 0.5
            self.center, self.e = c, sig / ss ** 0.5
            self.scale = 1.0 / torch.sqrt(1.0 - (2 * c - c * c)
                                          * self.e ** 2)
        self.p0_h = law.p0[svc]
        self.row_h = law.group[svc] * TABLE_POINTS
        self.flat = law.table.reshape(-1)

    def stream_shapes(self, n: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        out = {"z_h": ((n, self.num_hops), "normal"),
               "svc": ((n, self.num_hops), "exponential")}
        if self.err_rate is not None:
            out["u_err"] = ((n, self.num_hops), "uniform")
        return out

    def stations(self, qps: float):
        """No open-loop wait; utilization at the closed loop's rate."""
        k = self.topo.replicas.astype(np.float64)
        S = len(k)
        return np.zeros(S), np.ones(S), qps * self.visits / (k * self.mu)

    def waits(self, z: torch.Tensor) -> torch.Tensor:
        """(n, H) waits of the finite-population law from the normals."""
        dt = self.dtype
        z = z.to(dt)
        if self.center > 0.0:
            e = self.e.to(dt)
            z = (z - self.center * e * (z * e).sum(-1, keepdim=True)) \
                * self.scale.to(dt)
        u = torch.special.ndtr(z.double()).to(dt)
        p0 = self.p0_h.to(dt)
        u_c = (u - p0) / (1.0 - p0).clamp(min=1e-300)
        v = (-torch.log1p(-u_c.clamp(0.0, 1.0))).clamp(0.0, V_MAX)
        wait = read_table(self.flat, self.row_h, v)
        return torch.where(u < p0, torch.zeros((), dtype=dt,
                                               device=self.device), wait)

    def block(self, s: Dict[str, torch.Tensor], qps: float):
        dt = self.dtype
        own = self.waits(s["z_h"]) + s["svc"].to(dt) * self.cpu_time
        hand = {k: x for k, x in s.items() if k != "z_h"}
        hand["svc"] = own / self.cpu_time
        hand["u_wait"] = torch.ones_like(own)
        return super().block(hand, qps)
