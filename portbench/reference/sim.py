"""The plain reference of a simulated Fortio run.

What one simulated request does, from the model's definition:

- each service is an M/M/k station (k replicas, mean CPU time per
  request, offered load = the client's rate times the expected visits),
  and a hop's queueing wait is drawn from its Erlang-C law: a coin
  against the delay probability and, below it, an exponential at rate
  ``k mu - lambda``;
- sibling hops (the calls of one step of one parent) draw their waits
  through a Gaussian copula: a shared group normal of weight
  ``sqrt(r)``, and same-depth groups correlate at ``gamma ** L`` through
  their ancestor groups ``L`` levels up;
- a hop's latency is its wait, its CPU time and its script: each step
  takes the longest of its sleep and its concurrent calls, a call takes
  the round trip of the wire plus the callee's latency, cut at the
  call's timeout, where the call fails and the script stops after that
  step; a hop that draws an error returns 500 at once;
- a hop is executed when its parent was, did not fail first, and
  reached the hop's step.

Everything is computed for a block of requests at a time, level by level
of the hop tree, in ``dtype`` (float64 by default; the control runs it
in bfloat16).  The random streams are the ones the program was handed
(``harness/streams.py``), made again from their paths.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from portbench.harness import streams
from portbench.reference.topology import parse, unroll

#: the block index base of a block loop: block b draws under 1_000_000 + b
BLOCK_INDEX_BASE = 1_000_000
#: a station at or past capacity is held just under it (and flagged)
MAX_RHO = 0.9999
NUM_BUCKETS = 2048
#: bucket i holds [EDGES[i], EDGES[i + 1]): 1 us .. 10 s, log-spaced
EDGES = np.concatenate([[0.0], np.geomspace(1e-6, 10.0, NUM_BUCKETS - 1),
                        [np.inf]])


class Summary(NamedTuple):
    """A run reduced to what the comparison reads (host numpy)."""

    count: float
    errors: float
    hop_events: float
    hist: np.ndarray          # (NUM_BUCKETS,) client latency counts
    latency_sum: float
    utilization: np.ndarray   # (S,) offered load over capacity
    blame: Optional[dict] = None  # ``blame.Blame.result()`` when asked


class BlockOut(NamedTuple):
    client_latency: torch.Tensor  # (n,)
    client_error: torch.Tensor    # (n,) bool
    hop_events: torch.Tensor      # scalar
    lat: torch.Tensor             # (n, H) each hop's latency
    wait: torch.Tensor            # (n, H) each hop's queueing wait
    sent: torch.Tensor            # (n, H) bool: the hop executed


def centers() -> np.ndarray:
    """Each latency bucket's value: the geometric mean of its edges."""
    c = np.empty(NUM_BUCKETS)
    c[0] = EDGES[1] / 2
    c[1:-1] = np.sqrt(EDGES[1:-2] * EDGES[2:-1])
    c[-1] = EDGES[-2]
    return c


def quantile(hist: np.ndarray, q: float) -> float:
    """The ``q`` quantile of a latency histogram: the value of the first
    bucket whose cumulative count reaches ``q`` of the total."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total == 0:
        return 0.0
    idx = np.searchsorted(np.cumsum(hist), q * total, side="left")
    return float(centers()[min(idx, NUM_BUCKETS - 1)])


def erlang_c(k: int, a: float) -> float:
    """P(wait > 0) of an M/M/k station at offered load ``a`` erlangs."""
    term, total = 1.0, 1.0
    for i in range(1, k):
        term *= a / i
        total += term
    top = term * a / k * (k / (k - a))
    return top / (total + top)


class _Depth(NamedTuple):
    lo: int                  # hops lo..hi-1 are this depth
    hi: int
    slot_hop: torch.Tensor   # (Q,) local hop of each script step
    slot_step: torch.Tensor  # (Q,) its step index
    slot_sleep: torch.Tensor  # (Q,) its sleep
    call_child: torch.Tensor  # (K,) global hop of the call's one attempt
    call_slot: torch.Tensor  # (K,)
    call_hop: torch.Tensor   # (K,) local hop of the caller
    call_step: torch.Tensor  # (K,)
    call_timeout: Optional[torch.Tensor]  # (K,), None when none is finite


class Model:
    """One configuration's reference on ``device`` in ``dtype``."""

    def __init__(self, config: dict, device="cpu", dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        p = config["params"]
        if p["service_time"] != "exponential":
            raise NotImplementedError("only exponential service times")
        topo = parse(config["topology"])
        tree = unroll(topo)
        if any(len(kids) > 1 for *_, kids in tree.calls):
            raise NotImplementedError("retried calls (the retry copula)")
        self.tree, self.topo = tree, topo
        self.cpu_time = float(p["cpu_time_s"])
        self.mu = 1.0 / self.cpu_time
        H = tree.num_hops
        self.num_hops = H
        svc = tree.service
        base, bps = p["network_base_latency_s"], p["network_bytes_per_second"]
        net_out = base + tree.request_size / bps
        net_back = base + topo.response_size[svc] / bps
        self.root_net = float(net_out[0] + net_back[0])
        self.rtt = self._t(net_out + net_back)
        err = topo.error_rate[svc]
        self.err_rate = self._t(err) if (err > 0).any() else None
        # expected visits of each service per client request
        reach = np.ones(H)
        for h in range(1, H):
            q = tree.parent[h]
            reach[h] = (reach[q] * tree.send_prob[h]
                        * (1.0 - topo.error_rate[svc[q]])
                        * topo.error_rate[svc[h]] ** tree.attempt[h])
        self.visits = np.bincount(svc, weights=reach,
                                  minlength=len(topo.names))
        self._copula(p["sibling_copula_r"], p["hierarchical_copula_gamma"])
        self.depths = self._depths()
        self._stations: Dict[float, tuple] = {}

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device,
                               dtype=dtype or self.dtype)

    def _copula(self, r: float, gamma: float) -> None:
        """Sibling groups and the hierarchical mix of their normals."""
        tree = self.tree
        H = tree.num_hops
        group = np.zeros(H, np.int64)
        gid: Dict[Tuple[int, int], int] = {}
        gparent = [0]             # the root hop is group 0, alone
        for h in range(1, H):
            key = (int(tree.parent[h]), int(tree.step[h]))
            if key not in gid:
                gid[key] = len(gid) + 1
                gparent.append(int(group[tree.parent[h]]))
            group[h] = gid[key]
        G = len(gid) + 1
        active = np.nonzero(np.bincount(group, minlength=G) > 1)[0]
        self.copula = bool(len(active)) and r > 0.0
        self.group = self._t(group, torch.int64)
        self.sib_w, self.own_w = math.sqrt(r), math.sqrt(1.0 - r)
        self.sib_dim = G if self.copula else 0
        self.num_groups = G
        self.mix = None
        if not (self.copula and gamma > 0.0):
            return
        # group g's normal: its own factor, then one factor per
        # (ancestor group, levels up) pair, the root's last; factors
        # are numbered past the G groups in the order first needed
        pairs: Dict[Tuple[int, int], int] = {}
        coef = []
        for row, g in enumerate(active):
            w, a, lev = 1.0, int(g), 0
            while a != 0:
                f = a if lev == 0 else pairs.setdefault((a, lev),
                                                        G + len(pairs))
                coef.append((row, f, math.sqrt(w * (1.0 - gamma))))
                w *= gamma
                a = gparent[a]
                lev += 1
            coef.append((row, pairs.setdefault((0, lev), G + len(pairs)),
                         math.sqrt(w)))
        mix = np.zeros((len(active), G + len(pairs)))
        for row, f, c in coef:
            mix[row, f] = c
        self.sib_dim = G + len(pairs)
        self.mix = self._t(mix)
        self.active = self._t(active, torch.int64)

    def _depths(self) -> List[_Depth]:
        tree = self.tree
        out = []
        for d in range(int(tree.depth.max()) + 1):
            hops = np.nonzero(tree.depth == d)[0]
            lo, hi = int(hops[0]), int(hops[-1]) + 1
            slot_hop, slot_step, slot_sleep = [], [], []
            child, cslot, chop, cstep, ctime = [], [], [], [], []
            for h in range(lo, hi):
                for s, (sleep, call_ids) in enumerate(tree.steps[h]):
                    for c in call_ids:
                        _, _, timeout, kids = tree.calls[c]
                        child.append(kids[0])
                        cslot.append(len(slot_hop))
                        chop.append(h - lo)
                        cstep.append(s)
                        ctime.append(timeout)
                    slot_hop.append(h - lo)
                    slot_step.append(s)
                    slot_sleep.append(sleep)
            i64 = torch.int64
            finite = bool(np.isfinite(ctime).any()) if ctime else False
            out.append(_Depth(
                lo=lo, hi=hi,
                slot_hop=self._t(slot_hop, i64),
                slot_step=self._t(slot_step, i64),
                slot_sleep=self._t(slot_sleep),
                call_child=self._t(child, i64),
                call_slot=self._t(cslot, i64),
                call_hop=self._t(chop, i64),
                call_step=self._t(cstep, i64),
                call_timeout=self._t(ctime) if finite else None,
            ))
        return out

    # -- the streams one block takes ------------------------------------

    def stream_shapes(self, n: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """``name -> (shape, law)`` of the streams this model reads."""
        H = self.num_hops
        out = {"svc": ((n, H), "exponential")}
        if self.err_rate is not None:
            out["u_err"] = ((n, H), "uniform")
        if self.copula:
            out["z_h"] = ((n, H), "normal")
            out["z_small"] = ((n, self.sib_dim), "normal")
        else:
            out["u_wait"] = ((n, H), "uniform")
        return out

    def block_streams(self, seed: int, path, n: int) -> Dict[str, torch.Tensor]:
        return {
            name: streams.stream(seed, path, name, shape, law, self.device)
            for name, (shape, law) in self.stream_shapes(n).items()
        }

    # -- the stations at a rate ------------------------------------------

    def stations(self, qps: float):
        """(p_wait, wait_rate, utilization) per service at ``qps``."""
        if qps not in self._stations:
            self._stations[qps] = self._stations_at(qps)
        return self._stations[qps]

    def _stations_at(self, qps: float):
        k = self.topo.replicas.astype(np.float64)
        rho_raw = qps * self.visits / (k * self.mu)
        rho = np.minimum(rho_raw, MAX_RHO)
        p_wait = np.array([erlang_c(int(ki), float(r * ki))
                           for ki, r in zip(k, rho)])
        return p_wait, k * self.mu * (1.0 - rho), rho_raw

    # -- one block ---------------------------------------------------------

    def block(self, s: Dict[str, torch.Tensor], qps: float):
        """``(client latency, client error, hop events)`` of one block."""
        tree, dt = self.tree, self.dtype
        svc_of = self._t(tree.service, torch.int64)
        p_wait, wait_rate, _ = self.stations(qps)
        p_h = self._t(p_wait)[svc_of]
        rate_h = self._t(wait_rate)[svc_of]
        if self.copula:
            z_small = s["z_small"].to(dt)
            zg = z_small[:, : self.num_groups].clone()
            if self.mix is not None:
                zg[:, self.active] = z_small @ self.mix.T
            z = self.sib_w * zg[:, self.group] + self.own_w * s["z_h"].to(dt)
            u = torch.special.ndtr(z.double()).to(dt)
        else:
            u = s["u_wait"].to(dt)
        zero = torch.zeros((), dtype=dt, device=self.device)
        # the uniforms lie in [0, 1): below the coin, u / p is uniform
        # too, floored so that u == 0 gives a long wait and not inf
        wait = torch.where(
            u < p_h, -torch.log(torch.clamp(u / p_h, min=1e-20)) / rate_h,
            zero,
        )
        own = wait + s["svc"].to(dt) * self.cpu_time
        n, H = own.shape
        err = (s["u_err"] < self.err_rate.float() if self.err_rate is not None
               else torch.zeros((n, H), dtype=torch.bool, device=self.device))
        lat = torch.empty((n, H), dtype=dt, device=self.device)
        fail_at: List[torch.Tensor] = [None] * len(self.depths)
        never = torch.iinfo(torch.int64).max
        for d in reversed(range(len(self.depths))):
            dp = self.depths[d]
            P = dp.hi - dp.lo
            fail = torch.full((n, P), never, dtype=torch.int64,
                              device=self.device)
            busy = torch.zeros((n, P), dtype=dt, device=self.device)
            if len(dp.slot_hop):
                agg = torch.zeros((n, len(dp.slot_hop)), dtype=dt,
                                  device=self.device)
                if len(dp.call_child):
                    t = self.rtt[dp.call_child] + lat[:, dp.call_child]
                    if dp.call_timeout is not None:
                        cut = t > dp.call_timeout
                        t = torch.minimum(t, dp.call_timeout)
                        fail.scatter_reduce_(
                            1, dp.call_hop.expand(n, -1),
                            torch.where(cut, dp.call_step, never), "amin",
                        )
                    agg.scatter_reduce_(1, dp.call_slot.expand(n, -1), t,
                                        "amax")
                step_t = torch.maximum(agg, dp.slot_sleep)
                reached = dp.slot_step <= fail[:, dp.slot_hop]
                busy.index_add_(1, dp.slot_hop,
                                torch.where(reached, step_t, zero))
            sl = slice(dp.lo, dp.hi)
            busy = torch.where(err[:, sl], zero, busy)
            lat[:, sl] = own[:, sl] + busy
            fail_at[d] = fail
        # which hops execute: parents that ran, did not 500, and reached
        # the step of the call
        sent = torch.zeros((n, H), dtype=torch.bool, device=self.device)
        sent[:, 0] = True
        for d, dp in enumerate(self.depths[:-1]):
            if not len(dp.call_child):
                continue
            par = dp.lo + dp.call_hop
            sent[:, dp.call_child] = (
                sent[:, par] & ~err[:, par]
                & (dp.call_step <= fail_at[d][:, dp.call_hop])
            )
        client_error = err[:, 0] | (fail_at[0][:, 0] != never)
        return BlockOut(self.root_net + lat[:, 0], client_error, sent.sum(),
                        lat, wait, sent)

    # -- a run --------------------------------------------------------------

    def run(self, seed: int, prefix: Tuple[int, ...], qps: float,
            requests: int, block: int,
            blame: Optional[dict] = None) -> Summary:
        """A block loop of ``ceil(requests / block)`` blocks of
        ``min(block, requests)`` rows whose block ``b`` took the streams
        at ``prefix + (1_000_000 + b,)``.

        ``blame`` (``top_k``, ``tail_quantile``, ``pilot_index``,
        ``pilot_requests``, optionally ``judge_cut``) also reduces
        critical-path blame, its tail cut estimated by a pilot run under
        ``prefix + (pilot_index,)`` and its tail sums taken at
        ``judge_cut`` where given.
        """
        acc = None
        if blame is not None:
            from portbench.reference.blame import Blame

            n = min(requests, blame["pilot_requests"])
            pilot = self.run(seed, tuple(prefix) + (blame["pilot_index"],),
                             qps, n, min(block, n))
            acc = Blame(self, quantile(pilot.hist, blame["tail_quantile"]),
                        blame["top_k"], blame.get("judge_cut"))
        block = min(block, requests)
        blocks = -(-requests // block)
        hist = np.zeros(NUM_BUCKETS)
        count = errors = events = lat_sum = 0.0
        edges = torch.as_tensor(EDGES[1:-1], device=self.device,
                                dtype=torch.float64)
        for b in range(blocks):
            path = tuple(prefix) + (BLOCK_INDEX_BASE + b,)
            out = self.block(self.block_streams(seed, path, block), qps)
            if acc is not None:
                acc.block(out)
            lat, err, ev = out.client_latency, out.client_error, out.hop_events
            del out
            lat64 = lat.double()
            idx = torch.bucketize(lat64, edges, right=True)
            idx = torch.where(torch.isnan(lat64), NUM_BUCKETS - 1, idx)
            hist += torch.bincount(idx, minlength=NUM_BUCKETS).cpu().numpy()
            count += lat.shape[0]
            errors += float(err.sum())
            events += float(ev)
            lat_sum += float(lat64.sum())
        return Summary(count=count, errors=errors, hop_events=events,
                       hist=hist, latency_sum=lat_sum,
                       utilization=self._t(self.stations(qps)[2])
                       .double().cpu().numpy(),
                       blame=acc.result() if acc is not None else None)
