"""The plain reference of critical-path blame.

A request's client latency splits along the critical path of its hop
tree: the client edge's round trip; on each hop of the path its queueing
wait and its self time (CPU, sleeps, and step time no call covered);
and at each step of a hop on the path, the call that took longest (the
first such call when several tie, and only if it outlasts the step's
sleep) passes the path on: its wire round trip is charged to the edge
into the callee, which continues the path, or, where the call hit its
timeout, the whole timeout is charged to the edge and the path stops.

Tail blame repeats every sum over the requests whose latency reaches the
tail cut, which the run estimates first from a pilot of its own (the
quantile of an 8,192-request run under the pilot's index); a judged
run's tail sums are taken at that run's own cut.  Per-service
blame histograms bin each path hop's charge into 64 log-spaced buckets,
and the run keeps its ``top_k`` slowest latencies.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

NUM_BLAME_BUCKETS = 64
#: blame bucket i holds [BLAME_EDGES[i], BLAME_EDGES[i + 1]): 1 us .. 10 s
BLAME_EDGES = np.concatenate(
    [[0.0], np.geomspace(1e-6, 10.0, NUM_BLAME_BUCKETS - 1), [np.inf]]
)
VECTORS = ("crit", "wait", "self", "net", "timeout")


class Blame:
    """Blame sums of a run, accumulated block by block (float64)."""

    def __init__(self, model, tail_cut: Optional[float], top_k: int,
                 judge_cut: Optional[float] = None):
        H, S = model.num_hops, len(model.topo.names)
        self.model = model
        self.tail_cut = tail_cut
        # the tail sums are taken at the judged run's own cut, where one
        # is given: a cut is a bucket's value, so one request across a
        # bucket edge in the pilot moves it a whole bucket, and the sums
        # are judged for the requests past the cut the run used
        self.weigh_cut = judge_cut if judge_cut is not None else tail_cut
        self.top_k = top_k
        self.sums = {k: np.zeros(H) for k in VECTORS}
        self.tail = {k: np.zeros(H) for k in VECTORS}
        self.hist = np.zeros((S, NUM_BLAME_BUCKETS))
        self.tail_hist = np.zeros((S, NUM_BLAME_BUCKETS))
        self.tail_count = 0.0
        self.slowest = np.zeros(0)
        dev = model.device
        self._edges = torch.as_tensor(BLAME_EDGES[1:-1], device=dev,
                                      dtype=torch.float64)
        self._svc = torch.as_tensor(model.tree.service, device=dev,
                                    dtype=torch.int64)

    def _add(self, name, idx, per_row, tail_w):
        """Add the row sums of (n, len(idx)) charges at hops ``idx``."""
        np.add.at(self.sums[name], idx, per_row.double().sum(0).cpu().numpy())
        if tail_w is not None:
            np.add.at(self.tail[name], idx,
                      (per_row * tail_w[:, None]).double().sum(0)
                      .cpu().numpy())

    def block(self, out) -> None:
        """Fold one block (``Model.block``'s output) into the sums."""
        m = self.model
        lat, wait, sent = out.lat, out.wait, out.sent
        n = lat.shape[0]
        dt = lat.dtype
        dev = lat.device
        cl = out.client_latency
        tail_w = None
        if self.weigh_cut is not None:
            tail_w = (cl.double() >= self.weigh_cut).to(dt)
            self.tail_count += float(tail_w.double().sum())
        w = sent[:, :1].to(dt)
        root = w * m.root_net
        self._add("net", np.array([0]), root, tail_w)
        for d, dp in enumerate(m.depths):
            P = dp.hi - dp.lo
            D = torch.zeros((n, P), dtype=dt, device=dev)
            w_next = None
            if len(dp.call_child):
                c = dp.call_child
                sent_c = sent[:, c].to(dt)
                raw = m.rtt[c] + lat[:, c]
                capped = None
                if dp.call_timeout is not None:
                    capped = raw > dp.call_timeout
                    att = sent_c * torch.minimum(raw, dp.call_timeout)
                else:
                    att = sent_c * raw
                Q, K = len(dp.slot_hop), len(c)
                slots = dp.call_slot.expand(n, -1)
                top = torch.zeros((n, Q), dtype=dt, device=dev)
                top = top.scatter_reduce(1, slots, att, "amax")
                beats = (top >= dp.slot_sleep)[:, dp.call_slot]
                k_idx = torch.arange(K, device=dev)
                cand = torch.where(att == top[:, dp.call_slot], k_idx, K)
                first = torch.full((n, Q), K, dtype=torch.int64, device=dev)
                first = first.scatter_reduce(1, slots, cand, "amin")
                wins = (k_idx == first[:, dp.call_slot]) & beats
                on = w[:, dp.call_hop] * wins.to(dt) * sent_c
                D.index_add_(1, dp.call_hop, on * att)
                nxt = m.depths[d + 1]
                w_next = torch.zeros((n, nxt.hi - nxt.lo), dtype=dt,
                                     device=dev)
                passed = on if capped is None else on * (~capped).to(dt)
                w_next[:, c - nxt.lo] = passed
                kids = c.cpu().numpy()
                self._add("net", kids, passed * m.rtt[c], tail_w)
                if capped is not None:
                    self._add("timeout", kids, on * capped.to(dt) * att,
                              tail_w)
            hops = np.arange(dp.lo, dp.hi)
            sl = slice(dp.lo, dp.hi)
            hop_wait = w * wait[:, sl]
            hop_self = w * (lat[:, sl] - wait[:, sl]) - D
            self._add("crit", hops, w, tail_w)
            self._add("wait", hops, hop_wait, tail_w)
            self._add("self", hops, hop_self, tail_w)
            charge = torch.clamp(hop_wait + hop_self, min=0.0).double()
            bucket = torch.bucketize(charge, self._edges, right=True)
            flat = (self._svc[sl] * NUM_BLAME_BUCKETS + bucket).reshape(-1)
            counts = torch.zeros(self.hist.size, dtype=torch.float64,
                                 device=dev)
            counts.index_add_(0, flat, w.double().reshape(-1))
            self.hist += counts.view(self.hist.shape).cpu().numpy()
            if tail_w is not None:
                counts.zero_()
                counts.index_add_(0, flat,
                                  (w * tail_w[:, None]).double().reshape(-1))
                self.tail_hist += counts.view(self.hist.shape).cpu().numpy()
            w = w_next
        if self.top_k:
            k = min(self.top_k, n)
            block_top = torch.topk(cl.double(), k).values.cpu().numpy()
            self.slowest = np.sort(np.concatenate([self.slowest, block_top])
                                   )[::-1][: self.top_k]

    def result(self) -> Dict[str, np.ndarray]:
        out = {k: v for k, v in self.sums.items()}
        out.update({"tail_" + k: v for k, v in self.tail.items()})
        out.update(hist=self.hist, tail_hist=self.tail_hist,
                   tail_count=np.float64(self.tail_count),
                   tail_cut=np.float64(self.tail_cut
                                       if self.tail_cut is not None
                                       else np.inf),
                   slowest=self.slowest)
        return out
