"""One experiment is one ``Simulator.run_attributed(tail=True)``: a
simulated Fortio run whose block loop also reduces critical-path blame,
its tail cut estimated inside the call by the program's own pilot (as
``simulate --attribution tail`` does), read back with the run's
summary."""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import check, openloop
from portbench.harness.openloop import load  # noqa: F401

#: the comparison also reads the run's blame
CHECKS = check.BLAME
#: the program's tail pilot draws under this index (``fold_in(key,
#: 777_000)`` of the reference engine): 8,192 requests at most
PILOT_INDEX = 777_000
PILOT_REQUESTS = 8_192


def traffic(name, t):
    t = openloop.traffic(name, t, {"top_k": (int,),
                                   "tail_quantile": (float,)})
    if t["top_k"] < 1 or not 0 < t["tail_quantile"] < 1:
        raise ValueError(f"traffic {name}: bad top_k or tail_quantile")
    return t


def params(ctx) -> dict:
    w = ctx.workload
    return {"attribution": True, "attribution_top_k": w["top_k"],
            "attribution_tail_quantile": w["tail_quantile"]}


def _run(ctx, source, requests):
    w = ctx.workload
    summary, blame = ctx.sim.run_attributed(
        ctx.load(), requests, source, block_size=w["block"], tail=True,
    )
    return ctx.host_runs(summary)[0]._replace(blame=host_blame(blame))


def host_blame(a) -> dict:
    """The attribution summary in one host read."""
    parts = {
        "crit": a.crit_count, "wait": a.wait_blame, "self": a.self_blame,
        "net": a.net_blame, "timeout": a.timeout_blame,
        "tail_crit": a.tail_crit_count, "tail_wait": a.tail_wait_blame,
        "tail_self": a.tail_self_blame, "tail_net": a.tail_net_blame,
        "tail_timeout": a.tail_timeout_blame, "hist": a.hist,
        "tail_hist": a.tail_hist, "tail_count": a.tail_count,
        "tail_cut": a.tail_cut, "slowest": a.exemplars.latency,
    }
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in parts.values()]).cpu().numpy()
    out, i = {}, 0
    for k, t in parts.items():
        out[k] = flat[i:i + t.numel()].reshape(tuple(t.shape))
        i += t.numel()
    out["slowest"] = np.sort(out["slowest"])[::-1]
    return out


def warm(ctx) -> None:
    """The cell's block shape and the pilot's, a few blocks."""
    w = ctx.workload
    _run(ctx, ctx.warm_source(),
         w.get("warmup_requests", 2 * w["block"]))


def run(ctx, source):
    return [_run(ctx, source, ctx.workload["requests"])]


def prefixes(ctx):
    return [()]


def blocks(ctx) -> int:
    w = ctx.workload
    return -(-w["requests"] // w["block"])


def reference(ctx, model, seed, path, judged=None):
    """The reference's attributed run; ``judged`` is the run it judges,
    whose tail cut (an output the comparison reads, as it reads the
    judged latencies) places the tail sums, so that they compare the
    same requests; the cut itself is held by ``tail_cut_gap``."""
    w = ctx.workload
    blame = {"top_k": w["top_k"], "tail_quantile": w["tail_quantile"],
             "pilot_index": PILOT_INDEX, "pilot_requests": PILOT_REQUESTS}
    if judged is not None and judged.blame is not None:
        blame["judge_cut"] = float(judged.blame["tail_cut"])
    return openloop.reference(ctx, model, seed, path, blame)


def gaps(prog, ref) -> dict:
    return check.blame_gaps(prog.blame, ref.blame)
