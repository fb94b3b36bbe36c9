"""The draw source the benchmark hands the program.

The program asks a draw source for one block's random tensors by an
index path and a spec of which tensors it needs (``sim/draws.py`` of the
port: ``draws(index, spec)`` and ``with_seed``).  This source makes each
of them with the benchmark's own generator (``streams.py``) under the
run's seed and the experiment's number, so the reference can make the
same tensors again from the same path.
"""
from __future__ import annotations

from typing import Dict, Tuple

from portbench.harness import streams


def index_path(index) -> Tuple[int, ...]:
    if index is None:
        return ()
    if isinstance(index, tuple):
        return tuple(int(i) for i in index)
    return (int(index),)


def spec_streams(spec) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``name -> (shape, law)`` of every tensor a draw spec asks for."""
    n, h = spec.n, spec.hops
    out = {}
    if spec.need_send:
        out["u_send"] = ((n, h), "uniform")
    if spec.need_err:
        out["u_err"] = ((n, h), "uniform")
    if spec.copula or spec.saturated:
        out["z_h"] = ((n, h), "normal")
    else:
        out["u_wait"] = ((n, h), "uniform")
    if spec.svc is not None:
        law = {"exponential": "exponential", "normal": "normal"}[spec.svc]
        out["svc"] = ((n, h), law)
    if spec.arrivals:
        out["arr"] = ((n,), "exponential")
    if spec.sib_dim:
        out["z_small"] = ((n, spec.sib_dim), "normal")
    if spec.retry_dim:
        out["z_call"] = ((n, spec.retry_dim), "normal")
    if spec.kill_events:
        out["u_kill"] = ((spec.kill_events, n, h), "uniform")
    for flag, name in (("panic", "u_panic"), ("shed", "u_shed"),
                       ("retry", "u_retry"), ("canary", "u_canary")):
        if getattr(spec, flag):
            out[name] = ((n, h), "uniform")
    return out


class BenchSource:
    """Streams of experiment ``experiment`` under ``seed``, as the
    program's ``Draws`` type (``draws_type``)."""

    def __init__(self, seed: int, experiment: Tuple[int, ...], device,
                 draws_type):
        self.seed = int(seed)
        self.experiment = tuple(experiment)
        self.device = device
        self.draws_type = draws_type

    def with_seed(self, seed: int) -> "BenchSource":
        return BenchSource(seed, (), self.device, self.draws_type)

    def draws(self, index, spec):
        path = self.experiment + index_path(index)
        return self.draws_type(**{
            name: streams.stream(self.seed, path, name, shape, law,
                                 self.device)
            for name, (shape, law) in spec_streams(spec).items()
        })
