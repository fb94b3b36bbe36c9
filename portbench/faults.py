"""Faults planted under the program's timed path, to see the comparison
fail: a block that hands back a state it did not advance, half of each
block left out of its summary (the mean over the rest), one answer in
eight made 1.5 times late where it is produced, and, where a run
estimates a tail cut, the cut estimated at the wrong quantile.  Each is
a context manager that patches the program while it is open.  Used by
the tests and by ``calibrate.py --fault-seeds``; never by a benchmark
run."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged():
    """Every block hands back the first block its simulator ever made."""
    from isotope_tpu_torch.sim import engine

    real = engine.Simulator._simulate_core
    first = {}

    def core(self, *a, **k):
        out = real(self, *a, **k)
        return first.setdefault(id(self), out)

    with _patched(engine.Simulator, "_simulate_core", core):
        yield


def _halve(res):
    rows = res.client_latency.shape[0]
    return res._replace(**{
        f: getattr(res, f)[: rows // 2] for f in res._fields
        if isinstance(getattr(res, f), torch.Tensor)
        and getattr(res, f).dim() and getattr(res, f).shape[0] == rows
    })


@contextlib.contextmanager
def half():
    """Each block's summary takes the first half of its rows."""
    from isotope_tpu_torch.sim import summary

    real, real_m = summary.summarize, summary.summarize_members
    with _patched(summary, "summarize",
                  lambda res, *a, **k: real(_halve(res), *a, **k)), \
            _patched(summary, "summarize_members",
                     lambda res, m, *a, **k: real_m(_halve(res),
                                                    max(m // 2, 1), *a, **k)):
        yield


@contextlib.contextmanager
def altered():
    """One request in eight of every block answers 1.5 times late."""
    from isotope_tpu_torch.sim import engine

    real = engine.Simulator._simulate_core

    def core(self, *a, **k):
        res, t_end, conn_end = real(self, *a, **k)
        lat = res.client_latency.clone()
        lat[::8] *= 1.5
        return res._replace(client_latency=lat), t_end, conn_end

    with _patched(engine.Simulator, "_simulate_core", core):
        yield


@contextlib.contextmanager
def cut():
    """An attributed run's tail cut estimated a point of quantile low
    (p98 where the run asks p99)."""
    from isotope_tpu_torch.sim import engine

    real = engine.Simulator.estimate_tail_cut

    def estimate(self, *a, quantile=None, **k):
        q = quantile if quantile is not None else (
            self.params.attribution_tail_quantile)
        return real(self, *a, quantile=q - 0.01, **k)

    with _patched(engine.Simulator, "estimate_tail_cut", estimate):
        yield


#: faults of every timed path
FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
#: faults of a run that estimates a tail cut (its traffic's
#: ``tail_quantile``)
TAIL_FAULTS = {"cut": cut}


def planted(workload: dict) -> dict:
    """The faults a cell's timed path can have."""
    return {**FAULTS, **(TAIL_FAULTS if "tail_quantile" in workload
                         else {})}
