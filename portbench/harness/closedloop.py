"""The saturated closed-loop traffic mix: what its file holds, the
program's load it makes, and the reference's run of it.

Fortio's ``-qps max`` keeps ``connections`` requests in flight: each
connection sends its next request the moment the last one returns.  A
mix file holds ``"kind": "closed"``, ``"qps": "max"``, its
``connections``, the ``requests`` of one experiment and the ``block``
the program's loop takes them in.  The program's closed loop runs a
whole number of requests a connection in each block, so the block is a
multiple of the connections and the requests a multiple of the block:
the program and the reference then run the same rows.
"""
from __future__ import annotations

from typing import Dict, Optional

KEYS: Dict[str, tuple] = {
    "entry": (str,), "kind": (str,), "qps": (str,), "connections": (int,),
    "requests": (int,), "block": (int,),
}


def traffic(name: str, t: dict, extra: Optional[Dict[str, tuple]] = None
            ) -> dict:
    """``t`` checked as a saturated closed-loop mix with the entry's
    ``extra`` keys; raises ``ValueError`` on a key, type or size it
    cannot run."""
    keys = {**KEYS, **(extra or {})}
    for key, value in t.items():
        if key not in keys:
            raise ValueError(f"traffic {name}: unknown key {key!r}")
        if not isinstance(value, keys[key]) or isinstance(value, bool):
            raise ValueError(f"traffic {name}: {key} has the wrong type")
    missing = [k for k in keys if k not in t]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    if t["kind"] != "closed" or t["qps"] != "max":
        raise ValueError(f"traffic {name}: kind must be 'closed' and qps "
                         f"'max'")
    if min(t["connections"], t["requests"], t["block"]) < 1:
        raise ValueError(f"traffic {name}: sizes must be positive")
    if t["block"] % t["connections"] or t["requests"] % t["block"]:
        raise ValueError(f"traffic {name}: the block must be a multiple "
                         f"of the connections, the requests of the block")
    return t


def load(ctx):
    """The program's ``-qps max`` load of one experiment."""
    return ctx.port.LoadModel(kind="closed", qps=None,
                              connections=ctx.workload["connections"])


def reference(ctx, model, seed: int, path):
    """The reference's run of the experiment at ``path`` under ``seed``:
    ``model`` (a ``reference/sim.Model``) in the closed loop's law, at
    its device and precision (``reference/closed.py``)."""
    from portbench.harness.check import Run
    from portbench.reference.closed import ClosedModel

    w = ctx.workload
    closed = getattr(model, "closed", None)
    if closed is None or closed.connections != w["connections"]:
        closed = ClosedModel(ctx.cell.config, w["connections"],
                             model.device, model.dtype)
        model.closed = closed
    return Run(*closed.run(seed, tuple(path), closed.throughput,
                           w["requests"], w["block"]))
