"""The open-loop traffic mix: what its file holds, the program's load
it makes, and the reference's run of it.

A mix file (``traffic/<name>.json``) names the entry that drives the
program and the parameters of one simulated experiment.  An open loop
holds ``"kind": "open"``, its rate ``qps`` (Poisson arrivals), the
``requests`` of one experiment and the ``block`` the program's loop
takes them in (blocks of ``min(block, requests)``, as many as cover the
requests).  An entry that takes more keys names them; a mix of another
kind (a closed loop, a chaos window) is a module of its own beside this
one, used by the entries that drive it.
"""
from __future__ import annotations

from typing import Dict, Optional

KEYS: Dict[str, tuple] = {
    "entry": (str,), "kind": (str,), "qps": (int, float),
    "requests": (int,), "block": (int,),
}


def traffic(name: str, t: dict, extra: Optional[Dict[str, tuple]] = None
            ) -> dict:
    """``t`` checked as an open-loop mix with the entry's ``extra`` keys;
    raises ``ValueError`` on a key, type or size it cannot run."""
    keys = {**KEYS, **(extra or {})}
    for key, value in t.items():
        if key not in keys:
            raise ValueError(f"traffic {name}: unknown key {key!r}")
        if not isinstance(value, keys[key]) or isinstance(value, bool):
            raise ValueError(f"traffic {name}: {key} has the wrong type")
    missing = [k for k in keys if k not in t]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    if t["kind"] != "open":
        raise ValueError(f"traffic {name}: kind must be 'open'")
    if t["qps"] <= 0 or min(t["requests"], t["block"]) < 1:
        raise ValueError(f"traffic {name}: sizes must be positive")
    return t


def load(ctx):
    """The program's open-loop load of one experiment."""
    w = ctx.workload
    return ctx.port.LoadModel(kind="open", qps=float(w["qps"]),
                              duration_s=w["requests"] / w["qps"])


def reference(ctx, model, seed: int, path, blame: Optional[dict] = None):
    """The reference's run of the experiment at ``path`` (experiment
    number and member prefix) under ``seed``."""
    from portbench.harness.check import Run

    w = ctx.workload
    return Run(*model.run(seed, tuple(path), float(w["qps"]),
                          w["requests"], w["block"], blame=blame))
