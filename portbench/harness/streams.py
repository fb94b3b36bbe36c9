"""The benchmark's random streams, made from the seed on the device.

Every stream of every block is its own ``torch.Generator``, seeded from
numpy's ``SeedSequence`` over ``(seed, experiment, index path, stream)``,
so the harness hands the program a block's streams and the reference
makes the very same tensors again later from the same path.  Plain
torch and numpy only: the reference imports this module.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

#: stream name -> (code, law); ``svc`` takes the service-time law's own
STREAMS = {
    "u_send": (1, "uniform"),
    "u_err": (2, "uniform"),
    "z_h": (3, "normal"),
    "z_small": (4, "normal"),
    "z_call": (5, "normal"),
    "u_wait": (6, "uniform"),
    "svc": (7, None),
    "arr": (8, "exponential"),
    "u_kill": (9, "uniform"),
    "u_panic": (10, "uniform"),
    "u_shed": (11, "uniform"),
    "u_retry": (12, "uniform"),
    "u_canary": (13, "uniform"),
}
LAWS = ("uniform", "normal", "exponential")


def generator(seed: int, path: Sequence[int], name: str,
              device) -> torch.Generator:
    """The generator of stream ``name`` at ``path`` under ``seed``."""
    entropy = [int(seed)] + [int(i) for i in path] + [STREAMS[name][0]]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def stream(seed: int, path: Sequence[int], name: str,
           shape: Tuple[int, ...], law: str, device) -> torch.Tensor:
    """One float32 stream: U[0, 1), N(0, 1) or unit exponentials."""
    if law not in LAWS:
        raise ValueError(f"unknown law {law!r}")
    g = generator(seed, path, name, device)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    if law == "uniform":
        return torch.rand(shape, **kw)
    if law == "normal":
        return torch.randn(shape, **kw)
    return torch.empty(shape, device=device,
                       dtype=torch.float32).exponential_(generator=g)
