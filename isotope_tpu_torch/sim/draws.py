"""Random streams of one simulated block, and where they come from.

The engine consumes a fixed set of random tensors per block of ``n``
requests over ``H`` hops.  Which of them exist is static — it follows
from the topology and the parameters (the reference's static coin
elimination and copula dimensions, ``isotope_tpu/sim/engine.py``
4761-4880, arrivals at 4885, service times at 4639-4660) — and is
described by a :class:`DrawSpec` that the engine builds.

A *draw source* maps an index and a spec to one :class:`Draws`.  The
indices are the integers the JAX engine folds into its key: ``None``
for the run's own key, ``i`` for closed-loop pilot ``i`` and
``1_000_000 + b`` for summary block ``b`` (engine.py:2066, 4543); a
tuple of integers folds each in turn.  An ungraceful kill event ``e``
(``ChaosEvent(drain=False)``) draws its (N, H) reset coins from the
block's index extended by ``KILL_INDEX_BASE + e`` (engine.py:6104),
and a run with panic routing under chaos (``sim/lb.py``) its (N, H)
panic coins from the index extended by ``PANIC_INDEX``
(engine.py:5275-5288).
``source.with_seed(seed)`` is a source of the same kind at another root
seed: the saturated closed
loop's fixed-point pilots draw from ``with_seed(SAT_PILOT_SEED)`` at
index ``(it, i)`` whatever the run's seed (engine.py:1722-1750,
1840-1850).  :class:`TorchDraws` draws every index from its own seeded
``torch.Generator``; tests hand the engine the JAX engine's own draws
through a source of the same shape, which is how the port is held to
the reference draw for draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

#: a draw index: the run's own (None), one fold-in, or a path of them
Index = Union[None, int, Tuple[int, ...]]


def index_path(index: Index) -> Tuple[int, ...]:
    """The fold-ins an index stands for, in order."""
    if index is None:
        return ()
    if isinstance(index, tuple):
        return index
    return (index,)

#: block-key offset of ``run_summary`` (the reference's fold_in salt)
BLOCK_INDEX_BASE = 1_000_000

#: fold-in offset of the ungraceful-kill reset coins of event ``e``
KILL_INDEX_BASE = 9_990_000

#: fold-in of the lb panic-routing coins
PANIC_INDEX = 660_001

#: root seed of the saturated closed loop's pilot runs (the reference's
#: ``PRNGKey(20_260_730)``): fixed, so the solved throughput is a
#: property of the topology, not of the run's seed
SAT_PILOT_SEED = 20_260_730

SVC_EXPONENTIAL = "exponential"  # unit exponentials (exponential, pareto)
SVC_NORMAL = "normal"            # unit normals (lognormal)


class DrawSpec(NamedTuple):
    """Which random tensors one block consumes, and their shapes."""

    n: int                # requests in the block
    hops: int             # H
    need_send: bool       # u_send: some call has a send probability < 1
    need_err: bool        # u_err: some hop has a nonzero error rate
    copula: bool          # a copula: z_h (+ z_small / z_call), 7 streams
    sib_dim: int          # columns of z_small (0: no sibling copula)
    retry_dim: int        # columns of z_call (0: no retry copula)
    svc: Optional[str]    # SVC_EXPONENTIAL | SVC_NORMAL | None
    arrivals: bool        # arr: open-loop inter-arrival draws
    # the saturated closed loop's wait law takes normals: z_h instead
    # of u_wait even without a copula
    saturated: bool = False
    # u_kill: one (N, H) uniform per ungraceful kill event
    kill_events: int = 0
    # u_panic: the lb panic-routing coins (panic threshold under chaos)
    panic: bool = False

    @property
    def normal_wait(self) -> bool:
        """z_h is drawn (and u_wait is not)."""
        return self.copula or self.saturated


class Draws(NamedTuple):
    """One block's random tensors; ``None`` where the engine draws none."""

    u_send: Optional[torch.Tensor] = None   # (N, H) U[0, 1)
    u_err: Optional[torch.Tensor] = None    # (N, H) U[0, 1)
    z_h: Optional[torch.Tensor] = None      # (N, H) N(0, 1), own term
    z_small: Optional[torch.Tensor] = None  # (N, sib_dim) N(0, 1)
    z_call: Optional[torch.Tensor] = None   # (N, retry_dim) N(0, 1)
    u_wait: Optional[torch.Tensor] = None   # (N, H) U[0, 1), no copula
    svc: Optional[torch.Tensor] = None      # (N, H) unit exp. or normal
    arr: Optional[torch.Tensor] = None      # (N,) unit exponentials
    u_kill: Optional[torch.Tensor] = None   # (E, N, H) U[0, 1)
    u_panic: Optional[torch.Tensor] = None  # (N, H) U[0, 1)

    def to(self, device) -> "Draws":
        """The same draws as float32 tensors on ``device``."""
        return Draws(*(
            None if t is None
            else torch.as_tensor(t).to(device=device, dtype=torch.float32)
            for t in self
        ))

    def check(self, spec: DrawSpec) -> None:
        """Raise unless the draws have exactly the spec's fields/shapes."""
        n, h = spec.n, spec.hops
        want = {
            "u_send": (n, h) if spec.need_send else None,
            "u_err": (n, h) if spec.need_err else None,
            "z_h": (n, h) if spec.normal_wait else None,
            "z_small": (n, spec.sib_dim) if spec.sib_dim else None,
            "z_call": (n, spec.retry_dim) if spec.retry_dim else None,
            "u_wait": None if spec.normal_wait else (n, h),
            "svc": (n, h) if spec.svc is not None else None,
            "arr": (n,) if spec.arrivals else None,
            "u_kill": (
                (spec.kill_events, n, h) if spec.kill_events else None
            ),
            "u_panic": (n, h) if spec.panic else None,
        }
        for name, shape in want.items():
            t = getattr(self, name)
            got = None if t is None else tuple(t.shape)
            if got != shape:
                raise ValueError(
                    f"draws.{name}: expected shape {shape}, got {got}"
                )


class TorchDraws:
    """Draw source backed by ``torch.Generator``s on one device.

    Index ``i`` of seed ``s`` draws from a generator seeded by numpy's
    ``SeedSequence([s, i])`` (``[s]`` for the run's own index ``None``,
    ``[s, i, j]`` for the index path ``(i, j)``), so every block and
    pilot has an independent, reproducible stream.
    """

    def __init__(self, seed: int, device="cuda"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def with_seed(self, seed: int) -> "TorchDraws":
        return TorchDraws(seed, self.device)

    def generator(self, index: Index) -> torch.Generator:
        entropy = [self.seed] + [int(i) for i in index_path(index)]
        state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
        g = torch.Generator(device=self.device)
        g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        return g

    def draws(self, index: Index, spec: DrawSpec) -> Draws:
        g = self.generator(index)
        n, h = spec.n, spec.hops
        kw = dict(generator=g, device=self.device, dtype=torch.float32)

        def uniform(*shape):
            return torch.rand(shape, **kw)

        def normal(*shape):
            return torch.randn(shape, **kw)

        def exponential(*shape):
            return torch.empty(
                shape, device=self.device, dtype=torch.float32
            ).exponential_(generator=g)

        out = Draws(
            u_send=uniform(n, h) if spec.need_send else None,
            u_err=uniform(n, h) if spec.need_err else None,
            z_h=normal(n, h) if spec.normal_wait else None,
            u_wait=None if spec.normal_wait else uniform(n, h),
        )
        svc = None
        if spec.svc == SVC_EXPONENTIAL:
            svc = exponential(n, h)
        elif spec.svc == SVC_NORMAL:
            svc = normal(n, h)
        return out._replace(
            svc=svc,
            arr=exponential(n) if spec.arrivals else None,
            z_small=normal(n, spec.sib_dim) if spec.sib_dim else None,
            z_call=normal(n, spec.retry_dim) if spec.retry_dim else None,
            u_kill=(
                torch.stack([
                    self.folded_uniform(index, KILL_INDEX_BASE + e, n, h)
                    for e in range(spec.kill_events)
                ])
                if spec.kill_events else None
            ),
            u_panic=(
                self.folded_uniform(index, PANIC_INDEX, n, h)
                if spec.panic else None
            ),
        )

    def folded_uniform(self, index: Index, fold: int, n: int, h: int):
        """(n, h) uniforms of index ``index`` extended by ``fold``."""
        g = self.generator(index_path(index) + (fold,))
        return torch.rand((n, h), generator=g, device=self.device,
                          dtype=torch.float32)
