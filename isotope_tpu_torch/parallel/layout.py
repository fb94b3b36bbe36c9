"""The mesh-layout search behind ``--mesh auto``.

The port of ``isotope_tpu.parallel.layout``.  Every shard simulates a
disjoint slice of the request stream, so the compute spreads over the
whole mesh whatever its factorization; what tells layouts apart is the
summary merge's communication (``analysis/costmodel.comm_table`` prices
each collective with the in-host and between-hosts link constants) and
the padding of the service axis:

- a wider ``svc`` axis turns the per-service histograms' all-reduce
  into a cheaper reduce-scatter and shrinks what the link between hosts
  carries (that sum runs last, on the scattered tiles), but pads ``S``
  up to a multiple of ``svc``;
- a ``slice`` axis (between hosts) is pure cost on one host: the search
  proposes one only when the caller says hosts exist (``max_slices``),
  and then pins it to the host count (a host is a slice; any other
  factor would run in-host axes between hosts).

The search is exhaustive over the divisor triples of the device count
(a few dozen candidates) and deterministic: ties break toward fewer
slices, then a narrower ``svc``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from isotope_tpu_torch.parallel.mesh import MeshSpec


@dataclasses.dataclass(frozen=True)
class LayoutScore:
    """One scored candidate factorization."""

    spec: MeshSpec
    score_s: float            # modeled merge time a run (lower is better)
    comm_rows: tuple          # the costmodel.comm_table rows, as items
    pad_fraction: float       # the svc padding, (s_pad - S) / S

    def to_dict(self) -> dict:
        return {
            "mesh": self.spec.describe(),
            "score_s": self.score_s,
            "pad_fraction": self.pad_fraction,
            "comm": [dict(r) for r in self.comm_rows],
        }


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_specs(
    n_devices: int,
    num_services: int,
    max_slices: int = 1,
) -> List[MeshSpec]:
    """Every valid ``{slice, data, svc}`` factorization of the devices.

    The product equals ``n_devices`` (never more or fewer ranks than
    the world has), ``svc`` is never wider than the service count (a
    shard owning only padding does no metric work), and with
    ``max_slices > 1`` every candidate has exactly ``max_slices``
    slices: hosts are slices, so a flat mesh over several hosts would
    run its ``data`` / ``svc`` collectives between hosts while the
    rows priced them inside one.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if max_slices > 1 and n_devices % max_slices:
        raise ValueError(
            f"{n_devices} devices do not divide over {max_slices} "
            f"hosts/slices (a slice must own whole hosts)"
        )
    slices = max_slices if max_slices > 1 else 1
    per_slice = n_devices // slices
    return [
        MeshSpec(data=per_slice // svc, svc=svc, slices=slices)
        for svc in _divisors(per_slice)
        if svc <= max(num_services, 1)
    ]


def score_layout(
    spec: MeshSpec,
    num_services: int,
    num_edges: Optional[int] = None,
    num_merges: int = 1,
) -> LayoutScore:
    """Price one candidate: its merge's cost rows plus the svc
    padding."""
    from isotope_tpu_torch.analysis import costmodel

    rows = costmodel.comm_table(
        num_services,
        data=spec.data,
        svc=spec.svc,
        slices=spec.slices,
        num_edges=num_edges,
        num_merges=num_merges,
    )
    s = max(num_services, 1)
    s_pad = -(-s // spec.svc) * spec.svc
    pad = (s_pad - s) / s
    # the padding inflates every per-service accumulation of a run, not
    # only the merge's wire time: charged as that share of the scattered
    # payload at the in-host rate, once a merge
    pad_s = (
        pad
        * costmodel.summary_bytes(num_services, num_edges)["scattered"]
        / costmodel.IN_HOST_BANDWIDTH_BYTES_S
        * max(num_merges, 1)
    )
    return LayoutScore(
        spec=spec,
        score_s=sum(r["time_s"] for r in rows) + pad_s,
        comm_rows=tuple(tuple(r.items()) for r in rows),
        pad_fraction=pad,
    )


def choose_layout(
    n_devices: int,
    num_services: int,
    num_edges: Optional[int] = None,
    max_slices: int = 1,
    num_merges: int = 1,
) -> LayoutScore:
    """The best-scoring factorization for one topology; among equal
    scores, fewer slices and then a narrower ``svc`` axis (the closest
    to the all-data default)."""
    candidates = [
        score_layout(spec, num_services, num_edges, num_merges)
        for spec in enumerate_specs(n_devices, num_services, max_slices)
    ]
    return min(
        candidates,
        key=lambda c: (c.score_s, c.spec.slices, c.spec.svc),
    )
