"""Compiled-program dataclasses (host-side, NumPy).

The compiled form has two parts:

- ``ServiceTable``: per-service parameter arrays (the analogue of the
  per-service Deployment fields the reference renders,
  isotope/convert/pkg/kubernetes/kubernetes.go:189-270).
- the unrolled **hop tree**: every request entering the entrypoint walks a
  statically known call tree (the recursion of
  isotope/service/pkg/srv/handler.go:66-76 + executable.go:94-179 over a
  fixed topology).  Each node of that tree is a *hop* — one service
  invocation.  Hops are laid out level-by-level (BFS order) so the engine
  can sweep depth levels with static shapes.

Everything here is plain NumPy; the engine moves it on-device once.
A copy of ``isotope_tpu.compiler.program`` (without the executable-cache
signature helpers), plus :func:`compiled_to_arrays` /
:func:`compiled_from_arrays`, which carry compiled tables across
packages as plain arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ServiceTable:
    """Per-service parameters, indexed by a dense service id.

    Mirrors ``svc.Service`` (isotope/convert/pkg/graph/svc/service.go:25-51)
    minus the deployment-only fields (RBAC policy counts live in the k8s
    converter, not the simulator).
    """

    names: Tuple[str, ...]
    replicas: np.ndarray       # (S,) int32  — NumReplicas => queueing servers
    error_rate: np.ndarray     # (S,) f32    — P(injected 500) in [0, 1]
    response_size: np.ndarray  # (S,) f32    — bytes
    is_entrypoint: np.ndarray  # (S,) bool
    # multicluster placement (perf/load/templates/service-graph.gen.yaml
    # :1-3): dense cluster id per service; edges between different ids
    # pay the NetworkModel's cross-cluster class.  A single-cluster
    # topology has all-zero ids.
    cluster: np.ndarray = None          # (S,) int32
    cluster_names: Tuple[str, ...] = ("",)

    def __post_init__(self):
        if self.cluster is None:
            object.__setattr__(
                self, "cluster", np.zeros(len(self.names), np.int32)
            )

    @property
    def num_services(self) -> int:
        return len(self.names)

    @property
    def num_clusters(self) -> int:
        return len(self.cluster_names)


@dataclasses.dataclass(frozen=True)
class HopLevel:
    """All hops at one depth of the unrolled call tree.

    ``Pmax`` is the graph-wide maximum script length; every hop's script is
    padded to it.  Step slots hold either a fixed base duration (sleep
    commands — including the max over sleeps inside a concurrent group,
    which run in parallel with the group's calls,
    srv/executable.go:148-179) or a join over child hops.

    Child hops (depth+1, in that level's local order) are grouped two
    ways:

    - per **call**: a call site in a parent's script owns ``retries+1``
      consecutive attempt hops; ``att_child[a, k]`` is the local child
      index of call k's attempt a (``att_valid`` masks shorter chains).
      Attempt durations sum serially; the call's outcome is the last
      attempt's.
    - per **step**: ``call_seg`` maps each call to the flat
      ``parent_local * Pmax + step`` slot so a scatter-max computes the
      per-step join — the vectorized form of the reference's WaitGroup
      (srv/executable.go:171-175); sequential steps have one call each.
    """

    hop_ids: np.ndarray        # (L,) int32 — global hop ids, level-local order
    service: np.ndarray        # (L,) int32
    step_is_real: np.ndarray   # (L, Pmax) bool — slot holds an actual step
    step_base: np.ndarray      # (L, Pmax) f32 — sleep seconds (0 for calls)
    child_ids: np.ndarray      # (C,) int32 — global hop ids at depth+1
    child_seg: np.ndarray      # (C,) int32 — parent_local * Pmax + step
    # -- call tables (K = number of call sites at this level) -------------
    call_seg: np.ndarray       # (K,) int32 — parent_local * Pmax + step
    call_step: np.ndarray      # (K,) int32
    call_timeout: np.ndarray   # (K,) f32 — +inf when none
    att_child: np.ndarray      # (maxA, K) int32 — local child idx (or C)
    att_valid: np.ndarray      # (maxA, K) bool

    @property
    def num_hops(self) -> int:
        return len(self.hop_ids)

    @property
    def num_children(self) -> int:
        return len(self.child_ids)

    @property
    def num_calls(self) -> int:
        return len(self.call_seg)

    @property
    def max_attempts(self) -> int:
        return self.att_child.shape[0]


@dataclasses.dataclass(frozen=True)
class CompiledGraph:
    """A ServiceGraph lowered for vectorized simulation."""

    services: ServiceTable
    entry_service: int

    # -- flat hop arrays (H hops, BFS order; hop 0 is the root) ------------
    hop_service: np.ndarray    # (H,) int32
    hop_parent: np.ndarray     # (H,) int32 — -1 for the root
    hop_depth: np.ndarray      # (H,) int32
    hop_step: np.ndarray       # (H,) int32 — step index in parent's script
    hop_attempt: np.ndarray    # (H,) int32 — retry attempt index (0 first)
    hop_send_prob: np.ndarray  # (H,) f32 — this hop's own coin, [0, 1]
    hop_request_size: np.ndarray  # (H,) f32 — bytes sent to the hop
    # P(hop is reached) = prod over path of send_prob * (1 - parent error
    # rate); drives offered-load estimates for the queueing model.
    hop_reach: np.ndarray      # (H,) f64

    levels: Tuple[HopLevel, ...]
    max_steps: int             # Pmax

    @property
    def num_hops(self) -> int:
        return len(self.hop_service)

    @property
    def num_services(self) -> int:
        return self.services.num_services

    @property
    def depth(self) -> int:
        return len(self.levels)

    def expected_visits(self, hop_multiplier=None) -> np.ndarray:
        """Expected hops per root request, per service (f64, shape (S,)).

        Offered load at service s under root rate R is ``R *
        expected_visits()[s]`` — the simulator's replacement for measuring
        per-service request rates off live Prometheus counters
        (service/pkg/srv/prometheus/handler.go:37-49).  ``hop_multiplier``
        (shape (H,)) scales each hop's static reach — e.g. time-averaged
        traffic-split weights.
        """
        weights = self.hop_reach
        if hop_multiplier is not None:
            weights = weights * hop_multiplier
        return np.bincount(
            self.hop_service,
            weights=weights,
            minlength=self.num_services,
        )


def hop_wire_times(compiled: "CompiledGraph", net) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """Per-hop one-way (request, response) wire times, cluster-aware.

    Intra-cluster edges pay ``base_latency_s`` + bytes/bandwidth; edges
    whose caller and callee sit in different clusters additionally pay
    ``cross_cluster_latency_s`` per direction (the egress+ingress
    gateway traversal of the reference's multicluster split,
    perf/load/common.sh:36-42) and ride
    ``cross_cluster_bytes_per_second`` when set.  The client is
    co-located with the entrypoint (the reference deploys one
    loadclient per namespace), so hop 0 is never cross-cluster; the
    entry edge's ingress-gateway tax (``entry_extra_latency_s``) is
    applied here as before.
    """
    hs = compiled.hop_service
    resp = compiled.services.response_size.astype(np.float64)
    req = compiled.hop_request_size.astype(np.float64)
    cl = compiled.services.cluster
    cross = np.zeros(compiled.num_hops, bool)
    if compiled.services.num_clusters > 1:
        parent = compiled.hop_parent
        cross[1:] = cl[hs[parent[1:]]] != cl[hs[1:]]
    extra = float(getattr(net, "cross_cluster_latency_s", 0.0))
    cross_bps = getattr(net, "cross_cluster_bytes_per_second", None)
    bps = np.where(
        cross, cross_bps if cross_bps else net.bytes_per_second,
        net.bytes_per_second,
    )
    lat = net.base_latency_s + np.where(cross, extra, 0.0)
    net_out = lat + req / bps
    net_back = lat + resp[hs] / bps
    net_out[0] += net.entry_extra_latency_s
    net_back[0] += net.entry_extra_latency_s
    return net_out, net_back


# -- carrying compiled tables across packages --------------------------------

_TABLE_FIELDS = (
    "replicas", "error_rate", "response_size", "is_entrypoint", "cluster",
)
_HOP_FIELDS = (
    "hop_service", "hop_parent", "hop_depth", "hop_step", "hop_attempt",
    "hop_send_prob", "hop_request_size", "hop_reach",
)
_LEVEL_FIELDS = tuple(f.name for f in dataclasses.fields(HopLevel))


def compiled_to_arrays(compiled) -> "dict[str, np.ndarray]":
    """Flatten a compiled graph into named numpy arrays.

    Reads attributes only, so it accepts this package's
    :class:`CompiledGraph` and any object of the same shape (the JAX
    package's compiled graph included).  Keys: ``services.<field>``,
    ``entry_service``, ``max_steps``, the ``hop_*`` arrays and
    ``levels.<d>.<field>``.  :func:`compiled_from_arrays` inverts it.
    """
    t = compiled.services
    out = {
        "services.names": np.asarray(t.names, dtype=str),
        "services.cluster_names": np.asarray(t.cluster_names, dtype=str),
        "entry_service": np.asarray(compiled.entry_service, np.int64),
        "max_steps": np.asarray(compiled.max_steps, np.int64),
        "num_levels": np.asarray(len(compiled.levels), np.int64),
    }
    for name in _TABLE_FIELDS:
        out[f"services.{name}"] = np.asarray(getattr(t, name))
    for name in _HOP_FIELDS:
        out[name] = np.asarray(getattr(compiled, name))
    for d, lvl in enumerate(compiled.levels):
        for name in _LEVEL_FIELDS:
            out[f"levels.{d}.{name}"] = np.asarray(getattr(lvl, name))
    return out


def compiled_from_arrays(fields: "dict[str, np.ndarray]") -> CompiledGraph:
    """Build a :class:`CompiledGraph` from :func:`compiled_to_arrays`
    output — the compiled tables of another package (the JAX reference)
    carried across as plain arrays, so both engines run on exactly the
    same program."""
    table = ServiceTable(
        names=tuple(str(s) for s in fields["services.names"]),
        cluster_names=tuple(
            str(s) for s in fields["services.cluster_names"]
        ),
        **{
            name: np.asarray(fields[f"services.{name}"])
            for name in _TABLE_FIELDS
        },
    )
    levels = tuple(
        HopLevel(**{
            name: np.asarray(fields[f"levels.{d}.{name}"])
            for name in _LEVEL_FIELDS
        })
        for d in range(int(fields["num_levels"]))
    )
    return CompiledGraph(
        services=table,
        entry_service=int(fields["entry_service"]),
        levels=levels,
        max_steps=int(fields["max_steps"]),
        **{name: np.asarray(fields[name]) for name in _HOP_FIELDS},
    )
