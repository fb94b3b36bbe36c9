"""Sharded execution over a device mesh: one ``torch.distributed`` rank
per device.

The port of ``isotope_tpu.parallel``.  The simulator scales by sharding
the request stream over a named mesh (``(slice, data, svc)``) and
merging metrics with collectives — sums over the in-host axes, a
reduce-scatter leaving per-service histogram state tiled over ``svc``,
and a final cross-``slice`` sum on multi-host meshes.

The mesh comes from an explicit spec (``--mesh`` / ``$ISOTOPE_MESH``)
or an :class:`EmulatedMesh` that replays any host count on one device.
The mesh serves the solo runs (plain, attributed, recorded and
protected: request-sharded), the fleets and the search brackets (the
member axis spread over the ranks, the member stacks gathered) and the
splitting passes.  Not ported yet (ROADMAP item 11b.5): ``--mesh auto``
and its layout search (``parallel/layout.py``).
"""
from isotope_tpu_torch.parallel.mesh import (
    EmulatedMesh,
    MeshSpec,
    build_mesh,
    default_mesh,
    make_mesh,
    make_multislice_mesh,
    mesh_spec_from_env,
    parse_mesh_spec,
)

#: the sharded runner's names, imported on first use: ``parallel.mesh``
#: (the specs, ``rank_console``) stays free of torch for the CLI
_SHARDED = ("MeshFault", "ShardedSimulator", "ShardedSummary")


def __getattr__(name):
    if name in _SHARDED:
        from isotope_tpu_torch.parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "EmulatedMesh",
    "MeshFault",
    "MeshSpec",
    "build_mesh",
    "default_mesh",
    "make_mesh",
    "make_multislice_mesh",
    "mesh_spec_from_env",
    "parse_mesh_spec",
    "ShardedSimulator",
    "ShardedSummary",
]
