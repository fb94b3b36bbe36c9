"""Mesh construction over ``torch.distributed``: one rank per device.

The port of ``isotope_tpu.parallel.mesh``.  Axis conventions:

- ``slice`` (optional, outermost): multi-host scale-out — collectives
  crossing it ride the network between hosts.  Pure
  request-parallelism: per-request work never crosses it, only the
  O(buckets) summary reduction does.  It does NOT model the simulated
  system's cluster split (that is per-service ``cluster`` placement and
  the cross-cluster NetworkModel edge class);
- ``data``: shards the request batch within a host (every rank
  simulates a disjoint slice of the arrival stream — the analogue of
  running more Fortio clients);
- ``svc``: shards per-service metric state.  Compute for all hops is
  still data-parallel; cross-``svc`` traffic is the metrics
  reduce-scatter.

A mesh can come from three places, in priority order (runner/run.py):

1. an explicit spec — CLI ``--mesh`` or env ``$ISOTOPE_MESH`` —
   positional ``"DATAxSVC[xSLICE]"`` (e.g. ``4x2`` or ``2x2x2``) or
   named ``"data=4,svc=2,slice=1"`` (``"auto"`` parses; the layout
   search is not ported and the runner refuses it);
2. the legacy ``[sim] mesh_data`` / ``mesh_svc`` TOML keys;
3. every rank of the world on the data axis.

:func:`build_mesh` materializes a spec as a named
``torch.distributed.device_mesh.DeviceMesh`` over the initialized world
(``torchrun`` sets it up; a world of one needs no launcher).  Global
rank ``r`` is the shard ``r``: row-major over ``MeshSpec.axis_names``,
the reference's shard index (``sum(axis_index(a) * stride(a))``), on
which every shard's draws depend.  The backend follows the device: the
card takes NCCL (rank ``r`` on ``cuda:$LOCAL_RANK``), the CPU ``gloo``.

:class:`EmulatedMesh` carries a mesh *shape* with no ranks behind it:
``ShardedSimulator`` accepts one and replays the full shard program
shard by shard on one device (``run_emulated``), so any host count is
testable on one card or one CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os
import sys
from typing import Dict, Optional, Tuple, Union

from isotope_tpu_torch.models.errors import config_path

SLICE_AXIS = "slice"
DATA_AXIS = "data"
SVC_AXIS = "svc"

#: valid axis names for named ``--mesh`` specs, in mesh (outer->inner)
#: order
AXIS_ORDER = (SLICE_AXIS, DATA_AXIS, SVC_AXIS)

ENV_MESH = "ISOTOPE_MESH"

#: default timeout of every process group a mesh builds (seconds): a
#: rank that dies leaves its peers blocked in their next collective for
#: at most this long; ``$ISOTOPE_MESH_TIMEOUT`` (seconds) overrides it
DEFAULT_TIMEOUT_S = 600.0
ENV_MESH_TIMEOUT = "ISOTOPE_MESH_TIMEOUT"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """An axis factorization — the logical mesh before devices exist.

    ``slices`` is the multi-host axis; ``data`` and ``svc`` stay inside
    a host.  ``slices == 1`` collapses to the plain ``(data, svc)``
    mesh (no slice axis is materialized).
    """

    data: int
    svc: int = 1
    slices: int = 1

    def __post_init__(self):
        for name, v in (("data", self.data), ("svc", self.svc),
                        ("slice", self.slices)):
            if int(v) < 1:
                with config_path(f"mesh.{name}"):
                    raise ValueError(
                        f"axis size must be >= 1, got {v}"
                    )

    @property
    def size(self) -> int:
        return self.slices * self.data * self.svc

    @property
    def axis_names(self):
        if self.slices > 1:
            return (SLICE_AXIS, DATA_AXIS, SVC_AXIS)
        return (DATA_AXIS, SVC_AXIS)

    @property
    def shape(self) -> dict:
        if self.slices > 1:
            return {SLICE_AXIS: self.slices, DATA_AXIS: self.data,
                    SVC_AXIS: self.svc}
        return {DATA_AXIS: self.data, SVC_AXIS: self.svc}

    def describe(self) -> str:
        """Canonical named form (``data=4,svc=2`` / ``+,slice=2``)."""
        s = f"data={self.data},svc={self.svc}"
        if self.slices > 1:
            s += f",slice={self.slices}"
        return s


class EmulatedMesh:
    """A mesh SHAPE with no devices — the multi-host emulation handle.

    Mimics the part of a mesh the sharded runner reads (``axis_names``
    / ``shape`` / ``size``) so ``ShardedSimulator`` can plan and replay
    an N-host program shard by shard on one device (``run_emulated``
    and friends); the collective entry points raise — there is nothing
    to reduce over.
    """

    def __init__(self, spec: MeshSpec):
        self.spec = spec
        self.axis_names = spec.axis_names
        self.shape = spec.shape
        self.size = spec.size
        self.devices = None

    def __repr__(self) -> str:
        return f"EmulatedMesh({self.spec.describe()})"


def parse_mesh_spec(text: str) -> Union[str, MeshSpec]:
    """Parse a ``--mesh`` / ``$ISOTOPE_MESH`` value.

    Returns the string ``"auto"`` or a :class:`MeshSpec`.  Accepted
    forms::

        auto
        4x2          # data x svc
        2x2x2        # data x svc x slice
        data=4,svc=2,slice=1   # named, any subset, any order

    Errors are key-pathed (``mesh.svc: ...``) like every other config
    decode in the tree (models/errors.py).
    """
    text = text.strip()
    if not text:
        with config_path("mesh"):
            raise ValueError("empty mesh spec")
    if text.lower() == "auto":
        return "auto"
    if "=" in text:
        sizes = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in AXIS_ORDER:
                with config_path("mesh"):
                    raise ValueError(
                        f"unknown mesh axis {key!r} (valid axes: "
                        f"{', '.join(AXIS_ORDER)})"
                    )
            if key in sizes:
                with config_path(f"mesh.{key}"):
                    raise ValueError("axis given twice")
            with config_path(f"mesh.{key}"):
                try:
                    sizes[key] = int(val.strip())
                except ValueError:
                    raise ValueError(
                        f"axis size must be an integer, got "
                        f"{val.strip()!r}"
                    ) from None
        if not sizes:
            with config_path("mesh"):
                raise ValueError("empty mesh spec")
        return MeshSpec(
            data=sizes.get(DATA_AXIS, 1),
            svc=sizes.get(SVC_AXIS, 1),
            slices=sizes.get(SLICE_AXIS, 1),
        )
    parts = [p.strip() for p in text.lower().split("x")]
    if len(parts) not in (1, 2, 3):
        with config_path("mesh"):
            raise ValueError(
                f"bad mesh spec {text!r} (want 'auto', 'DATAxSVC', "
                f"'DATAxSVCxSLICE', or 'data=4,svc=2,slice=1')"
            )
    dims = []
    for name, part in zip(("data", "svc", "slice"), parts):
        with config_path(f"mesh.{name}"):
            try:
                dims.append(int(part))
            except ValueError:
                raise ValueError(
                    f"axis size must be an integer, got {part!r}"
                ) from None
    while len(dims) < 3:
        dims.append(1)
    return MeshSpec(data=dims[0], svc=dims[1], slices=dims[2])


def mesh_spec_from_env() -> Optional[Union[str, MeshSpec]]:
    """The ``$ISOTOPE_MESH`` spec, or None when unset/empty."""
    raw = os.environ.get(ENV_MESH, "").strip()
    if not raw:
        return None
    with config_path(ENV_MESH):
        return parse_mesh_spec(raw)


# -- the world ---------------------------------------------------------------


def _device_type(device) -> str:
    """``"cuda"`` (the default) or ``"cpu"``."""
    if device is None:
        return "cuda"
    kind = str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {device!r}")
    return kind


def _timeout(timeout_s: Optional[float]) -> datetime.timedelta:
    """``timeout_s``, else ``$ISOTOPE_MESH_TIMEOUT``, else the
    default."""
    if timeout_s is None:
        timeout_s = float(os.environ.get(ENV_MESH_TIMEOUT, "")
                          or DEFAULT_TIMEOUT_S)
    return datetime.timedelta(seconds=timeout_s)


def _world():
    """The initialized default process group's module, else None (a
    process that never imported ``torch.distributed`` has no group)."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist
    return None


def world_size() -> int:
    """Ranks of the initialized world, or of the one ``torchrun``
    announces (``$WORLD_SIZE``), else 1."""
    dist = _world()
    if dist is not None:
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_rank() -> int:
    """This process's global rank (0 outside a world)."""
    dist = _world()
    if dist is not None:
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def rank_console():
    """A context in which only rank 0 prints: every other rank's console
    lines are dropped (an error it raises still propagates)."""
    if world_rank() == 0:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
    stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
    return stack


def init_world(device=None, timeout_s: Optional[float] = None) -> None:
    """Initialize the default process group if none is: from the
    launcher's environment (``torchrun``: ``env://``) when it announces
    several ranks, else a world of one in process (a ``HashStore``, no
    TCP).  The backend follows the device (NCCL on the card, ``gloo``
    on the CPU); the card's rank binds ``cuda:$LOCAL_RANK`` first."""
    import torch
    import torch.distributed as dist

    kind = _device_type(device)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a cuda mesh needs a GPU; pass device='cpu' for the "
                "gloo mesh"
            )
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        want = "nccl" if kind == "cuda" else "gloo"
        have = dist.get_backend()
        if want not in str(have):
            raise ValueError(
                f"the world's backend is {have}, a {kind} mesh needs "
                f"{want}"
            )
        return
    backend = "nccl" if kind == "cuda" else "gloo"
    if world_size() > 1:
        dist.init_process_group(backend, init_method="env://",
                                timeout=_timeout(timeout_s))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_timeout(timeout_s))


def close_world() -> None:
    """Destroy the default process group (and every mesh built over
    it): a process that built a world of one in process leaves none
    behind."""
    import torch.distributed as dist

    _MESHES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _group_options(backend: str, timeout: datetime.timedelta):
    """Backend options carrying ``timeout`` for the mesh's per-axis
    groups (a ``DeviceMesh`` gives its subgroups the backend's default
    timeout otherwise: 30 minutes)."""
    import torch.distributed as dist

    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    else:
        opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    return opts


_MESHES: Dict[Tuple, object] = {}


def check_world(spec: MeshSpec) -> None:
    """Raise the key-pathed config error of a spec the world cannot
    hold: more ranks than it has, or fewer (its other ranks would wait
    in every collective)."""
    have = world_size()
    if spec.size > have:
        with config_path("mesh"):
            raise ValueError(
                f"mesh {spec.describe()} needs {spec.size} devices, "
                f"have {have} (use an EmulatedMesh / run_emulated to "
                f"replay more hosts than exist)"
            )
    if spec.size < have:
        with config_path("mesh"):
            raise ValueError(
                f"mesh {spec.describe()} covers {spec.size} of the "
                f"world's {have} ranks (launch {spec.size}: torchrun "
                f"--nproc-per-node {spec.size})"
            )


def build_mesh(spec: MeshSpec, device=None,
               timeout_s: Optional[float] = None):
    """Materialize a spec over the world's ranks (slice axis outermost)
    as a ``DeviceMesh`` named ``(slice, data, svc)`` (``(data, svc)``
    when ``slices == 1``); ``device`` is ``"cuda"`` (the default) or
    ``"cpu"``, ``timeout_s`` every group's timeout.

    Raises a key-pathed config error when the spec wants more ranks
    than the world has — the same failure text whether the spec came
    from the CLI, the env, or a TOML — or covers fewer (the world's
    other ranks would wait in every collective).  A world of one needs
    no launcher (:func:`init_world`).  Meshes are cached per spec,
    device and timeout: building the same mesh twice reuses its groups.
    """
    check_world(spec)
    kind = _device_type(device)
    key = (spec, kind, timeout_s)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        init_world(kind, timeout_s)
        names = spec.axis_names
        opts = _group_options("nccl" if kind == "cuda" else "gloo",
                              _timeout(timeout_s))
        _MESHES[key] = init_device_mesh(
            kind, tuple(spec.shape[a] for a in names),
            mesh_dim_names=names,
            backend_override={a: opts for a in names},
        )
    return _MESHES[key]


def make_mesh(data: int, svc: int = 1, device=None,
              timeout_s: Optional[float] = None):
    """The ``(data, svc)`` mesh over the world's ranks."""
    return build_mesh(MeshSpec(data=data, svc=svc), device, timeout_s)


def make_multislice_mesh(slices: int, data: int, svc: int = 1,
                         device=None, timeout_s: Optional[float] = None):
    """The ``(slice, data, svc)`` mesh for multi-host runs: each
    contiguous block of ``data * svc`` ranks is one slice, so the
    ``data`` / ``svc`` collectives stay inside a host when the launcher
    numbers ranks host by host (``torchrun`` does)."""
    return build_mesh(MeshSpec(data=data, svc=svc, slices=slices),
                      device, timeout_s)


def default_mesh(device=None, timeout_s: Optional[float] = None):
    """Every rank of the world on the data axis."""
    return make_mesh(world_size(), 1, device, timeout_s)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """``(axis names, {axis: size})`` of a ``DeviceMesh`` or an
    :class:`EmulatedMesh`."""
    if isinstance(mesh, EmulatedMesh):
        return tuple(mesh.axis_names), dict(mesh.shape)
    names = tuple(mesh.mesh_dim_names)
    return names, dict(zip(names, (int(n) for n in mesh.mesh.shape)))
