"""The port's mesh specs and meshes (``isotope_tpu_torch/parallel/mesh.py``)
against the JAX package's (``isotope_tpu/parallel/mesh.py``): the spec
parser, its key-pathed errors and ``$ISOTOPE_MESH`` as
``tests/test_layout.py`` pins them, the emulated mesh, and a world of
one built in process (a ``gloo`` group over a ``HashStore``, no
launcher).  The worlds of several ranks are in
``tests/test_torch_sharded.py``."""
import re

import pytest

from isotope_tpu.parallel import mesh as jax_mesh
from isotope_tpu_torch.parallel import mesh

SPECS = ["4x2", "2x2x2", "svc=2,data=4", "slice=2,data=2,svc=2", "data=8",
         "auto", " AUTO ", "8", "1x1", " data = 3 , svc=1 "]
BAD_SPECS = ["foo=3", "data=2,svc=x", "bogus", "data=2,data=4",
             "2x2x2x2", "", "data=0", "2x0", ","]


def _same(got, want):
    if isinstance(want, str):
        return got == want
    return (got.data, got.svc, got.slices) == (
        want.data, want.svc, want.slices
    )


@pytest.mark.parametrize("text", SPECS)
def test_parse_matches_reference(text):
    got, want = mesh.parse_mesh_spec(text), jax_mesh.parse_mesh_spec(text)
    assert _same(got, want)
    if not isinstance(got, str):
        assert got.describe() == want.describe()
        assert got.axis_names == want.axis_names
        assert got.shape == want.shape and got.size == want.size
        assert mesh.parse_mesh_spec(got.describe()) == got


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_errors_match_reference_key_paths(text):
    with pytest.raises(ValueError) as want:
        jax_mesh.parse_mesh_spec(text)
    with pytest.raises(ValueError) as got:
        mesh.parse_mesh_spec(text)
    assert str(got.value) == str(want.value)


def test_spec_validates_axis_sizes():
    with pytest.raises(ValueError, match=r"mesh\.svc"):
        mesh.MeshSpec(data=2, svc=0)


def test_env_spec(monkeypatch):
    monkeypatch.delenv(mesh.ENV_MESH, raising=False)
    assert mesh.mesh_spec_from_env() is None
    monkeypatch.setenv(mesh.ENV_MESH, "4x2")
    assert mesh.mesh_spec_from_env() == mesh.MeshSpec(data=4, svc=2)
    monkeypatch.setenv(mesh.ENV_MESH, "wat=1")
    with pytest.raises(ValueError, match=mesh.ENV_MESH) as got:
        mesh.mesh_spec_from_env()
    with pytest.raises(ValueError) as want:
        jax_mesh.mesh_spec_from_env()
    assert str(got.value) == str(want.value)


def test_emulated_mesh_carries_the_shape():
    spec = mesh.MeshSpec(data=4, svc=2, slices=2)
    em = mesh.EmulatedMesh(spec)
    want = jax_mesh.EmulatedMesh(jax_mesh.MeshSpec(data=4, svc=2,
                                                   slices=2))
    assert em.axis_names == want.axis_names == ("slice", "data", "svc")
    assert em.shape == want.shape and em.size == want.size == 16
    assert repr(em) == repr(want)
    assert mesh.mesh_axes(em) == (("slice", "data", "svc"),
                                  {"slice": 2, "data": 4, "svc": 2})


@pytest.fixture
def world_of_one():
    mesh.close_world()
    yield
    mesh.close_world()


def test_world_of_one_needs_no_launcher(world_of_one, monkeypatch):
    """No process group: ``build_mesh`` of a one-rank spec initializes a
    ``gloo`` world of one in process, with the caller's timeout, and
    caches the mesh; the mesh's dims are named as the reference's."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    m = mesh.build_mesh(mesh.MeshSpec(1, 1), device="cpu", timeout_s=60)
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert m.mesh_dim_names == ("data", "svc")
    assert mesh.mesh_axes(m) == (("data", "svc"), {"data": 1, "svc": 1})
    assert list(m.get_coordinate()) == [0, 0]
    assert mesh.build_mesh(mesh.MeshSpec(1, 1), device="cpu",
                           timeout_s=60) is m
    assert mesh.default_mesh("cpu", 60) is m
    assert mesh.make_mesh(1, 1, "cpu", 60) is m


@pytest.mark.parametrize("spec,msg", [
    (mesh.MeshSpec(data=2, svc=1), "needs 2 devices, have 1"),
    (mesh.MeshSpec(data=8, svc=2), "needs 16 devices, have 1"),
    (mesh.MeshSpec(data=1, svc=1, slices=2), "needs 2 devices, have 1"),
])
def test_mesh_larger_than_the_world_is_key_pathed(world_of_one, spec, msg,
                                                  monkeypatch):
    """The reference's message under ``config_path("mesh")``, before
    any group is built."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=r"^mesh: mesh .*" + re.escape(
            msg) + r" \(use an EmulatedMesh / run_emulated"):
        mesh.build_mesh(spec, device="cpu")
    assert not dist.is_initialized()


def test_mesh_smaller_than_the_world_is_refused(monkeypatch):
    """A launcher's world of four cannot run a two-rank mesh: its other
    ranks would wait in every collective."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=r"mesh: mesh data=2,svc=1 "
                                         r"covers 2 of the world's 4"):
        mesh.check_world(mesh.MeshSpec(2, 1))


def test_timeout_follows_caller_then_env(monkeypatch):
    monkeypatch.delenv(mesh.ENV_MESH_TIMEOUT, raising=False)
    assert mesh._timeout(None).total_seconds() == mesh.DEFAULT_TIMEOUT_S
    monkeypatch.setenv(mesh.ENV_MESH_TIMEOUT, "45")
    assert mesh._timeout(None).total_seconds() == 45.0
    assert mesh._timeout(60).total_seconds() == 60.0


def test_cuda_mesh_needs_a_gpu(world_of_one, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without a GPU")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        mesh.build_mesh(mesh.MeshSpec(1, 1))
