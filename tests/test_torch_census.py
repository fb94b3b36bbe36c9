"""The port's census join against the JAX package's Pallas kernel.

``census_reference`` (the plain torch op chain, which the CPU path of
``isotope_tpu_torch.native.census.census`` runs) is held to
``isotope_tpu.native.census_pallas.census`` in interpret mode, on the
JAX package's own unaligned 13x37x5 fixture and on a P=1 grid.  The
CUDA kernel itself is held to ``census_reference`` on the card by
``tests/test_torch_census_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.native import census_pallas
from isotope_tpu_torch.native import census as census_mod

# The Pallas kernel (interpret mode) and the torch chain take the same
# float32 max / mask multiplies; only the step-axis prefix sum may
# associate differently (XLA's cumsum vs torch.cumsum), which bounds
# the difference by a few ULP of the running sum: rtol 1e-6, atol 0.
RTOL = 1e-6


def _fixture(n, b, p, with_fail, with_err, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (b, p)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, p)) > 0.3).astype(np.float32)
    agg = rng.uniform(0, 2, (n, b, p)).astype(np.float32)
    fail = (
        rng.integers(0, p + 1, (n, b)).astype(np.int32) if with_fail
        else None
    )
    err = rng.uniform(0, 1, (n, b)) > 0.7 if with_err else None
    return base, mask, agg, fail, err


def _jax(arrs):
    base, mask, agg, fail, err = arrs
    busy, excl = census_pallas.census(
        jnp.asarray(base), jnp.asarray(mask), jnp.asarray(agg),
        None if fail is None else jnp.asarray(fail),
        None if err is None else jnp.asarray(err),
        interpret=True,
    )
    return np.asarray(busy), np.asarray(excl)


def _torch(arrs, fn=census_mod.census_reference, device="cpu"):
    tensors = [
        None if a is None else torch.from_numpy(a).to(device) for a in arrs
    ]
    busy, excl = fn(*tensors)
    return busy.cpu().numpy(), excl.cpu().numpy()


@pytest.mark.parametrize("with_fail", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_reference_matches_pallas_kernel(with_fail, with_err):
    arrs = _fixture(13, 37, 5, with_fail, with_err)
    want_busy, want_excl = _jax(arrs)
    busy, excl = _torch(arrs)
    np.testing.assert_allclose(busy, want_busy, rtol=RTOL, atol=0)
    np.testing.assert_allclose(excl, want_excl, rtol=RTOL, atol=0)


def test_reference_matches_pallas_kernel_single_step():
    """P = 1, the flagship's shape: no prefix sum to reassociate, so the
    two are bit-equal."""
    arrs = _fixture(64, 27, 1, True, True, seed=3)
    want_busy, want_excl = _jax(arrs)
    busy, excl = _torch(arrs)
    np.testing.assert_array_equal(busy, want_busy)
    np.testing.assert_array_equal(excl, want_excl)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper computes the plain version and launches
    nothing."""
    arrs = _fixture(13, 37, 5, True, True)
    before = census_mod.census.launches
    got = _torch(arrs, fn=census_mod.census)
    want = _torch(arrs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert census_mod.census.launches == before


def test_library_path_is_keyed_by_source():
    """The built library lives under native/_build and its name carries
    a digest of the source and flags, so an edited kernel rebuilds."""
    path = census_mod.LIBRARY.path()
    assert path.parent.name == "_build"
    assert path.name.startswith("libcensus-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in census_mod.NVCC_FLAGS
