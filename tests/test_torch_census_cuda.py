"""The CUDA census kernel against its plain torch version, on the card.

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import nothing of JAX, so they also run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_census_cuda.py``.
"""
import numpy as np
import pytest
import torch

from isotope_tpu_torch.native import census as census_mod

# the card's torch.cumsum in the plain version may associate differently
# from the kernel's sequential scan over the step axis
RTOL = 1e-5

SHAPES = [
    (13, 37, 5),      # unaligned, several steps
    (4096, 27, 1),    # the flagship's widest census level, one step
    (240, 3, 2),      # short rows: the stream kernel at P = 2, 3, 4,
    (1001, 3, 3),     # with a ragged last group of rows
    (64, 5, 4),
    (257, 512, 64),   # wide scripts
    (4096, 25, 20),   # realistic-powerlaw-100's wide level
    (4096, 1, 46),    # realistic-star-50's hub
    (64, 3, 4096),    # rows too wide to stage whole: the chunked path
]


def _fixture(n, b, p, with_fail, with_err, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.uniform(0, 1, (b, p)).astype(np.float32),
        (rng.uniform(0, 1, (b, p)) > 0.3).astype(np.float32),
        rng.uniform(0, 2, (n, b, p)).astype(np.float32),
        rng.integers(0, p + 1, (n, b)).astype(np.int32) if with_fail
        else None,
        rng.uniform(0, 1, (n, b)) > 0.7 if with_err else None,
    ]
    return [None if a is None else torch.from_numpy(a).cuda() for a in arrs]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_fail", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_kernel_matches_reference(card, shape, with_fail, with_err):
    args = _fixture(*shape, with_fail, with_err)
    want_busy, want_excl = census_mod.census_reference(*args)
    before = census_mod.census.launches
    busy, excl = census_mod.census(*args)
    torch.cuda.synchronize()
    assert census_mod.census.launches == before + 1
    torch.testing.assert_close(busy, want_busy, rtol=RTOL, atol=0)
    torch.testing.assert_close(excl, want_excl, rtol=RTOL, atol=0)
    # the kernel's own order of operations: bit for bit
    seq_busy, seq_excl = census_mod.census_sequential(*args)
    assert torch.equal(busy, seq_busy) and torch.equal(excl, seq_excl)


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes (one element for
    float32 and int32, four for bool) past a 16-byte boundary."""
    if t is None:
        return None
    pad = 4 // t.element_size()
    flat = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    out = flat[pad:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4099, 3, 1), (1001, 3, 3), (13, 37, 5),
                                   (515, 7, 20), (5, 3, 300)])
def test_kernel_takes_unaligned_views(card, shape):
    """Inputs off 16-byte boundaries take the kernels' 4-byte copies,
    with the same results."""
    args = _fixture(*shape, True, True, seed=2)
    want = census_mod.census(*args)
    got = census_mod.census(*args[:2], *map(_unaligned, args[2:]))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    base, mask, agg, fail, err = _fixture(8, 4, 2, True, True)
    with pytest.raises(TypeError):
        census_mod.census(base, mask, agg, fail.to(torch.int64), err)
    with pytest.raises(ValueError):
        census_mod.census(base, mask, agg.transpose(0, 1), fail, err)
    with pytest.raises(ValueError):
        census_mod.census(base.cpu(), mask, agg, fail, err)
