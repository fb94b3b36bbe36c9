"""The CUDA finite-population wait kernel against its plain versions, on
the card.

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import nothing of JAX, so they also run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_satwait_cuda.py``.

The kernel equals ``saturated_wait_sequential`` (its own order of
operations) bit for bit.  Against ``saturated_wait_reference`` only the
copula's row sum is associated otherwise: a few float32 spacings of the
projection, which the normal CDF and the quantile polynomial carry into
the wait, so the two are held to the port's tolerance for saturated runs
(rtol 1e-4 plus atol 1e-5 s, ``tests/test_torch_closed.py``).
"""
import numpy as np
import pytest
import torch

from isotope_tpu_torch.native import satwait as satwait_mod

RTOL, ATOL = 1e-4, 1e-5


def quantile_coefficients(rng, rows, d):
    """``(rows, d)`` quantile polynomials in ``v = -log(1 - u)`` shaped
    like the finite-population law's: a degree-``d - 1`` fit over ``v``
    in [0, 16] of ``v / rate + a * log1p(v)`` (an exponential tail of
    rate 200 to 2,000 per second, bent by a concave term of at most 2
    ms), as ``sim/closed.py`` fits its waits' quantiles."""
    v = np.linspace(0.0, 16.0, 200)
    rate = rng.uniform(200.0, 2000.0, rows)
    a = rng.uniform(0.0, 2e-3, rows)
    w = v[:, None] / rate + a * np.log1p(v)[:, None]
    return np.polynomial.polynomial.polyfit(v, w, d - 1).T


def tables(n, h, d, r, seed=0, device="cpu"):
    """``(z, rows, (p0, coef, e, c, scale))``: normals and ``r`` rows of
    tables shaped like the finite-population law's (zero-wait masses in
    [0.05, 0.6], :func:`quantile_coefficients`, unit projection vectors,
    and each row's copula centre and its variance scale as
    ``Simulator._center_terms`` makes them)."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0.05, 0.6, (r, h))
    coef = quantile_coefficients(rng, r * h, d).reshape(r, h, d)
    coef = coef.transpose(0, 2, 1)
    e = np.abs(rng.normal(0, 1, (r, h)))
    e /= np.sqrt((e**2).sum(1, keepdims=True))
    c = rng.uniform(0.1, 0.9, r)
    scale = 1.0 / np.sqrt(1.0 - (2 * c[:, None] - c[:, None]**2) * e**2)
    z = rng.normal(0, 1, (n, h))
    rows = rng.integers(0, r, n)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return t(z), t(rows, torch.int64), tuple(
        t(x) for x in (p0, coef, e, c, scale))


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# (n, h, d, table rows, branch)
CASES = [
    (30_000, 1000, 11, 1, "unphased"),     # multitier1k's block
    (30_000, 1000, 11, 1, "uncentred"),    # an unphased row with c <= 0
    (16_384, 3, 11, 1, "unphased"),        # three hops: a thread a row
    (16_384, 121, 11, 1, "unphased"),      # the flagship tree: a warp a row
    (4096, 999, 11, 1, "unphased"),        # odd H: 4-byte loads
    (4096, 37, 11, 6, "phased"),           # each request's phase row
    (2048, 1000, 11, 6, "phased"),
    (8 * 2048, 121, 11, 8 * 3, "members"),  # a chaos fleet's members
    (32_768, 121, 11, 1, "override"),      # the fork-join pilots
    (4096, 1000, 2, 1, "override"),        # another degree: the loop
    (512, 10_000, 11, 1, "unphased"),      # several chunks a thread
]


def _args(n, h, d, r, branch, seed=0):
    z, rows, t = tables(n, h, d, r, seed, "cuda")
    if branch in ("unphased", "uncentred", "override"):
        rows = None
    return z, rows, t, branch != "uncentred"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[:3])) + f"-r{c[3]}-{c[4]}")
def test_kernel_matches_plain_versions(card, case):
    z, rows, t, copula = _args(*case)
    before = satwait_mod.saturated_wait.launches
    got = satwait_mod.saturated_wait(z, rows, *t, copula=copula)
    torch.cuda.synchronize()
    assert satwait_mod.saturated_wait.launches == before + 1
    seq = satwait_mod.saturated_wait_sequential(z, rows, *t, copula)
    assert same_bits(got, seq)
    ref = satwait_mod.saturated_wait_reference(z, rows, *t, copula)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
def test_unaligned_pointers_take_4_byte_loads(card):
    z, rows, t, copula = _args(4096, 1000, 11, 6, "phased", seed=3)
    z = _unaligned(z)
    assert z.data_ptr() % 16 != 0
    got = satwait_mod.saturated_wait(z, rows, *t, copula=copula)
    seq = satwait_mod.saturated_wait_sequential(z, rows, *t, copula)
    assert same_bits(got, seq)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    z, rows, t, _ = _args(256, 120, 11, 3, "phased")
    with pytest.raises(ValueError, match="contiguous"):
        satwait_mod.saturated_wait(z.t().contiguous().t(), rows, *t)
    with pytest.raises(TypeError, match="float32"):
        satwait_mod.saturated_wait(z.double(), rows, *t)
    with pytest.raises(ValueError, match="rows is on cpu"):
        satwait_mod.saturated_wait(z, rows.cpu(), *t)
    with pytest.raises(TypeError, match="int64"):
        satwait_mod.saturated_wait(z, rows.int(), *t)
    p0, coef, e, c, scale = t
    with pytest.raises(ValueError, match="shape"):
        satwait_mod.saturated_wait(z, rows, p0[:, :-1], coef, e, c, scale)
