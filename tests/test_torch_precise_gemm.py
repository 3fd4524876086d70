"""The compensated GEMM (K4): the PyTorch port against the JAX package.

The same numpy-seeded inputs go through JAX's ``precise_matmul`` (the
Pallas kernel in interpret mode, as ``tests/test_precise_gemm.py`` runs
it) and the port's ``precise_matmul`` on CPU tensors (its plain version,
``precise_matmul_reference``).

Tolerance: the two sum each K tile in another order (XLA's dot against
torch's matmul), so they may differ by a few f32 roundings of the tile
partials: ``max|port - jax| <= 1e-6 * max(|a| @ |b|)``, about ten
times the largest difference seen on these shapes.  The cancellation
case is held against the f64 product instead: there the tile partials
are ~1e10 and their last bits depend on the order, but compensation
must recover the small tiles regardless.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.znicz import gemm as jgemm
from veles_tpu_torch.znicz import gemm as tgemm

RTOL = 1e-6


def _inputs(m, k, n, seed):
    rng = numpy.random.RandomState(seed)
    return (rng.standard_normal((m, k)).astype(numpy.float32),
            rng.standard_normal((k, n)).astype(numpy.float32))


def _scale(a, b):
    return float((numpy.abs(a).astype(numpy.float64) @ numpy.abs(b)).max())


# MNIST's forward and backward shapes (K = 784 = 3 * 256 + 16, N = 10)
# and ragged ones far from the 64 / 256 tiles
SHAPES = [(60, 784, 100), (60, 100, 10), (60, 10, 100), (784, 60, 100),
          (100, 60, 10), (130, 70, 190), (5, 300, 7), (1, 513, 1)]


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax(shape, level):
    m, k, n = shape
    a, b = _inputs(m, k, n, seed=m + k + n)
    want = numpy.asarray(jgemm.precise_matmul(a, b, level))
    got = tgemm.precise_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               level)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert numpy.abs(got.numpy() - want).max() <= RTOL * _scale(a, b)


def _cancellation_problem(bk=256):
    """``tests/test_precise_gemm.py``'s case: huge tiles of +3e7 and
    -3e7 bracket small random ones, so plain accumulation of the tile
    partials loses the small tiles."""
    rng = numpy.random.RandomState(1)
    row = numpy.zeros(4 * bk, numpy.float32)
    row[0:bk] = 3e7
    row[bk:2 * bk] = rng.uniform(-1, 1, bk)
    row[2 * bk:3 * bk] = -3e7
    row[3 * bk:] = rng.uniform(-1, 1, bk)
    return numpy.tile(row[None, :], (8, 1)), numpy.ones((4 * bk, 8),
                                                         numpy.float32)


def test_cancellation_level1_beats_level0_as_in_jax():
    a, b = _cancellation_problem()
    exact = a.astype(numpy.float64) @ b.astype(numpy.float64)
    err, jerr = {}, {}
    for level in (0, 1, 2):
        got = tgemm.precise_matmul(torch.from_numpy(a),
                                   torch.from_numpy(b), level).numpy()
        err[level] = numpy.abs(got - exact).max()
        jerr[level] = numpy.abs(numpy.asarray(
            jgemm.precise_matmul(a, b, level)) - exact).max()
    # the JAX package's own criterion, on both packages
    for e in (err, jerr):
        assert e[0] > 0.1, e
        assert e[1] < e[0] / 1e4, e
        assert e[2] <= e[1] * 1.01, e
    # compensated, the two packages agree with the exact sum alike
    assert err[1] < 1e-4 and jerr[1] < 1e-4, (err, jerr)


def _klein_problem(reps, bk=256, m=8, n=8):
    """A case where level 2's second carry matters: a 2**40 tile, then
    ``reps`` triples of tiles x, y, -x (x in [1, 2), y ~ 1e-9), then a
    -2**40 tile.  Against 2**40 each small tile lands whole in the
    TwoSum error; Neumaier's carry ``c1 += e`` then rounds y away
    (y < ulp(x) / 2), Klein's keeps it in ``c2``.  One nonzero per tile
    and power-of-two columns of b make every tile partial exact, so the
    sums differ only in the compensation.  The exact product is the
    f64 ``math.fsum`` of each row (a plain f64 dot loses y against
    2**40 too)."""
    import math
    rng = numpy.random.RandomState(2)
    tiles = 2 + 3 * reps
    a = numpy.zeros((m, tiles * bk), numpy.float32)
    for i in range(m):
        vals = [2.0 ** 40]
        for _ in range(reps):
            x = rng.uniform(1, 2)
            vals += [x, rng.uniform(2.0 ** -31, 2.0 ** -30), -x]
        vals.append(-2.0 ** 40)
        for t, v in enumerate(vals):
            a[i, t * bk + rng.randint(bk)] = v
    cols = 2.0 ** numpy.arange(n, dtype=numpy.float32)
    b = numpy.tile(cols[None, :], (tiles * bk, 1))
    exact = numpy.array([math.fsum(r) for r in a.astype(numpy.float64)])
    return a, b, exact[:, None] * cols[None, :].astype(numpy.float64)


@pytest.mark.parametrize("reps", [1, 10])
def test_klein_second_carry_matters_as_in_jax(reps):
    """Level 1 loses the small tiles entirely; level 2 must keep them:
    ``err[2] < err[1] / 1e4`` against the exact product, on both
    packages (a Klein that lost its second carry would equal level 1)."""
    a, b, exact = _klein_problem(reps)
    for pkg in ("port", "jax"):
        err = {}
        for level in (0, 1, 2):
            if pkg == "port":
                got = tgemm.precise_matmul(torch.from_numpy(a),
                                           torch.from_numpy(b), level)
                got = got.numpy()
            else:
                got = numpy.asarray(jgemm.precise_matmul(a, b, level))
            err[level] = numpy.abs(got - exact).max()
        assert err[1] > 0.5 * numpy.abs(exact).max(), (pkg, err)
        assert err[2] < err[1] / 1e4, (pkg, err)


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape", [(32, 64, 16), (60, 784, 100),
                                   (60, 100, 10)])
def test_gradients_match_jax_grad(shape, level):
    m, k, n = shape
    a, b = _inputs(m, k, n, seed=7 * m + k)
    ga_j, gb_j = jax.grad(
        lambda x, y: (jgemm.precise_matmul(x, y, level) ** 2).sum(),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    (tgemm.precise_matmul(at, bt, level) ** 2).sum().backward()
    # g = 2 (a @ b): the gradients' scale is |g| @ |b|^T and |a|^T @ |g|
    g = 2.0 * numpy.abs(a.astype(numpy.float64) @ b)
    tol_a = 4 * RTOL * float((g @ numpy.abs(b).T).max())
    tol_b = 4 * RTOL * float((numpy.abs(a).T @ g).max())
    assert numpy.abs(at.grad.numpy() - numpy.asarray(ga_j)).max() <= tol_a
    assert numpy.abs(bt.grad.numpy() - numpy.asarray(gb_j)).max() <= tol_b


def test_backward_skips_the_input_gradient_nobody_needs(monkeypatch):
    """A first layer's input needs no gradient: forward + ``a.T @ g``
    only, two calls instead of three."""
    calls = []
    plain = tgemm.precise_matmul_reference

    def counting(a, b, level=1):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return plain(a, b, level)

    monkeypatch.setattr(tgemm, "precise_matmul_reference", counting)
    launches = tgemm.precise_matmul.launches
    a, b = (torch.from_numpy(t) for t in _inputs(6, 20, 4, seed=0))
    w = b.clone().requires_grad_(True)
    tgemm.precise_matmul(a, w, 1).sum().backward()
    assert calls == [((6, 20), (20, 4)), ((20, 6), (6, 4))]
    assert w.grad is not None
    calls.clear()
    x = a.clone().requires_grad_(True)
    tgemm.precise_matmul(x, w, 1).sum().backward()
    assert calls == [((6, 20), (20, 4)), ((6, 4), (4, 20)),
                     ((20, 6), (6, 4))]
    # CPU calls take the plain version and launch nothing
    assert tgemm.precise_matmul.launches == launches


def test_bad_shapes_and_levels_raise():
    a, b = torch.zeros((4, 5)), torch.zeros((6, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        tgemm.precise_matmul(a, b, 1)
    with pytest.raises(ValueError, match="level"):
        tgemm.precise_matmul(a, torch.zeros((5, 3)), 3)


# -- 3xTF32, as K4 forms its tile partials on the card ------------------------

def _tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero, on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32x3_matmul(a, b, level):
    """The card's K4 in plain PyTorch: each operand split as ``hi + lo``
    (``hi = tf32(x)``, ``lo = tf32(x - hi)``), each 256-deep tile
    partial ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (products of TF32
    values are exact in f32), the running sum compensated at ``level``
    as in ``precise_matmul_reference``."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    c1, c2 = torch.zeros_like(acc), torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], tgemm.DEFAULT_BLOCK_K):
        t = slice(k0, k0 + tgemm.DEFAULT_BLOCK_K)
        p = (a_lo[:, t] @ b_hi[t] + a_hi[:, t] @ b_lo[t]) + \
            a_hi[:, t] @ b_hi[t]
        if level == 0:
            acc = acc + p
            continue
        acc, e = tgemm._two_sum(acc, p)
        if level == 1:
            c1 = c1 + e
        else:
            c1, e2 = tgemm._two_sum(c1, e)
            c2 = c2 + e2
    return acc + (c1 + c2)


def test_tf32_rounds_to_nearest_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, 3e7, 1.0])
    want = [1 + 2 ** -10, 1 + 2 * 2 ** -10, -(1 + 2 ** -10), 1.0,
            1831.0 * 2 ** 14, 1.0]
    assert _tf32(x).tolist() == want
    # hi + lo keeps x to within 2^-23 of itself (22 of its 24 bits)
    y = torch.from_numpy(numpy.random.RandomState(3).standard_normal(
        4096).astype(numpy.float32))
    hi = _tf32(y)
    rel = ((hi + _tf32(y - hi)).double() - y.double()).abs() / y.abs()
    assert float(rel.max()) <= 2.0 ** -23


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape", [(60, 784, 100), (130, 1000, 70),
                                   (257, 2049, 65), (64, 4096, 64)])
def test_tf32x3_products_hold_the_kernel_tolerance(shape, level):
    """3xTF32 tile partials stay within the card's K4 limit of the plain
    f32 version: ``1e-6 * max(|a| @ |b|)``."""
    m, k, n = shape
    a, b = (torch.from_numpy(x) for x in _inputs(m, k, n, seed=k + level))
    got = _tf32x3_matmul(a, b, level)
    want = tgemm.precise_matmul_reference(a, b, level)
    scale = float((a.abs() @ b.abs()).max())
    assert float((got - want).abs().max()) <= RTOL * scale


def test_tf32x3_keeps_the_cancellation_and_the_second_carry():
    """The compensation cases of the card hold with 3xTF32 products:
    level 1 beats level 0 by 1e4 on the cancellation case, level 2
    keeps Klein's second carry (``err[2] < err[1] / 1e4``)."""
    a, b = _cancellation_problem()
    exact = a.astype(numpy.float64) @ b.astype(numpy.float64)
    err = {level: numpy.abs(_tf32x3_matmul(
        torch.from_numpy(a), torch.from_numpy(b), level).numpy()
        - exact).max() for level in (0, 1, 2)}
    assert err[0] > 0.1 and err[1] < err[0] / 1e4, err
    assert err[2] <= err[1] * 1.01, err
    a, b, exact = _klein_problem(10)
    err = {level: numpy.abs(_tf32x3_matmul(
        torch.from_numpy(a), torch.from_numpy(b), level).numpy()
        - exact).max() for level in (1, 2)}
    assert err[1] > 0.5 * numpy.abs(exact).max(), err
    assert err[2] < err[1] / 1e4, err
