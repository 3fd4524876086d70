"""The weight-quantized GEMM: the PyTorch port against the JAX package.

``quantize_weight`` must give the JAX package's int8 and float8-e4m3
bytes and scales exactly (int8 rounds half to even; the fp8 cast rounds
to nearest even in both).  The port's ``quantized_matmul`` (its plain
version, on CPU tensors) matches JAX's ``quantized_matmul`` (the Pallas
kernel in interpret mode) and its staged reference at ``rtol=1e-5`` of
the largest output, on shapes that are not tile multiples.

The card's K3 forms its products on the tensor cores in 2xTF32: every
int8 and every finite float8-e4m3 weight is exact in TF32, so splitting
only the activations (``a = hi + lo``) gives the whole product in two
passes.  A plain-torch emulation of that sum (the weights' upcast as the
kernel does it, ``a_lo w`` then ``a_hi w`` every 8-deep step into the
partial of a 64-deep stage, the stages' partials added up in f32, split-K
ranges added in K order, then the scales) is held against JAX's
``quantized_matmul_reference`` within the card's limit, ``1e-5`` of the
largest output.
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.znicz import gemm as jgemm
from veles_tpu_torch.znicz import gemm as tgemm


def _weights(seed, k, n):
    w = numpy.random.RandomState(seed).standard_normal((k, n)) * 2.0
    w = w.astype(numpy.float32)
    w[:, 3] = 0.0                          # an all-zero output channel
    return w


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_weight_bytes_identical_to_jax(dtype):
    w = _weights(0, 300, 70)
    q_t, s_t = tgemm.quantize_weight(torch.from_numpy(w), dtype)
    q_j, s_j = jgemm.quantize_weight(jnp.asarray(w), dtype)
    q_j = numpy.asarray(q_j)
    assert q_t.dtype == (torch.int8 if dtype == "int8"
                         else tgemm.fp8_dtype())
    assert numpy.array_equal(q_t.view(torch.uint8).numpy(),
                             q_j.view(numpy.uint8))
    assert numpy.array_equal(s_t.numpy(), numpy.asarray(s_j))


@pytest.mark.parametrize("shape", [(5, 300, 70), (1, 64, 128),
                                   (33, 17, 9)])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_matmul_matches_jax(shape, dtype):
    m, k, n = shape
    rng = numpy.random.RandomState(m * k + n)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    w = _weights(k, k, n)
    q_j, s_j = jgemm.quantize_weight(jnp.asarray(w), dtype)
    kernel = numpy.asarray(jgemm.quantized_matmul(jnp.asarray(a), q_j, s_j))
    ref = numpy.asarray(jgemm.quantized_matmul_reference(jnp.asarray(a),
                                                         q_j, s_j))
    q_t, s_t = tgemm.quantize_weight(torch.from_numpy(w), dtype)
    before = tgemm.quantized_matmul.launches
    out = tgemm.quantized_matmul(torch.from_numpy(a), q_t, s_t).numpy()
    assert tgemm.quantized_matmul.launches == before   # CPU: no kernel
    assert out.shape == (m, n)
    scale = numpy.abs(ref).max()
    assert numpy.abs(out - kernel).max() <= 1e-5 * scale
    assert numpy.abs(out - ref).max() <= 1e-5 * scale


def test_argument_checks():
    a = torch.ones((4, 8))
    q, s = tgemm.quantize_weight(torch.ones((8, 6)))
    with pytest.raises(ValueError):
        tgemm.quantized_matmul(a, q[:7], s)             # K mismatch
    with pytest.raises(ValueError):
        tgemm.quantized_matmul(a, q, s[:5])             # scales shape
    with pytest.raises(ValueError):
        tgemm.quantized_matmul(a, q.to(torch.float32), s)   # not quantized
    with pytest.raises(ValueError):
        tgemm.quantize_weight(torch.ones((2, 3, 4)))    # not [K, N]
    with pytest.raises(ValueError):
        tgemm.quantize_weight(torch.ones((2, 3)), "int4")


# -- 2xTF32, as K3 forms its products on the card -----------------------------

#: the depth of a stage of K3 on the card: the span its tensor cores
#: accumulate before the stage's partial joins the IEEE f32 sum
_K3_STAGE = 64


def _tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero, on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _int8_upcast(q):
    """The kernel's int8 upcast: the byte plus 128 under the exponent
    of 2^23 (``0x4b0000xx``), less ``2^23 + 128``."""
    biased = (q.to(torch.int32) & 0xFF) ^ 0x80
    return (biased | 0x4B000000).view(torch.float32) - 8388736.0


def _tf32x2_matmul(a, w_q, scales, k_split=None):
    """The card's K3 in plain PyTorch: ``a = hi + lo`` (``hi =
    tf32(a)``, ``lo = tf32(a - hi)``), the weights exact in TF32; each
    8-deep step adds ``a_lo w`` and then ``a_hi w`` to the partial of
    its 64-deep stage, each stage's partial is added to the f32 sum of
    the K range; ranges of ``k_split`` columns are added in K order,
    then the scales multiply."""
    w = (_int8_upcast(w_q) if w_q.dtype == torch.int8
         else w_q.to(torch.float32))
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    m, k = a.shape
    k_split = k_split or k
    total = None
    for k0 in range(0, k, k_split):
        end = min(k0 + k_split, k)
        acc = torch.zeros((m, w.shape[1]), dtype=torch.float32)
        for s0 in range(k0, end, _K3_STAGE):
            p = torch.zeros_like(acc)
            for s in range(s0, min(s0 + _K3_STAGE, end), 8):
                t = slice(s, min(s + 8, end))
                p = p + a_lo[:, t] @ w[t]
                p = p + a_hi[:, t] @ w[t]
            acc = acc + p
        total = acc if total is None else total + acc
    return total * scales[None, :]


def test_quantized_weights_are_exact_in_tf32():
    """Every int8 value and every finite float8-e4m3 bit pattern
    (subnormals included) is a fixed point of the TF32 rounding, so
    3xTF32's ``a_hi w_lo`` term is zero and two passes are exact."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    x = q.to(torch.float32)
    assert torch.equal(_tf32(x), x)
    assert torch.equal(_int8_upcast(q), x)
    f8 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        tgemm.fp8_dtype()).to(torch.float32)
    finite = torch.isfinite(f8)
    assert int(finite.sum()) == 254            # 0x7f and 0xff are NaN
    assert float(f8[1]) == 2.0 ** -9           # the smallest subnormal
    assert torch.equal(_tf32(f8[finite]), f8[finite])


@pytest.mark.parametrize("shape,k_split", [
    ((16, 4096, 4096), 512),     # the decode shape, split 8 ways on the card
    ((256, 1024, 512), None), ((256, 1024, 512), 512),
    ((5, 300, 70), None), ((5, 300, 70), 128),   # a partial last stage
    ((33, 17, 9), None)])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_tf32x2_products_hold_the_kernel_tolerance(shape, k_split, dtype):
    m, k, n = shape
    rng = numpy.random.RandomState(m + k + n)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    w = _weights(k + n, k, n)
    q_j, s_j = jgemm.quantize_weight(jnp.asarray(w), dtype)
    ref = numpy.asarray(jgemm.quantized_matmul_reference(jnp.asarray(a),
                                                         q_j, s_j))
    q_t, s_t = tgemm.quantize_weight(torch.from_numpy(w), dtype)
    got = _tf32x2_matmul(torch.from_numpy(a), q_t, s_t, k_split).numpy()
    assert numpy.all(got[:, 3] == 0)           # the all-zero channel
    assert numpy.abs(got - ref).max() <= 1e-5 * numpy.abs(ref).max()
