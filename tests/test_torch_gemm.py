"""The weight-quantized GEMM: the PyTorch port against the JAX package.

``quantize_weight`` must give the JAX package's int8 and float8-e4m3
bytes and scales exactly (int8 rounds half to even; the fp8 cast rounds
to nearest even in both).  The port's ``quantized_matmul`` (its plain
version, on CPU tensors) matches JAX's ``quantized_matmul`` (the Pallas
kernel in interpret mode) and its staged reference at ``rtol=1e-5`` of
the largest output, on shapes that are not tile multiples.
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
