"""The port's threefry keys and bits against ``jax.random``, bit for bit.

- ``key``, ``fold_in`` and ``KeyTree.key_for`` give the words of
  ``jax.random.key_data`` for the same seeds, data and unit names.
- ``random_bits``, ``uniform`` and ``bernoulli`` give the bits of
  ``jax.random.bits`` / ``uniform`` / ``bernoulli`` for several keys and
  shapes: odd sizes, several axes, and more than 2**16 elements.  This
  is what the installed jax does, so the counter layout
  (``jax_threefry_partitionable``) is checked, not assumed.
- The bits do not depend on how the shape is split into axes: element
  ``i`` of the flattened shape hashes the counter ``i``.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu_torch import prng

SEEDS = [0, 42, 12345, 2 ** 31 - 1, 2 ** 32 + 3, -5]
SHAPES = [(1,), (5,), (3, 7), (2, 3, 5), (70001,), (128, 4096)]


def _words(k):
    return tuple(numpy.asarray(jax.random.key_data(k)).tolist())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_equal_jax(seed):
    jk = jax.random.key(seed)
    assert prng.key(seed) == _words(jk)
    for data in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        assert prng.fold_in(prng.key(seed), data) == \
            _words(jax.random.fold_in(jk, data))
    with pytest.raises(ValueError):
        prng.fold_in(prng.key(seed), -1)


def test_key_tree_equals_jax_key_tree():
    from veles_tpu.prng.random_generator import KeyTree as JaxKeyTree
    for seed in (42, 9):
        jt, pt = JaxKeyTree(seed), prng.KeyTree(seed)
        for name in ("dropout", "dropout", "pool_7", "dropout"):
            assert pt.key_for(name) == _words(jt.key_for(name))
        assert pt.key_for("x", advance=False) == \
            _words(jt.key_for("x", advance=False))
        assert pt.counters == jt.counters
        clone = prng.KeyTree()
        clone.__setstate__(pt.__getstate__())
        assert clone.key_for("dropout") == pt.key_for("dropout")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1234567])
def test_bits_uniform_bernoulli_equal_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    k = prng.fold_in(prng.key(seed), 5)
    bits = prng.random_bits(k, shape, "cpu")
    assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
    want = numpy.asarray(jax.random.bits(jk, shape, jnp.uint32))
    assert numpy.array_equal(bits.numpy(), want.astype(numpy.int64))
    u = prng.uniform(k, shape, "cpu")
    assert u.dtype == torch.float32
    assert u.numpy().tobytes() == \
        numpy.asarray(jax.random.uniform(jk, shape)).tobytes()
    for p in (0.5, 0.1, 0.7):
        assert numpy.array_equal(
            prng.bernoulli(k, p, shape, "cpu").numpy(),
            numpy.asarray(jax.random.bernoulli(jk, p, shape)))


def test_bits_follow_the_flat_index():
    k = prng.key(3)
    flat = prng.random_bits(k, (60,), "cpu")
    for shape in ((3, 4, 5), (6, 10)):
        assert torch.equal(prng.random_bits(k, shape, "cpu").reshape(-1),
                           flat)
