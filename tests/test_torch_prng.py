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
- ``uniform(minval=tiny)`` gives ``jax.random.uniform``'s bits,
  ``gumbel`` is ``jax.random.gumbel`` within an ulp or two (``log`` is
  not XLA's to the last ulp), and ``categorical`` gives
  ``jax.random.categorical``'s choices: a choice may differ only at a
  near-tie (JAX's two largest perturbed logits within 1e-6 of the
  larger), and such draws are counted (``differing_draws`` in the junit
  record).  Of equal maxima the first wins, as in ``jnp.argmax``.
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


TINY = float(numpy.finfo(numpy.float32).tiny)
CATEGORICAL_SHAPES = [(7, 4), (2, 3, 5, 9), (4096, 9), (3, 25)]


def _categorical_logits(shape, seed):
    """``log(p + 1e-30)`` of window weights as the stochastic pooling
    units make them: Dirichlet rows with some categories at 0 and some
    rows uniform."""
    rng = numpy.random.RandomState(seed)
    p = rng.dirichlet(numpy.ones(shape[-1]), size=shape[:-1])
    p[rng.uniform(size=p.shape) < 0.2] = 0.0
    p[rng.uniform(size=shape[:-1]) < 0.1] = 1.0 / shape[-1]
    total = p.sum(axis=-1, keepdims=True)
    p = numpy.where(total > 0, p / numpy.maximum(total, 1e-30),
                    1.0 / shape[-1])
    return numpy.log(p.astype(numpy.float32) + numpy.float32(1e-30))


@pytest.mark.parametrize("shape", CATEGORICAL_SHAPES)
@pytest.mark.parametrize("seed", [0, 42])
def test_categorical_choices_equal_jax(seed, shape, record_property):
    logits = _categorical_logits(shape, seed)
    jk = jax.random.fold_in(jax.random.key(seed), 11)
    k = prng.fold_in(prng.key(seed), 11)
    u = prng.uniform(k, shape, "cpu", minval=TINY)
    assert u.numpy().tobytes() == numpy.asarray(jax.random.uniform(
        jk, shape, minval=TINY)).tobytes()
    want_g = numpy.asarray(jax.random.gumbel(jk, shape))
    numpy.testing.assert_allclose(prng.gumbel(k, shape, "cpu").numpy(),
                                  want_g, rtol=1e-6, atol=1e-6)
    got = prng.categorical(k, torch.from_numpy(logits))
    assert got.dtype == torch.int64 and tuple(got.shape) == shape[:-1]
    want = numpy.asarray(jax.random.categorical(jk, logits))
    perturbed = want_g + logits
    bad = numpy.argwhere(got.numpy() != want)
    for idx in map(tuple, bad):
        lo, hi = numpy.sort(perturbed[idx])[-2:]
        assert hi - lo <= 1e-6 * abs(hi), (idx, hi - lo)
    record_property("differing_draws", len(bad))


def test_categorical_takes_the_first_of_equal_maxima(monkeypatch):
    from veles_tpu_torch.prng import random_generator
    monkeypatch.setattr(random_generator, "gumbel",
                        lambda k, shape, device=None: torch.zeros(shape))
    logits = numpy.array([[0.0, 1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                          [-1.0, -3.0, -1.0, -1.0], [0.0, 0.0, 0.0, 7.0]],
                         numpy.float32)
    got = prng.categorical(prng.key(0), torch.from_numpy(logits))
    assert got.tolist() == numpy.asarray(
        jnp.argmax(logits, axis=-1)).tolist() == [1, 0, 0, 3]


def test_categorical_draws_on_its_logits_device_and_gumbel_on_the_card(
        monkeypatch):
    """``categorical`` draws where its logits are; ``gumbel`` without a
    device asks for the card, and raises without one."""
    got = prng.categorical(prng.key(1), torch.zeros((2, 3)))
    assert got.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.gumbel(prng.key(1), (2, 3))
    assert prng.gumbel(prng.key(1), (2, 3), "cpu").shape == (2, 3)
