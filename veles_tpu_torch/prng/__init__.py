"""Reproducible random number generation (the port's counterpart of
``veles_tpu.prng``; reference veles/prng/, ``prng.get(n)``)."""

from .random_generator import (  # noqa: F401
    RandomGenerator, get, KeyTree, key, fold_in, split, random_bits,
    uniform, bernoulli, gumbel, categorical)
