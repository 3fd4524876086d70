"""Reproducible random number generation (the port's counterpart of
``veles_tpu.prng``; reference veles/prng/, ``prng.get(n)``)."""

from .random_generator import RandomGenerator, get  # noqa: F401
