"""Seeded random generators with snapshot-safe state.

The port's counterpart of ``veles_tpu/prng/random_generator.py``:

- :class:`RandomGenerator` (a re-design of the reference's
  RandomGenerator, veles/prng/random_generator.py:64: a numpy
  RandomState wrapper with state save/restore and global keyed
  instances).  Seeded alike, it gives the JAX package's bytes: initial
  weights and shuffle orders are equal in the two packages.
- :class:`KeyTree` and the stateless keys of stochastic units (dropout):
  ``jax.random``'s default threefry2x32 generator in torch integer ops,
  so the same key gives the JAX package's bits.  A key is a pair of
  32-bit words held as Python ints (:func:`key`, :func:`fold_in`),
  derived on the host; :func:`random_bits`, :func:`uniform` and
  :func:`bernoulli` draw per-element bits on their ``device`` (the card
  unless the CPU is asked for), in int64 tensors masked to 32 bits (all values
  non-negative, so every right shift is a logical one), and the CPU and
  the card give the same bits.  The element counters are those of
  ``jax_threefry_partitionable=True`` (the default of jax 0.9): element
  ``i`` of the flattened shape hashes the words ``(i >> 32, i & mask)``,
  and its 32-bit draw is the xor of the two output words.
"""

import threading
import zlib

import numpy
import torch

from ..device import resolve_device


class RandomGenerator:
    """Deterministic numpy generator with pickle-able state."""

    def __init__(self, key=None):
        self.key = key
        self._state = numpy.random.RandomState()
        self._seed_value = None

    def seed(self, seed, dtype=None, count=None):
        """Seed from an int, bytes, or an array (the reference accepts raw
        seed files and hex strings, __main__.py:483-539)."""
        if isinstance(seed, (bytes, bytearray)):
            pad = (-len(seed)) % 4
            seed = numpy.frombuffer(bytes(seed) + b"\0" * pad,
                                    dtype=numpy.uint32)
        if isinstance(seed, numpy.ndarray):
            raw = seed.tobytes()
            raw += b"\0" * ((-len(raw)) % 4)
            seed = int(numpy.bitwise_xor.reduce(
                numpy.frombuffer(raw, numpy.uint32)))
        self._seed_value = int(seed) & 0xFFFFFFFF
        self._state = numpy.random.RandomState(self._seed_value)
        return self

    @property
    def seed_value(self):
        return self._seed_value

    # numpy-compatible sampling surface -------------------------------------
    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._state.normal(loc, scale, size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._state.uniform(low, high, size)

    def randint(self, low, high=None, size=None, dtype=int):
        return self._state.randint(low, high, size, dtype)

    def shuffle(self, arr):
        self._state.shuffle(arr)

    def permutation(self, n):
        return self._state.permutation(n)

    def choice(self, a, size=None, replace=True, p=None):
        return self._state.choice(a, size, replace, p)

    def bytes(self, n):
        return self._state.bytes(n)

    def fill(self, arr, vmin=-1.0, vmax=1.0):
        """In-place uniform fill (reference RandomGenerator.fill)."""
        arr[...] = self._state.uniform(vmin, vmax, arr.shape).astype(
            arr.dtype)

    # state save/restore (snapshot determinism) ------------------------------
    @property
    def state(self):
        return self._state.get_state()

    @state.setter
    def state(self, value):
        self._state.set_state(value)

    def __getstate__(self):
        return {"key": self.key, "seed": self._seed_value,
                "state": self._state.get_state()}

    def __setstate__(self, state):
        self.key = state["key"]
        self._seed_value = state["seed"]
        self._state = numpy.random.RandomState()
        self._state.set_state(state["state"])


_lock = threading.Lock()
_generators = {}


def get(key=0):
    """Global keyed generator instances (reference ``prng.get(n)``)."""
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = _generators[key] = RandomGenerator(key)
            gen.seed(42 + (key if isinstance(key, int)
                           else zlib.crc32(str(key).encode())))
        return gen


# -- stateless keys: threefry2x32, jax.random's default generator -------------

_MASK = 0xFFFFFFFF
#: rotation constants of Threefry-2x32, 20 rounds (Salmon et al., 2011)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r):
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key words ``(k0, k1)``: Python ints in ``[0, 2**32)`` or int64
    tensors holding such values (the key words are ints).  Returns the
    two output words alike."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed):
    """``jax.random.key(seed)`` as its two words: ``(0, seed mod 2**32)``
    (the JAX package runs with 32-bit integers, so a seed's high word is
    always 0)."""
    return (0, int(seed) & _MASK)


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: the key hashed with the counter
    ``(0, data)``; ``data`` in ``[0, 2**32)`` as JAX requires."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError("fold_in data %d is out of the uint32 range" % data)
    return threefry2x32(k[0], k[1], 0, data)


def random_bits(k, shape, device=None):
    """``jax.random.bits(k, shape, uint32)`` as an int64 tensor of
    ``shape`` on ``device`` (values in ``[0, 2**32)``; default: the
    card, and no card raises unless ``device="cpu"``)."""
    shape = tuple(int(d) for d in shape)
    idx = torch.arange(int(numpy.prod(shape)), dtype=torch.int64,
                       device=resolve_device(device))
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(shape)


def uniform(k, shape, device=None):
    """``jax.random.uniform(k, shape)`` (f32 in ``[0, 1)``): the top 23
    bits of each draw as the mantissa of a float in ``[1, 2)``, minus 1."""
    bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k, p, shape, device=None):
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p``, with ``p``
    rounded to f32 as JAX compares it."""
    return uniform(k, shape, device) < float(numpy.float32(p))


class KeyTree:
    """Stateless keys for units: ``key = fold_in(fold_in(key(seed),
    crc32(name) & 0x7fffffff), step)``, the JAX package's derivation.

    The per-unit step counters are plain ints, so they pickle with the
    workflow snapshot and restore deterministic randomness on resume.
    """

    def __init__(self, seed=42):
        self.seed = int(seed)
        self.counters = {}

    def key_for(self, name, advance=True):
        c = self.counters.get(name, 0)
        if advance:
            self.counters[name] = c + 1
        k = fold_in(key(self.seed),
                    zlib.crc32(str(name).encode()) & 0x7FFFFFFF)
        return fold_in(k, c)

    def __getstate__(self):
        return {"seed": self.seed, "counters": dict(self.counters)}

    def __setstate__(self, state):
        self.seed = state["seed"]
        self.counters = state["counters"]
