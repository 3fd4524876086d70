"""Seeded random generators with snapshot-safe state.

The port's copy of the numpy half of ``veles_tpu/prng/random_generator.py``
(a re-design of the reference's RandomGenerator,
veles/prng/random_generator.py:64: a numpy RandomState wrapper with state
save/restore and global keyed instances).  Seeded alike, it gives the
JAX package's bytes: initial weights and shuffle orders are equal in the
two packages.  ``KeyTree`` (stateless JAX keys for stochastic units)
waits for the first stochastic unit of the port.
"""

import threading

import numpy


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
            import zlib
            gen = _generators[key] = RandomGenerator(key)
            gen.seed(42 + (key if isinstance(key, int)
                           else zlib.crc32(str(key).encode())))
        return gen
