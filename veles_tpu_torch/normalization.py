"""Feature normalizers with a streaming analyze pass.

The port's copy of the part of ``veles_tpu/normalization.py`` (a
re-design of the reference's normalizers, veles/normalization.py) that
the samples' loaders need: ``none``, ``range_linear`` (MNIST, the LRN
convnet) and ``internal_mean`` (the CIFAR sample's default).  The
contract is the same: ``analyze(batch)`` accumulates statistics over a
streaming pass and ``normalize(data)`` mutates a numpy array in place.
Normalization runs once, host-side, when the loader bakes it into the
resident dataset, so there is no tensor form.  The other families
(``mean_disp``, ``linear``, ``exp``, ``pointwise``, ``external_mean``),
``denormalize`` and the snapshot ``state`` wait for the loaders and the
snapshotter that use them.
"""

import numpy

from .registry import MappedObjectsRegistry

__all__ = ["NormalizerBase", "StatelessNormalizer", "NoneNormalizer",
           "RangeLinearNormalizer", "InternalMeanNormalizer", "factory"]


class NormalizerBase(metaclass=MappedObjectsRegistry):
    """Base: streaming analyze + in-place normalize."""

    mapping = "normalizer"

    def __init__(self, **kwargs):
        self._initialized = False

    # -- streaming analysis --------------------------------------------------
    def analyze(self, data):
        data = numpy.asarray(data)
        if not self._initialized:
            self._initialize(data)
            self._initialized = True
        self._analyze(data)

    def _initialize(self, data):
        pass

    def _analyze(self, data):
        pass

    # -- application ---------------------------------------------------------
    def normalize(self, data):
        raise NotImplementedError


class StatelessNormalizer(NormalizerBase):
    """analyze() is a no-op (reference normalization.py:260-282)."""

    def analyze(self, data):
        self._initialized = True


class NoneNormalizer(StatelessNormalizer):
    MAPPING = "none"

    def normalize(self, data):
        return data


class RangeLinearNormalizer(NormalizerBase):
    """Linear map of the *global* [min, max] (from analyze) onto ``interval``
    (reference normalization.py:398-464)."""

    MAPPING = "range_linear"

    def __init__(self, interval=(-1, 1), **kwargs):
        super().__init__(**kwargs)
        self.interval = (float(interval[0]), float(interval[1]))

    def _initialize(self, data):
        self._min = float(numpy.min(data))
        self._max = float(numpy.max(data))

    def _analyze(self, data):
        self._min = min(self._min, float(numpy.min(data)))
        self._max = max(self._max, float(numpy.max(data)))

    def normalize(self, data):
        imin, imax = self.interval
        diff = self._max - self._min or 1.0
        data -= self._min
        data *= (imax - imin) / diff
        data += imin
        return data


class InternalMeanNormalizer(NormalizerBase):
    """Subtract the mean sample of the analyze pass, then scale
    (reference normalization.py:636-660)."""

    MAPPING = "internal_mean"

    def __init__(self, scale=1.0, **kwargs):
        super().__init__(**kwargs)
        self.scale = float(scale)

    def _initialize(self, data):
        self._sum = numpy.zeros_like(data[0], dtype=numpy.float64)
        self._count = 0

    def _analyze(self, data):
        self._sum += numpy.sum(data, axis=0, dtype=numpy.float64)
        self._count += data.shape[0]

    @property
    def mean(self):
        return self._sum / self._count

    def normalize(self, data):
        data -= self.mean
        if self.scale != 1.0:
            data *= self.scale
        return data


def factory(name, **kwargs):
    """Instantiate a normalizer by MAPPING key."""
    return MappedObjectsRegistry.get("normalizer", name)(**kwargs)
