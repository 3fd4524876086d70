"""Feature normalizers with a streaming analyze pass.

The port's copy of the part of ``veles_tpu/normalization.py`` (a
re-design of the reference's normalizers, veles/normalization.py) that
the samples' loaders need: ``none``, ``range_linear`` (MNIST, the LRN
convnet), ``internal_mean`` (the CIFAR sample's default) and
``mean_disp`` (the JAX loader tests' normalizer).  The
contract is the same: ``analyze(batch)`` accumulates statistics over a
streaming pass and ``normalize(data)`` mutates a numpy array in place.
Normalization runs host-side, once when a FullBatchLoader bakes it
into the resident dataset, or on each minibatch of a
ShardedBatchLoader, so there is no tensor form.  A normalizer pickles
with its statistics, and ``state`` reads or sets them (JAX
``normalization.py:70-92``): a restored loader applies the snapshot's
statistics instead of analyzing again.  The other families
(``linear``, ``exp``, ``pointwise``, ``external_mean``) and
``denormalize`` wait for the loaders that use them.
"""

import numpy

from .registry import MappedObjectsRegistry

__all__ = ["UninitializedStateError", "NormalizerBase", "StatelessNormalizer", "NoneNormalizer",
           "RangeLinearNormalizer", "InternalMeanNormalizer",
           "MeanDispersionNormalizer", "factory"]


class UninitializedStateError(Exception):
    pass


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

    # -- snapshot state ------------------------------------------------------
    @property
    def state(self):
        if not self._initialized and self._has_state():
            raise UninitializedStateError(
                "uninitialized normalizers have no state")
        return {k: v for k, v in self.__dict__.items()
                if k != "_initialized"}

    @state.setter
    def state(self, value):
        if not isinstance(value, dict):
            raise TypeError("state must be a dict")
        self.__dict__.update(value)
        self._initialized = True

    def _has_state(self):
        return True

    def __getstate__(self):
        return dict(self.__dict__)

    def __setstate__(self, state):
        self.__dict__.update(state)


class StatelessNormalizer(NormalizerBase):
    """analyze() is a no-op (reference normalization.py:260-282)."""

    def analyze(self, data):
        self._initialized = True

    def _has_state(self):
        return False


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


class MeanDispersionNormalizer(NormalizerBase):
    """(x - mean) / (max - min), featurewise over the analyze pass (the
    reference's normalization.py:284-319: "dispersion" is the max-min
    spread, not the variance)."""

    MAPPING = "mean_disp"

    def _initialize(self, data):
        self._sum = numpy.zeros_like(data[0], dtype=numpy.float64)
        self._count = 0
        self._min = numpy.array(data[0], dtype=numpy.float64)
        self._max = numpy.array(data[0], dtype=numpy.float64)

    def _analyze(self, data):
        self._count += data.shape[0]
        self._sum += numpy.sum(data, axis=0, dtype=numpy.float64)
        numpy.minimum(self._min, data.min(axis=0), self._min)
        numpy.maximum(self._max, data.max(axis=0), self._max)

    @property
    def coefficients(self):
        mean = self._sum / self._count
        disp = self._max - self._min
        return mean, numpy.where(disp == 0, 1.0, disp)

    def normalize(self, data):
        mean, disp = self.coefficients
        data -= mean
        data /= disp
        return data


def factory(name, **kwargs):
    """Instantiate a normalizer by MAPPING key."""
    return MappedObjectsRegistry.get("normalizer", name)(**kwargs)
