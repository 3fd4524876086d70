"""Pooling forward units.

The port's counterpart of ``veles_tpu/znicz/pooling.py``: MaxPooling,
AvgPooling and MaxAbsPooling over NHWC inputs, on ``F.max_pool2d`` /
``F.avg_pool2d`` of the channels_last NCHW view (no copy in, none out);
autograd gives the backward (the argmax scatter of max pooling).

- Max pads with ``-inf``, explicitly (``F.pad``) where there is padding:
  ``max_pool2d`` refuses a padding larger than half the window, which
  the JAX unit allows.
- Avg divides each window's sum by its count of in-bounds elements (the
  JAX unit's ``_window_counts``, ``count_include_pad=False``): the sum
  is ``avg_pool2d`` with ``divisor_override=1`` over a zero-padded
  input, the counts a ``[1, oh, ow, 1]`` tensor from the geometry.
- MaxAbs keeps the signed value whose magnitude wins, ``|hi| >= |lo|``
  (the Znicz semantic), from a max and a min pooling.

Not ported: the JAX ``MaxPooling``'s ``pool_separable`` and
``pool_bf16`` knobs (TPU layout experiments; set, they raise here),
``fast_max_pool``, and the stochastic pooling and depooling units.
"""

import numpy
import torch
import torch.nn.functional as F

from ..config import root
from .conv import nchw, nhwc, quad
from .nn_units import ParamlessForward

__all__ = ["PoolingBase", "MaxPooling", "AvgPooling", "MaxAbsPooling"]


class PoolingBase(ParamlessForward):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.sliding = tuple(kwargs.get("sliding", (self.ky, self.kx)))
        self.padding = quad(kwargs.get("padding", 0))
        eng = root.common.engine
        for knob in ("pool_separable", "pool_bf16"):
            if kwargs.get(knob, eng.get(knob, False)):
                raise NotImplementedError("%s is not ported" % knob)

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        pt, pb, pl, pr = self.padding
        oh = (h + pt + pb - self.ky) // self.sliding[0] + 1
        ow = (w + pl + pr - self.kx) // self.sliding[1] + 1
        return (b, oh, ow, c)

    def export_params(self):
        return {"kx": int(self.kx), "ky": int(self.ky),
                "padding": list(self.padding),
                "sliding": list(self.sliding)}

    def _padded(self, x, value):
        """The NCHW view of ``x``, padded with ``value`` where the unit
        pads."""
        xc = nchw(x)
        if any(self.padding):
            pt, pb, pl, pr = self.padding
            xc = F.pad(xc, (pl, pr, pt, pb), value=value)
        return xc

    def _max(self, x):
        """Max over each window of ``x`` (NHWC), ``-inf`` padding."""
        return nhwc(F.max_pool2d(self._padded(x, -numpy.inf),
                                 (self.ky, self.kx), self.sliding))


class MaxPooling(PoolingBase):
    MAPPING = "max_pooling"

    def apply(self, params, x):
        return self._max(x)


class AvgPooling(PoolingBase):
    MAPPING = "avg_pooling"

    def _window_counts(self, xshape, device):
        """[1, oh, ow, 1] in-bounds element counts of the windows."""
        _, h, w, _ = xshape
        key = (h, w, str(device))
        cached = getattr(self, "_counts_cache_", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        oh, ow = self.output_shape_for(xshape)[1:3]
        pt, _, pl, _ = self.padding

        def inside(out, size, k, stride, pad):
            lo = numpy.arange(out) * stride - pad
            return (numpy.minimum(lo + k, size) -
                    numpy.maximum(lo, 0)).astype(numpy.float32)

        counts = numpy.outer(inside(oh, h, self.ky, self.sliding[0], pt),
                             inside(ow, w, self.kx, self.sliding[1], pl))
        counts = torch.from_numpy(counts[None, :, :, None]).to(device)
        self._counts_cache_ = (key, counts)
        return counts

    def apply(self, params, x):
        s = F.avg_pool2d(self._padded(x, 0.0), (self.ky, self.kx),
                         self.sliding, divisor_override=1)
        return nhwc(s) / self._window_counts(x.shape, x.device)


class MaxAbsPooling(PoolingBase):
    """Keeps the signed value with the largest magnitude (Znicz
    semantics)."""

    MAPPING = "maxabs_pooling"

    def apply(self, params, x):
        hi = self._max(x)
        lo = -self._max(-x)
        return torch.where(hi.abs() >= lo.abs(), hi, lo)
