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
- Stochastic pooling (Zeiler & Fergus) weighs each window element by
  its magnitude, ``max(p, 0)`` or, for the Abs units, ``|p|``, over the
  window's sum (``1 / k`` each where the sum is 0).  Eval mode outputs
  the probability-weighted mean; a train step draws one element a
  window with :func:`veles_tpu_torch.prng.categorical` (the bits of
  ``jax.random.categorical`` for the same key) over the JAX unit's
  transposed logits ``(b, oh, ow, c, k)``.  The depooling variants put
  the windows back in the input's shape (non-overlapping windows).
  Window sums run in window order, as XLA sums them.  The weights'
  gradients at exact zeros (which strict-RELU convolutions give often)
  are ``jnp``'s: ``torch.maximum`` against a zero tensor splits a tie in
  two as ``jnp.maximum`` does, and the magnitude is ``where(p >= 0, p,
  -p)``, whose derivative at ±0 is 1 as ``jnp.abs``'s is (``torch.abs``'s
  is 0 there).

Not ported: the JAX ``MaxPooling``'s ``pool_separable`` and
``pool_bf16`` knobs (TPU layout experiments; set, they raise here) and
``fast_max_pool``.  The plain ``Depooling`` is in :mod:`.misc_units`.
"""

import numpy
import torch
import torch.nn.functional as F

from .. import prng
from ..config import root
from .conv import nchw, nhwc, quad
from .nn_units import ParamlessForward

__all__ = ["PoolingBase", "MaxPooling", "AvgPooling", "MaxAbsPooling",
           "StochasticPoolingBase", "StochasticPooling",
           "StochasticAbsPooling", "StochasticPoolingDepooling",
           "StochasticAbsPoolingDepooling"]


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


def _window_sum(t):
    """``t`` summed over its window axis 3, one window element after the
    other (XLA's order for the JAX unit's ``sum(axis=3)``)."""
    total = t[:, :, :, 0]
    for j in range(1, t.shape[3]):
        total = total + t[:, :, :, j]
    return total


class StochasticPoolingBase(PoolingBase):
    """Samples a window element with probability proportional to its
    (abs) value at train time (``apply_train(params, x, key)``); at eval
    time outputs the probability-weighted mean (Zeiler & Fergus)."""

    hide_from_registry = True
    stochastic = True
    ABS = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.key_tree = kwargs.get("key_tree") or prng.KeyTree(
            kwargs.get("seed", 42))
        self.last_key = None

    def _patches(self, x):
        """``(b, oh, ow, ky * kx, c)``: the zero-padded input's window
        element ``(dy, dx)`` of every window position on axis 3.  The
        slices run ``output_shape_for``'s count of strides, clipped at
        the padded input's end, as the JAX unit's do (the depooling
        variants' output shape is the input's)."""
        oh, ow = self.output_shape_for(x.shape)[1:3]
        if any(self.padding):
            pt, pb, pl, pr = self.padding
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
        sy, sx = self.sliding
        return torch.stack([x[:, dy:dy + oh * sy:sy, dx:dx + ow * sx:sx, :]
                            for dy in range(self.ky)
                            for dx in range(self.kx)], dim=3)

    def _probs(self, p):
        # + 0.0 turns the -0 of -(-0) into |-0| = +0
        mag = torch.where(p >= 0, p, -p) + 0.0 if self.ABS else \
            torch.maximum(p, p.new_zeros(()))
        total = _window_sum(mag).unsqueeze(3)
        return torch.where(total > 0, mag / total.clamp_min(1e-30),
                           1.0 / p.shape[3])

    def _choice(self, p, key):
        """The window element drawn for each ``(b, oh, ow, c)``:
        ``categorical`` over ``log(probs + 1e-30)`` transposed to
        ``(b, oh, ow, c, k)``, the JAX unit's order of draws."""
        with torch.no_grad():
            logits = torch.log(self._probs(p.detach()) + 1e-30)
            return prng.categorical(key, logits.permute(0, 1, 2, 4, 3))

    def apply(self, params, x):
        """Eval mode: the probability-weighted mean over the window."""
        p = self._patches(x)
        return _window_sum(p * self._probs(p))

    def apply_train(self, params, x, key):
        """One window element drawn for each output, ∝ its weight."""
        self.last_key = key
        p = self._patches(x)
        return torch.gather(p, 3, self._choice(p, key).unsqueeze(3)) \
            .squeeze(3)


class StochasticPooling(StochasticPoolingBase):
    MAPPING = "stochastic_pooling"
    ABS = False


class StochasticAbsPooling(StochasticPoolingBase):
    MAPPING = "stochastic_abs_pooling"
    ABS = True


class StochasticPoolingDepooling(StochasticPooling):
    """Pools stochastically and depools at once into the input's shape
    (the Znicz conv autoencoders)."""

    MAPPING = "stochastic_pool_depool"

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def apply(self, params, x):
        """Eval: each element weighted by its probability, in place."""
        p = self._patches(x)
        return self._scatter_back(p * self._probs(p), x)

    def apply_train(self, params, x, key):
        """The drawn element of each window kept in place, the others
        zeroed (``p * one_hot``: a negative element's zero is -0)."""
        self.last_key = key
        p = self._patches(x)
        mask = F.one_hot(self._choice(p, key), p.shape[3]).to(x.dtype)
        return self._scatter_back(p * mask.permute(0, 1, 2, 4, 3), x)

    def _scatter_back(self, kept, x):
        """The windows ``(b, oh, ow, ky * kx, c)`` back in the input's
        layout (sliding equal to the window), cropped to its shape."""
        b, oh, ow, _, c = kept.shape
        kept = kept.reshape(b, oh, ow, self.ky, self.kx, c)
        kept = kept.permute(0, 1, 3, 2, 4, 5).reshape(
            b, oh * self.ky, ow * self.kx, c)
        return kept[:, :x.shape[1], :x.shape[2], :]


class StochasticAbsPoolingDepooling(StochasticPoolingDepooling):
    MAPPING = "stochastic_abs_pool_depool"
    ABS = True
