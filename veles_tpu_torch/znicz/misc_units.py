"""Structural layer units: Cutter, ChannelSplitter / ChannelMerger,
ZeroFiller, Deconv, Depooling.

The port's counterpart of ``veles_tpu/znicz/misc_units.py`` (the Znicz
``cutter``, ``channel_splitting``, ``weights_zerofilling``, ``deconv`` /
``gd_deconv`` and ``depooling`` units), with its class names, MAPPINGs,
keyword arguments and defaults, over NHWC tensors.

- ``Cutter`` crops ``x[:, top:top + crop_h, left:left + crop_w, :]``;
  ``GDCutter`` pads the error back to the uncropped shape.
- ``ChannelSplitter`` turns ``[b, h, w, c]`` into ``[g, b, h, w, c/g]``
  (group ``i`` holds channels ``i*c/g .. (i+1)*c/g - 1``);
  ``ChannelMerger`` is its inverse.
- ``ZeroFiller`` is the identity forward; in graph mode its ``run`` also
  multiplies ``target_unit``'s weights by the block-diagonal
  ``make_mask``.  Fused builds refuse it (``StandardWorkflow``), as in
  the JAX package: the fused step never runs the unit.
- ``Deconv`` computes what the JAX unit's ``lax.conv_transpose(x, w,
  strides, ((pt, pb), (pl, pr)), transpose_kernel=False)`` computes:
  the cross-correlation of the HWIO kernel, unflipped, with the input
  dilated by ``sliding`` (zeros between the rows and columns) and padded
  by the quad, a negative pad cropping; here ``F.conv2d`` (cuDNN on the
  card, TF32 off) over that dilated, padded input.  Its output side is
  ``(h - 1) * s + pt + pb - k + 2``, which is what ``output_shape_for``
  returns here; the JAX unit's ``output_shape_for`` declares ``(h - 1) *
  s + k - pt - pb``, which agrees only where ``pt + pb = k - 1``.
  ``GDDeconv`` is the vjp of the forward.
- ``Depooling`` is nearest upsampling by ``(ky, kx)``.

``Depooling``, ``ChannelSplitter``, ``ChannelMerger`` and ``ZeroFiller``
register no GD unit: ``StandardWorkflow`` gives them
:class:`~.nn_units.GenericVJPBackward`.  None of these units records a
configuration for a package (the JAX units define no
``export_params``).  The JAX package runs all of them outside Pallas,
so none has a kernel of the port.
"""

import numpy
import torch
import torch.nn.functional as F

from .conv import nchw, nhwc, quad
from .nn_units import (ForwardBase, GradientDescentBase, ParamlessForward,
                       VJPBackward)

__all__ = ["Cutter", "GDCutter", "ChannelSplitter", "ChannelMerger",
           "ZeroFiller", "Deconv", "GDDeconv", "Depooling"]


class Cutter(ParamlessForward):
    """Crops a spatial region: y = x[:, top:top+h, left:left+w, :]."""

    MAPPING = "cutter"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.top = kwargs.get("top", 0)
        self.left = kwargs.get("left", 0)
        self.crop_h = kwargs["crop_h"]
        self.crop_w = kwargs["crop_w"]

    def output_shape_for(self, input_shape):
        return (input_shape[0], self.crop_h, self.crop_w, input_shape[3])

    def apply(self, params, x):
        return x[:, self.top:self.top + self.crop_h,
                 self.left:self.left + self.crop_w, :]


class GDCutter(GradientDescentBase):
    """Backward: pad the error back into the uncropped shape."""

    MAPPING = "cutter"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("learning_rate", 0.0)
        super().__init__(workflow, **kwargs)

    def backward(self, params, x, y, err_output, n_valid=None):
        cut = self.forward_unit
        return F.pad(err_output, (
            0, 0, cut.left, x.shape[2] - cut.left - cut.crop_w,
            cut.top, x.shape[1] - cut.top - cut.crop_h)), {}


class ChannelSplitter(ParamlessForward):
    """NHWC → the channel groups stacked on a new leading axis."""

    MAPPING = "channel_splitter"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.groups = kwargs.get("groups", 2)

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        return (self.groups, b, h, w, c // self.groups)

    def apply(self, params, x):
        b, h, w, c = x.shape
        g = self.groups
        return x.reshape(b, h, w, g, c // g).permute(3, 0, 1, 2, 4)


class ChannelMerger(ParamlessForward):
    """Inverse of ChannelSplitter."""

    MAPPING = "channel_merger"

    def output_shape_for(self, input_shape):
        g, b, h, w, cg = input_shape
        return (b, h, w, g * cg)

    def apply(self, params, x):
        g, b, h, w, cg = x.shape
        return x.permute(1, 2, 3, 0, 4).reshape(b, h, w, g * cg)


class ZeroFiller(ParamlessForward):
    """Identity forward whose graph-mode ``run`` zeroes a fixed mask of
    ``target_unit``'s weights (the Znicz grouping trick for AlexNet's
    split convolutions).  Graph mode only: use ``Conv(grouping=N)`` in
    fused workflows."""

    MAPPING = "zero_filler"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.target_unit = kwargs.get("target_unit")
        self.grouping = kwargs.get("grouping", 2)

    def apply(self, params, x):
        return x

    def make_mask(self, weights_shape):
        """Block-diagonal channel mask: group g of kernels sees only group
        g of input channels."""
        ky, kx, c_in, n_k = weights_shape
        g = self.grouping
        mask = numpy.zeros(weights_shape, numpy.float32)
        for i in range(g):
            mask[:, :, i * (c_in // g):(i + 1) * (c_in // g),
                 i * (n_k // g):(i + 1) * (n_k // g)] = 1
        return mask

    def run(self):
        """The identity forward, then the mask on the target's weights.
        The target's kept train graph holds the weights before the mask,
        so it is dropped: its GD unit differentiates the forward again
        with the masked weights, as the JAX GD unit's vjp does."""
        super().run()
        target = self.target_unit
        if target is None or not target.weights:
            return
        w = target.weights.devmem
        target.weights.devmem = w * torch.from_numpy(
            self.make_mask(tuple(w.shape))).to(w.device)
        target.vjp_state_ = None


class Deconv(ForwardBase):
    """Transposed convolution (the conv autoencoder's decoder).  Input
    NHWC; weights HWIO ``(ky, kx, C, n_kernels)``."""

    MAPPING = "deconv"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_kernels = kwargs["n_kernels"]    # output channels
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.padding = quad(kwargs.get("padding", 0))
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.include_bias = bool(kwargs.get("include_bias", False))

    def init_params(self):
        c_in = self.input_shape[-1]
        n_in = self.kx * self.ky * c_in
        stddev = self.weights_stddev or 1.0 / numpy.sqrt(n_in)
        self.fill_array(self.weights,
                        (self.ky, self.kx, c_in, self.n_kernels),
                        stddev, self.weights_filling)
        if self.include_bias:
            self.fill_array(self.bias, (self.n_kernels,),
                            self.bias_stddev or stddev, self.bias_filling)

    def output_shape_for(self, input_shape):
        """The shape ``apply`` computes (the JAX ``apply``'s, not what
        the JAX ``output_shape_for`` declares)."""
        b, h, w, _ = input_shape
        pt, pb, pl, pr = self.padding
        oh = (h - 1) * self.sliding[0] + pt + pb - self.ky + 2
        ow = (w - 1) * self.sliding[1] + pl + pr - self.kx + 2
        return (b, oh, ow, self.n_kernels)

    def apply(self, params, x):
        y = nhwc(F.conv2d(self._dilated(nchw(x)),
                          params["weights"].permute(3, 2, 0, 1)))
        if "bias" in params:
            y = y + params["bias"]
        return y

    def _dilated(self, xc):
        """``xc`` (NCHW) with ``sliding - 1`` zeros between its rows and
        columns, padded by the quad (a negative pad crops)."""
        sy, sx = self.sliding
        b, c, h, w = xc.shape
        if (sy, sx) != (1, 1):
            d = xc.new_zeros((b, c, (h - 1) * sy + 1, (w - 1) * sx + 1))
            d[:, :, ::sy, ::sx] = xc
            xc = d
        pt, pb, pl, pr = self.padding
        return F.pad(xc, (pl, pr, pt, pb))


class GDDeconv(VJPBackward):
    """Deconv's backward: the vjp of its ``apply``."""

    MAPPING = "deconv"


class Depooling(ParamlessForward):
    """Nearest upsampling by the pooling window (the conv autoencoders'
    depooling)."""

    MAPPING = "depooling"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx = kwargs.get("kx", 2)
        self.ky = kwargs.get("ky", 2)

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        return (b, h * self.ky, w * self.kx, c)

    def apply(self, params, x):
        return x.repeat_interleave(self.ky, dim=1).repeat_interleave(
            self.kx, dim=2)
