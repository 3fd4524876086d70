"""Convolutional forward units.

The port's counterpart of ``veles_tpu/znicz/conv.py`` (the Znicz conv
family; parameters n_kernels / kx / ky / padding / sliding / grouping).
Activations are NHWC and weights HWIO ``(ky, kx, C / grouping, K)``, the
JAX package's layouts, so parameters carry across unchanged.

``apply`` runs ``torch.nn.functional.conv2d`` (cuDNN on the card, TF32
off) on the NCHW view ``x.permute(0, 3, 1, 2)`` of the NHWC input: that
view is channels_last, so the input needs no copy, and the output,
channels_last too, is permuted back to NHWC.  ``grouping`` is
``conv2d``'s ``groups`` (AlexNet's two-tower split).  ``conv2d`` pads
symmetrically only, so an asymmetric ``(top, bottom, left, right)``
padding goes through ``F.pad`` first.  The JAX package computes the
convolution outside any Pallas kernel (``lax.conv_general_dilated``), so
there is no kernel of the port here; its unit's ``apply_numpy`` (an
im2col twin) is the tests' oracle.
"""

import numpy
import torch.nn.functional as F

from .nn_units import ForwardBase
from . import activations

__all__ = ["Conv", "ConvTanh", "ConvSigmoid", "ConvRELU", "ConvStrictRELU",
           "quad", "nchw", "nhwc"]


def quad(padding):
    """Normalize padding to (top, bottom, left, right)."""
    if isinstance(padding, int):
        return (padding,) * 4
    if len(padding) == 2:
        py, px = padding
        return (py, py, px, px)
    return tuple(padding)


def nchw(x):
    """The NCHW (channels_last) view of an NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def nhwc(y):
    """The NHWC view of an NCHW tensor (contiguous if ``y`` is
    channels_last)."""
    return y.permute(0, 2, 3, 1)


class Conv(ForwardBase):
    """2-D convolution + activation.  Input NHWC; weights
    (ky, kx, C / grouping, K)."""

    MAPPING = "conv"
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_kernels = kwargs["n_kernels"]
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        self.padding = quad(kwargs.get("padding", 0))
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.grouping = int(kwargs.get("grouping", 1))
        self.activation = activations.get(self.ACTIVATION)

    def init_params(self):
        c_in = self.input_shape[-1]
        n_in = self.kx * self.ky * c_in // self.grouping
        stddev = self.weights_stddev or 1.0 / numpy.sqrt(n_in)
        self.fill_array(self.weights,
                        (self.ky, self.kx, c_in // self.grouping,
                         self.n_kernels),
                        stddev, self.weights_filling)
        if self.include_bias:
            self.fill_array(self.bias, (self.n_kernels,),
                            self.bias_stddev or stddev, self.bias_filling)

    def output_shape_for(self, input_shape):
        b, h, w, _ = input_shape
        pt, pb, pl, pr = self.padding
        oh = (h + pt + pb - self.ky) // self.sliding[0] + 1
        ow = (w + pl + pr - self.kx) // self.sliding[1] + 1
        return (b, oh, ow, self.n_kernels)

    def apply(self, params, x):
        pt, pb, pl, pr = self.padding
        xc = nchw(x)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            pad = 0
        y = F.conv2d(xc, params["weights"].permute(3, 2, 0, 1),
                     params.get("bias"), stride=self.sliding, padding=pad,
                     groups=self.grouping)
        return self.activation.fwd(nhwc(y))

    def export_params(self):
        return {"n_kernels": int(self.n_kernels), "kx": int(self.kx),
                "ky": int(self.ky), "padding": list(self.padding),
                "sliding": list(self.sliding),
                "grouping": int(self.grouping),
                "include_bias": bool(self.include_bias)}


class ConvTanh(Conv):
    MAPPING = "conv_tanh"
    ACTIVATION = "tanh"


class ConvSigmoid(Conv):
    MAPPING = "conv_sigmoid"
    ACTIVATION = "sigmoid"


class ConvRELU(Conv):
    """Znicz "RELU" = softplus."""
    MAPPING = "conv_relu"
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    MAPPING = "conv_str"
    ACTIVATION = "strict_relu"
