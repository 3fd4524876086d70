"""Gradient-descent units for the conv family.

The port's counterpart of ``veles_tpu/znicz/gd_conv.py``:
GradientDescentConv and its activation variants.  They own the layer's
hyperparameters and solver state, which the fused train step reads; its
autograd differentiates the forward (cuDNN's data and weight gradient
convolutions on the card).  ``backward``, graph mode's, is the vjp of
the forward, ``(err_input, {name: grad / n_valid})``, as the JAX units'
``jax.vjp``.
"""

from .nn_units import VJPBackward

__all__ = ["GradientDescentConv", "GDTanhConv", "GDSigmoidConv",
           "GDRELUConv", "GDStrictRELUConv"]


class GradientDescentConv(VJPBackward):
    MAPPING = "conv"


class GDTanhConv(GradientDescentConv):
    MAPPING = "conv_tanh"


class GDSigmoidConv(GradientDescentConv):
    MAPPING = "conv_sigmoid"


class GDRELUConv(GradientDescentConv):
    MAPPING = "conv_relu"


class GDStrictRELUConv(GradientDescentConv):
    MAPPING = "conv_str"
