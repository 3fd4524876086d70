"""Gradient-descent units for the conv family.

The port's counterpart of ``veles_tpu/znicz/gd_conv.py``:
GradientDescentConv and its activation variants.  They own the layer's
hyperparameters and solver state, which the fused train step reads; its
autograd differentiates the forward (cuDNN's data and weight gradient
convolutions on the card).  ``backward`` is the vjp of the forward,
``(err_input, {name: grad / n_valid})``.
"""

from .nn_units import GradientDescentBase

__all__ = ["GradientDescentConv", "GDTanhConv", "GDSigmoidConv",
           "GDRELUConv", "GDStrictRELUConv"]


class GradientDescentConv(GradientDescentBase):
    MAPPING = "conv"

    def backward(self, params, x, y, err_output, n_valid=None):
        if n_valid is None:
            n_valid = x.shape[0]
        return self.backward_via_vjp(params, x, err_output, n_valid)


class GDTanhConv(GradientDescentConv):
    MAPPING = "conv_tanh"


class GDSigmoidConv(GradientDescentConv):
    MAPPING = "conv_sigmoid"


class GDRELUConv(GradientDescentConv):
    MAPPING = "conv_relu"


class GDStrictRELUConv(GradientDescentConv):
    MAPPING = "conv_str"
