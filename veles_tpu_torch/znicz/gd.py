"""Gradient-descent units for the all2all family.

The port's counterpart of ``veles_tpu/znicz/gd.py`` (the Znicz
GradientDescent, GDTanh, GDSigmoid, GDRELU, GDStrictRELU, GDSoftmax:
the trainers of the port's All2All members).  Here
they are the owners of each layer's hyperparameters and solver state,
which the fused train step reads (:class:`~.nn_units.
GradientDescentBase`); the fused step differentiates the forwards with
autograd.  Their explicit per-unit backward (graph
mode: ``err = err_output * act'(y)``, ``grad_W = x^T err / B``,
``err_input = err W^T``) is not ported yet.
"""

from .nn_units import GradientDescentBase

__all__ = ["GradientDescent", "GDTanh", "GDSigmoid", "GDRELU",
           "GDStrictRELU", "GDSoftmax"]


class GradientDescent(GradientDescentBase):
    """Trainer of a linear All2All (``ACTIVATION``: the forward's
    activation, whose derivative graph mode's backward will use)."""

    MAPPING = "all2all"
    ACTIVATION = "linear"


class GDTanh(GradientDescent):
    MAPPING = "all2all_tanh"
    ACTIVATION = "tanh"


class GDSigmoid(GradientDescent):
    MAPPING = "all2all_sigmoid"
    ACTIVATION = "sigmoid"


class GDRELU(GradientDescent):
    MAPPING = "all2all_relu"
    ACTIVATION = "relu"


class GDStrictRELU(GradientDescent):
    MAPPING = "all2all_str"
    ACTIVATION = "strict_relu"


class GDSoftmax(GradientDescent):
    """Trainer of All2AllSoftmax (the cross-entropy gradient reaches the
    logits directly: no activation derivative)."""

    MAPPING = "softmax"
    ACTIVATION = "linear"
