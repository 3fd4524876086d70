"""Standalone activation units.

The port's counterpart of ``veles_tpu/znicz/activation.py`` (the Znicz
Forward/Backward Tanh, Sigmoid, RELU, StrictRELU, Log, TanhLog, SinCos
and Mul): activations between non-activation layers, e.g. conv → pooling
→ ``activation_str`` in the CIFAR sample.  The forwards are the
functions of :mod:`.activations`.  The fused step differentiates them
with autograd; graph mode's backward units apply the explicit
derivatives of the JAX units, ``err_output * deriv(y, x)`` (and
``err_output * factor`` for Mul), with nothing divided by the batch and
no parameters.  The ``tanhlog`` forward keeps ``log``'s argument finite
(the gradient autograd takes at x = 0 is finite); its explicit
derivative is the JAX one.
"""

from .nn_units import ParamlessForward, GradientDescentBase
from . import activations

__all__ = ["ActivationForward", "ActivationBackward", "ForwardTanh",
           "BackwardTanh", "ForwardSigmoid", "BackwardSigmoid",
           "ForwardRELU", "BackwardRELU", "ForwardStrictRELU",
           "BackwardStrictRELU", "ForwardLog", "BackwardLog",
           "ForwardTanhLog", "BackwardTanhLog", "ForwardSinCos",
           "BackwardSinCos", "ForwardMul", "BackwardMul"]


class ActivationForward(ParamlessForward):
    hide_from_registry = True
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.activation = activations.get(self.ACTIVATION)

    def apply(self, params, x):
        return self.activation.fwd(x)


class ActivationBackward(GradientDescentBase):
    """``err_input = err_output * act'(y, x)``, the activation named by
    the class's forward twin (``MAPPING``)."""

    hide_from_registry = True
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("learning_rate", 0.0)
        super().__init__(workflow, **kwargs)
        self.activation = activations.get(self.ACTIVATION)

    def backward(self, params, x, y, err_output, n_valid=None):
        return err_output * self.activation.deriv(y, x), {}


class ForwardTanh(ActivationForward):
    MAPPING = "activation_tanh"
    ACTIVATION = "tanh"


class BackwardTanh(ActivationBackward):
    MAPPING = "activation_tanh"
    ACTIVATION = "tanh"


class ForwardSigmoid(ActivationForward):
    MAPPING = "activation_sigmoid"
    ACTIVATION = "sigmoid"


class BackwardSigmoid(ActivationBackward):
    MAPPING = "activation_sigmoid"
    ACTIVATION = "sigmoid"


class ForwardRELU(ActivationForward):
    MAPPING = "activation_relu"
    ACTIVATION = "relu"


class BackwardRELU(ActivationBackward):
    MAPPING = "activation_relu"
    ACTIVATION = "relu"


class ForwardStrictRELU(ActivationForward):
    MAPPING = "activation_str"
    ACTIVATION = "strict_relu"


class BackwardStrictRELU(ActivationBackward):
    MAPPING = "activation_str"
    ACTIVATION = "strict_relu"


class ForwardLog(ActivationForward):
    MAPPING = "activation_log"
    ACTIVATION = "log"


class BackwardLog(ActivationBackward):
    MAPPING = "activation_log"
    ACTIVATION = "log"


class ForwardTanhLog(ActivationForward):
    MAPPING = "activation_tanhlog"
    ACTIVATION = "tanhlog"


class BackwardTanhLog(ActivationBackward):
    MAPPING = "activation_tanhlog"
    ACTIVATION = "tanhlog"


class ForwardSinCos(ActivationForward):
    MAPPING = "activation_sincos"
    ACTIVATION = "sincos"


class BackwardSinCos(ActivationBackward):
    MAPPING = "activation_sincos"
    ACTIVATION = "sincos"


class ForwardMul(ParamlessForward):
    """y = x * factor (Znicz ForwardMul)."""

    MAPPING = "activation_mul"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.factor = float(kwargs.get("factor", 1.0))

    def apply(self, params, x):
        return x * self.factor


class BackwardMul(GradientDescentBase):
    """``err_input = err_output * factor``."""

    MAPPING = "activation_mul"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("learning_rate", 0.0)
        super().__init__(workflow, **kwargs)
        self.factor = float(kwargs.get("factor", 1.0))

    def backward(self, params, x, y, err_output, n_valid=None):
        return err_output * self.factor, {}
