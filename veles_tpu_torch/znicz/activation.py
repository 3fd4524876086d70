"""Standalone activation units.

The port's counterpart of ``veles_tpu/znicz/activation.py`` (the Znicz
Forward/Backward Tanh, Sigmoid, RELU, StrictRELU, Log, TanhLog, SinCos
and Mul): activations between non-activation layers, e.g. conv → pooling
→ ``activation_str`` in the CIFAR sample.  The forwards are the
functions of :mod:`.activations`; each backward is the vjp of its
forward (the fused step differentiates the forwards with autograd; the
explicit derivatives come with graph mode).
"""

from .nn_units import ParamlessForward, GenericVJPBackward
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


class ActivationBackward(GenericVJPBackward):
    hide_from_registry = True


class ForwardTanh(ActivationForward):
    MAPPING = "activation_tanh"
    ACTIVATION = "tanh"


class BackwardTanh(ActivationBackward):
    MAPPING = "activation_tanh"


class ForwardSigmoid(ActivationForward):
    MAPPING = "activation_sigmoid"
    ACTIVATION = "sigmoid"


class BackwardSigmoid(ActivationBackward):
    MAPPING = "activation_sigmoid"


class ForwardRELU(ActivationForward):
    MAPPING = "activation_relu"
    ACTIVATION = "relu"


class BackwardRELU(ActivationBackward):
    MAPPING = "activation_relu"


class ForwardStrictRELU(ActivationForward):
    MAPPING = "activation_str"
    ACTIVATION = "strict_relu"


class BackwardStrictRELU(ActivationBackward):
    MAPPING = "activation_str"


class ForwardLog(ActivationForward):
    MAPPING = "activation_log"
    ACTIVATION = "log"


class BackwardLog(ActivationBackward):
    MAPPING = "activation_log"


class ForwardTanhLog(ActivationForward):
    MAPPING = "activation_tanhlog"
    ACTIVATION = "tanhlog"


class BackwardTanhLog(ActivationBackward):
    MAPPING = "activation_tanhlog"


class ForwardSinCos(ActivationForward):
    MAPPING = "activation_sincos"
    ACTIVATION = "sincos"


class BackwardSinCos(ActivationBackward):
    MAPPING = "activation_sincos"


class ForwardMul(ParamlessForward):
    """y = x * factor (Znicz ForwardMul)."""

    MAPPING = "activation_mul"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.factor = float(kwargs.get("factor", 1.0))

    def apply(self, params, x):
        return x * self.factor


class BackwardMul(ActivationBackward):
    MAPPING = "activation_mul"
