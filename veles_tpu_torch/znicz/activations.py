"""Activation functions of the all2all forwards, on torch tensors.

The port's counterpart of ``veles_tpu/znicz/activations.py`` (the Znicz
kernel conventions):

- ``linear``: the identity;
- ``tanh``: LeCun-scaled ``1.7159 * tanh(0.6666 * x)``.

Sigmoid, the RELUs and the activation units' extras (log, tanhlog,
sincos) come with the units that use them.

Only the forwards are here: the fused train step differentiates them
with autograd.  The explicit derivatives (``deriv(y, x)``) come with
graph mode's GD units.
"""

import torch

__all__ = ["Activation", "get"]

A, B = 1.7159, 0.6666


class Activation:
    """One activation: a forward on torch tensors, picklable by name."""

    def __init__(self, name, fwd):
        self.name = name
        self.fwd = fwd

    def __reduce__(self):
        return (get, (self.name,))


_TABLE = {
    "linear": Activation("linear", lambda x: x),
    "tanh": Activation("tanh", lambda x: A * torch.tanh(B * x)),
}


def get(name):
    return _TABLE[name]
