"""Activation functions of the forward units, on torch tensors.

The port's counterpart of ``veles_tpu/znicz/activations.py`` (the Znicz
kernel conventions):

- ``linear``: the identity;
- ``tanh``: LeCun-scaled ``1.7159 * tanh(0.6666 * x)``;
- ``sigmoid``: logistic;
- ``relu``: smooth ``log(1 + exp(x))`` (Znicz's "RELU" is softplus);
- ``strict_relu``: ``max(0, x)``;
- the activation units' extras ``log`` (``asinh``), ``tanhlog`` and
  ``sincos``.

Only the forwards are here: the fused train step differentiates them
with autograd.  ``strict_relu`` is ``torch.maximum(x, 0)``, whose
gradient at a tie is 0.5, as ``jnp.maximum``'s is (``relu`` and
``clamp`` give 0 there).  The explicit derivatives (``deriv(y, x)``)
come with graph mode's GD units.
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


def _strict_relu(x):
    return torch.maximum(x, x.new_zeros(()))


def _tanhlog(x):
    small = x.abs() <= 15.0 / B
    # log's argument is 1 where its branch is not taken, so autograd of
    # the unused branch never meets log(0) (0 * inf = nan at x == 0)
    big = torch.where(small, torch.ones_like(x), x.abs())
    return torch.where(small, A * torch.tanh(B * x),
                       torch.sign(x) * (torch.log(big * B) / B +
                                        A * torch.tanh(torch.tensor(15.0))))


def _sincos(x):
    odd = torch.arange(x.shape[-1], device=x.device) % 2 == 1
    return torch.where(odd, torch.sin(x), torch.cos(x))


_TABLE = {
    "linear": Activation("linear", lambda x: x),
    "tanh": Activation("tanh", lambda x: A * torch.tanh(B * x)),
    "sigmoid": Activation("sigmoid", torch.sigmoid),
    "relu": Activation("relu", lambda x: torch.logaddexp(
        x, x.new_zeros(()))),
    "strict_relu": Activation("strict_relu", _strict_relu),
    "log": Activation("log", lambda x: torch.log(
        x + torch.sqrt(x * x + 1.0))),
    "tanhlog": Activation("tanhlog", _tanhlog),
    "sincos": Activation("sincos", _sincos),
}


def get(name):
    return _TABLE[name]
