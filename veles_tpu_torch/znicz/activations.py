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

The fused train step differentiates the forwards with autograd.
``strict_relu`` is ``torch.maximum(x, 0)``, whose gradient at a tie is
0.5, as ``jnp.maximum``'s is (``relu`` and ``clamp`` give 0 there).
Graph mode's GD units take the explicit derivatives instead,
``deriv(y, x)``: the JAX package's ``deriv_jnp`` term for term, from
the output ``y`` where the JAX one reads it (the All2All family's:
``x`` may be None there) and from the input ``x`` for ``log``,
``tanhlog`` and ``sincos``.
"""

import torch

__all__ = ["Activation", "get"]

A, B = 1.7159, 0.6666


class Activation:
    """One activation: a forward and its derivative on torch tensors,
    picklable by name."""

    def __init__(self, name, fwd, deriv):
        self.name = name
        self.fwd = fwd
        self.deriv = deriv

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


def _odd(x):
    return torch.arange(x.shape[-1], device=x.device) % 2 == 1


def _sincos(x):
    return torch.where(_odd(x), torch.sin(x), torch.cos(x))


def _d_linear(y, x):
    return torch.ones_like(y)


def _d_tanh(y, x):
    # dy/dx = A*B*(1 - tanh^2) = B/A * (A^2 - y^2)
    return (y * y) * (-B / A) + A * B


def _d_sigmoid(y, x):
    return y * (1.0 - y)


def _d_relu(y, x):
    # y = log(1 + e^x)  =>  dy/dx = 1 - e^-y
    return 1.0 - torch.exp(-y)


def _d_strict_relu(y, x):
    return (y > 0).to(y.dtype)


def _d_log(y, x):
    return 1.0 / torch.sqrt(x * x + 1.0)


def _d_tanhlog(y, x):
    return torch.where(x.abs() <= 15.0 / B,
                       A * B / torch.cosh(B * x) ** 2,
                       1.0 / (B * x.abs()))


def _d_sincos(y, x):
    return torch.where(_odd(x), torch.cos(x), -torch.sin(x))


_TABLE = {
    "linear": Activation("linear", lambda x: x, _d_linear),
    "tanh": Activation("tanh", lambda x: A * torch.tanh(B * x), _d_tanh),
    "sigmoid": Activation("sigmoid", torch.sigmoid, _d_sigmoid),
    "relu": Activation("relu", lambda x: torch.logaddexp(
        x, x.new_zeros(())), _d_relu),
    "strict_relu": Activation("strict_relu", _strict_relu, _d_strict_relu),
    "log": Activation("log", lambda x: torch.log(
        x + torch.sqrt(x * x + 1.0)), _d_log),
    "tanhlog": Activation("tanhlog", _tanhlog, _d_tanhlog),
    "sincos": Activation("sincos", _sincos, _d_sincos),
}


def get(name):
    return _TABLE[name]
