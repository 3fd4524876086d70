"""Recurrent forward units: SimpleRNN and LSTM, with their BPTT units.

The port's counterpart of ``veles_tpu/znicz/rnn.py``.  ``apply(params,
x)`` loops over time in Python, one step of the cell on ``x[:, t]`` a
step, so the units compose with the fused train step like feed-forward
layers: autograd of the loop is backprop through time, and on the card
the epoch scan captures the whole loop in its CUDA graphs (the loop
reads nothing back to the host).

Input: ``[batch, time, features...]``, flattened after the time axis;
output: the last hidden state ``[batch, hidden]``, or ``[batch, time,
hidden]`` with ``return_sequences=True``.

The parameters keep the JAX layout, not ``torch.nn.RNN`` / ``LSTM``'s
(which hold two biases, another gate order and transposed matrices):

- SimpleRNN: one ``[F + H, H]`` matrix (``wx = w[:F]``, ``wh = w[F:]``)
  and one ``[H]`` bias; ``h = act(x_t @ wx + h @ wh + b)``, where the
  default ``activation="tanh"`` is the registry's LeCun-scaled
  ``1.7159 * tanh(0.6666 x)``;
- LSTM: one ``[F + H, 4H]`` matrix, the gates packed ``i, f, g, o``, and
  a ``[4H]`` bias of zeros with the forget slice at 1.0 (it ignores
  ``bias_filling``); plain ``sigmoid`` and ``tanh``.

The matmuls are ``torch.matmul`` whatever ``precise_gemm`` says, as the
JAX units compute theirs outside any Pallas kernel.  Neither unit
defines ``export_params`` (the JAX ones do not), so a package does not
record ``hidden``, ``return_sequences`` or ``activation``.

:class:`GDRNN` and :class:`GDLSTM` are :class:`GenericVJPBackward`
units, as in the JAX package (so their learning rate defaults to 0),
whose backward differentiates ``apply`` with respect to the parameters
too.  The JAX units hand the vjp no parameters, so the JAX graph mode
of a recurrent layer fails (``KeyError: 'weights'``); the fused step
differentiates ``apply`` in both packages.
"""

import numpy
import torch

from .activations import get as get_activation
from .nn_units import ForwardBase, GenericVJPBackward

__all__ = ["SimpleRNN", "LSTM", "GDRNN", "GDLSTM"]


def _time_major(x):
    """``x`` as ``[batch, time, features]`` and its feature count."""
    f = int(numpy.prod(x.shape[2:]))
    return x.reshape(x.shape[0], x.shape[1], f), f


class _Recurrent(ForwardBase):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.hidden = int(kwargs.get("hidden", 64))
        self.return_sequences = bool(kwargs.get("return_sequences", False))

    def output_shape_for(self, input_shape):
        b, t = input_shape[0], input_shape[1]
        if self.return_sequences:
            return (b, t, self.hidden)
        return (b, self.hidden)

    def _n_features(self):
        return int(numpy.prod(self.input_shape[2:]))

    def _output(self, last, steps):
        return torch.stack(steps, dim=1) if self.return_sequences else last


class SimpleRNN(_Recurrent):
    """h_t = act(x_t @ Wx + h_{t-1} @ Wh + b)."""

    MAPPING = "rnn"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.activation = get_activation(kwargs.get("activation", "tanh"))

    def init_params(self):
        f = self._n_features()
        self.fill_array(self.weights, (f + self.hidden, self.hidden),
                        self.weights_stddev, self.weights_filling)
        self.fill_array(self.bias, (self.hidden,), self.bias_stddev,
                        self.bias_filling)

    def apply(self, params, x):
        w, b = params["weights"], params["bias"]
        x, f = _time_major(x)
        wx, wh = w[:f], w[f:]
        h = x.new_zeros((x.shape[0], self.hidden))
        steps = []
        for t in range(x.shape[1]):
            h = self.activation.fwd(x[:, t] @ wx + h @ wh + b)
            steps.append(h)
        return self._output(h, steps)


class LSTM(_Recurrent):
    """Standard LSTM cell over time (the i, f, g, o gates packed in one
    ``[F + H, 4H]`` matrix; the forget gate's bias starts at 1)."""

    MAPPING = "lstm"

    def init_params(self):
        f = self._n_features()
        H = self.hidden
        self.fill_array(self.weights, (f + H, 4 * H),
                        self.weights_stddev, self.weights_filling)
        bias = numpy.zeros(4 * H, numpy.float32)
        bias[H:2 * H] = 1.0  # the forget gate's
        self.bias.mem = bias

    def apply(self, params, x):
        w, b = params["weights"], params["bias"]
        x, f = _time_major(x)
        H = self.hidden
        wx, wh = w[:f], w[f:]
        h = x.new_zeros((x.shape[0], H))
        c = torch.zeros_like(h)
        steps = []
        for t in range(x.shape[1]):
            z = x[:, t] @ wx + h @ wh + b
            i = torch.sigmoid(z[:, :H])
            fg = torch.sigmoid(z[:, H:2 * H])
            g = torch.tanh(z[:, 2 * H:3 * H])
            o = torch.sigmoid(z[:, 3 * H:])
            c = fg * c + i * g
            h = o * torch.tanh(c)
            steps.append(h)
        return self._output(h, steps)


class GDRNN(GenericVJPBackward):
    """BPTT for SimpleRNN."""
    MAPPING = "rnn"


class GDLSTM(GenericVJPBackward):
    """BPTT for LSTM."""
    MAPPING = "lstm"
