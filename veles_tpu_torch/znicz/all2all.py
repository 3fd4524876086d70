"""Fully-connected (all-to-all) forward units.

The port's counterpart of ``veles_tpu/znicz/all2all.py`` (the Znicz
All2All family): ``y = act(flatten(x) @ W + b)`` with the weights in
the natural (in, out) layout; the linear, scaled-tanh, sigmoid, RELU
(Znicz softplus), strict-RELU and softmax members.
The matmul is ``torch.matmul`` (TF32
off), or, with ``precise_gemm=N`` (default
``root.common.engine.precise_gemm``), the compensated GEMM
:func:`.gemm.precise_matmul`, kernel K4 on the card, forward and
backward.

One deliberate difference: the JAX package's ``All2AllSoftmax`` computes
its logits with a plain matmul whatever ``precise_gemm`` says; here the
softmax head honours the knob like every other All2All, so
``precise_gemm=N`` puts every fully connected matmul on K4.
"""

import numpy
import torch

from ..config import root
from ..memory import Array
from .nn_units import ForwardBase
from . import activations
from . import gemm

__all__ = ["All2All", "All2AllTanh", "All2AllSigmoid", "All2AllRELU",
           "All2AllStrictRELU", "All2AllSoftmax"]


class All2All(ForwardBase):
    """Linear fully-connected layer."""

    MAPPING = "all2all"
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        shape = kwargs["output_sample_shape"]
        if isinstance(shape, int):
            shape = (shape,)
        self.output_sample_shape = tuple(shape)
        self.activation = activations.get(self.ACTIVATION)
        # opt-in compensated-summation GEMM (the reference's
        # PRECISION_LEVEL 1/2, znicz/gemm.py); 0 = torch.matmul
        self.precise_gemm = int(kwargs.get(
            "precise_gemm", root.common.engine.get("precise_gemm", 0)))

    @property
    def neurons_number(self):
        return int(numpy.prod(self.output_sample_shape))

    def init_params(self):
        n_input = int(numpy.prod(self.input_shape[1:]))
        self.fill_array(self.weights, (n_input, self.neurons_number),
                        self.weights_stddev, self.weights_filling)
        if self.include_bias:
            self.fill_array(self.bias, (self.neurons_number,),
                            self.bias_stddev, self.bias_filling)

    def output_shape_for(self, input_shape):
        return (input_shape[0],) + self.output_sample_shape

    def linear(self, params, x):
        """``flatten(x) @ W + b``, through K4 when ``precise_gemm``."""
        x = x.reshape(x.shape[0], -1)
        if self.precise_gemm:
            y = gemm.precise_matmul(x, params["weights"], self.precise_gemm)
        else:
            y = x @ params["weights"]
        if "bias" in params:
            y = y + params["bias"]
        return y

    def apply(self, params, x):
        y = self.activation.fwd(self.linear(params, x))
        if len(self.output_sample_shape) > 1:
            y = y.reshape((x.shape[0],) + self.output_sample_shape)
        return y


class All2AllTanh(All2All):
    """y = 1.7159 * tanh(0.6666 * (xW + b))."""
    MAPPING = "all2all_tanh"
    ACTIVATION = "tanh"


class All2AllSigmoid(All2All):
    MAPPING = "all2all_sigmoid"
    ACTIVATION = "sigmoid"


class All2AllRELU(All2All):
    """Znicz "RELU": y = log(1 + exp(xW + b)), softplus."""
    MAPPING = "all2all_relu"
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    """y = max(xW + b, 0) (AlexNet's fully connected layers)."""
    MAPPING = "all2all_str"
    ACTIVATION = "strict_relu"


class All2AllSoftmax(All2All):
    """Softmax output layer; also exports ``max_idx`` (argmax per sample)
    the evaluator consumes (reference All2AllSoftmax contract)."""

    MAPPING = "softmax"
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.max_idx = Array()

    def apply(self, params, x):
        return torch.softmax(self.apply_logits(params, x), dim=-1)

    def apply_logits(self, params, x):
        """Pre-softmax logits — the fused trainer uses these with a
        numerically-stable fused log-softmax cross-entropy."""
        return self.linear(params, x)

    def run(self):
        super().run()
        self.max_idx.mem = numpy.argmax(
            self.output.map_read(), axis=-1).astype(numpy.int32)
