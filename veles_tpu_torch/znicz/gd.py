"""Gradient-descent units for the all2all family.

The port's counterpart of ``veles_tpu/znicz/gd.py`` (the Znicz
GradientDescent, GDTanh, GDSigmoid, GDRELU, GDStrictRELU, GDSoftmax and
RPropAll2All: the trainers of the port's All2All members).  They own
each layer's hyperparameters and solver state, which the fused train
step reads (it differentiates the forwards with autograd), and in graph
mode they run the explicit backward of the JAX units:

    err = err_output * act'(y)
    grad_W = x^T err / n_valid;  grad_b = sum(err) / n_valid
    err_input = err W^T          (skipped when need_err_input is False)

with ``n_valid`` the valid rows of the minibatch (padded rows carry zero
error).  The products are ``torch.matmul`` (TF32 off), as the JAX GD
units leave them to XLA: a GD unit never calls ``precise_matmul``, so
``precise_gemm`` puts the forwards on K4 and never a GD unit.
"""

from .nn_units import GradientDescentBase
from . import activations

__all__ = ["GradientDescent", "GDTanh", "GDSigmoid", "GDRELU",
           "GDStrictRELU", "GDSoftmax", "RPropAll2All"]


class GradientDescent(GradientDescentBase):
    """Trainer of a linear All2All (``ACTIVATION``: the forward's
    activation, whose derivative the backward folds into the error)."""

    MAPPING = "all2all"
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.activation = activations.get(self.ACTIVATION)

    def _linear_bwd(self, params, x, err, n_valid):
        """grad_W = x^T err / n_valid; the padded rows of ``err`` are
        already zero (the evaluator masks them)."""
        xf = x.reshape(x.shape[0], -1)
        grads = {"weights": xf.T @ err / n_valid}
        if "bias" in params:
            grads["bias"] = err.sum(dim=0) / n_valid
        err_input = None
        if self.need_err_input:
            err_input = (err @ params["weights"].T).reshape(x.shape)
        return err_input, grads

    def _err(self, y, err_output):
        err = err_output.reshape(err_output.shape[0], -1)
        return err * self.activation.deriv(y.reshape(err.shape), None)

    def backward(self, params, x, y, err_output, n_valid=None):
        if n_valid is None:
            n_valid = x.shape[0]
        return self._linear_bwd(params, x, self._err(y, err_output),
                                n_valid)


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
    """Trainer of All2AllSoftmax.  The evaluator emits ``err_output = y -
    onehot``, the cross-entropy gradient at the logits, not yet divided
    by the batch: no activation derivative here."""

    MAPPING = "softmax"
    ACTIVATION = "linear"

    def _err(self, y, err_output):
        return err_output.reshape(err_output.shape[0], -1)


class RPropAll2All(GradientDescent):
    """All2All trainer with resilient propagation (the reference's
    rprop_all2all.RPropAll2All)."""

    MAPPING = "all2all_rprop"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("solver", "rprop")
        super().__init__(workflow, **kwargs)
