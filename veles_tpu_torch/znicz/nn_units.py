"""Forward / gradient-descent base units for the NN layer library.

The port's counterpart of ``veles_tpu/znicz/nn_units.py`` (the Znicz
ForwardBase / GradientDescentBase; solver and regularization knobs per
the reference's manualrst_veles_algorithms.rst:150-165).  Every Forward
implements

- ``init_params()`` — allocate weights/bias host-side with the unit's
  reproducible :class:`RandomGenerator` (seeded alike, the JAX
  package's bytes);
- ``apply(params, x)`` — a function of ``params = {"weights": W,
  "bias": b}`` (device tensors) that autograd differentiates.  ``run``
  wraps it for a standalone forward; the StandardWorkflow's fused step
  composes the chain of ``apply``s into one train step.

Stochastic forwards (dropout) set ``stochastic`` and implement
``apply_train(params, x, key)``, which the fused step calls on train
steps with a threefry key (:mod:`veles_tpu_torch.prng`); eval steps call
``apply``.  :class:`ParamlessForward` is the base of the forwards with
no trainable tensors (pooling, LRN, dropout, activation units).

GradientDescent units own the hyperparameters and the solver state the
fused step reads (``lr_for``, ``decay_for``, ``solver``,
``solver_state``).  :meth:`GradientDescentBase.backward_via_vjp` is the
generic backward of a forward's ``apply`` (the attention and conv
units'); :class:`GenericVJPBackward` is the backward of a paramless
forward.  The per-unit graph-mode ``run`` is not ported yet.

:func:`resolve_use_pallas` is the tri-state ``use_pallas`` knob of the
units that have a kernel route (the name is the JAX package's, so a
layers config moves across as it is).
"""

import numpy
import torch

from ..accelerated_units import AcceleratedUnit
from ..memory import Array
from .. import prng
from . import solvers

__all__ = ["NNUnitBase", "ForwardBase", "ParamlessForward",
           "GradientDescentBase", "GenericVJPBackward", "resolve_use_pallas"]


def resolve_use_pallas(setting, device):
    """Shared tri-state ``use_pallas`` semantics: True / False force the
    choice; None (unset) is AUTO: the kernels when the unit's device is
    the card, the oracle elsewhere (on the CPU the kernels' plain
    versions are slower than the oracle).  A unit not initialized yet
    (no device) counts as on the card when torch sees one, as
    ``Device()`` would put it there."""
    if setting is not None:
        return bool(setting)
    backend = getattr(device, "BACKEND", None)
    if backend is None:
        return torch.cuda.is_available()
    return backend == "cuda"


class NNUnitBase(AcceleratedUnit):
    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.prng = kwargs.get("prng", prng.get())


class ForwardBase(NNUnitBase):
    """Base for forward propagation units (weights + bias + activation)."""

    hide_from_registry = True
    view_group = "WORKER"
    MAPPING = None  # StandardWorkflow layer-type key
    #: True where ``apply_train`` draws random numbers from its key
    stochastic = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.input = None               # linked from the previous unit
        self.output = Array()
        self.weights = Array()
        self.bias = Array()
        self.include_bias = bool(kwargs.get("include_bias", True))
        self.weights_stddev = kwargs.get("weights_stddev")
        self.bias_stddev = kwargs.get("bias_stddev",
                                      kwargs.get("weights_stddev"))
        self.weights_filling = kwargs.get("weights_filling", "uniform")
        self.bias_filling = kwargs.get("bias_filling", "uniform")
        self.exports = ["weights", "bias"]

    # -- parameter handling --------------------------------------------------
    @property
    def params(self):
        """The layer's trainable tensors on the device."""
        p = {}
        if self.weights:
            p["weights"] = self.weights.devmem
        if self.include_bias and self.bias:
            p["bias"] = self.bias.devmem
        return p

    def set_params(self, params):
        """Accept fresh device values from the fused step."""
        if "weights" in params:
            self.weights.devmem = params["weights"]
        if "bias" in params:
            self.bias.devmem = params["bias"]

    @property
    def host_params(self):
        """Host (numpy) twin of :attr:`params`."""
        p = {}
        if self.weights:
            p["weights"] = self.weights.map_read()
        if self.include_bias and self.bias:
            p["bias"] = self.bias.map_read()
        return p

    def set_host_params(self, params):
        if "weights" in params:
            self.weights.mem = numpy.array(params["weights"], numpy.float32)
        if "bias" in params:
            self.bias.mem = numpy.array(params["bias"], numpy.float32)

    def fill_array(self, arr, shape, stddev, filling):
        n_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        if stddev is None:
            stddev = 1.0 / numpy.sqrt(n_in)
        mem = numpy.zeros(shape, numpy.float32)
        if filling == "uniform":
            self.prng.fill(mem, -stddev, stddev)
        elif filling == "gaussian":
            mem[...] = self.prng.normal(0, stddev, shape)
        elif filling == "constant":
            mem[...] = stddev
        else:
            raise ValueError("unknown filling %r" % filling)
        arr.mem = mem

    def init_params(self):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError

    def apply_train(self, params, x, key):
        """Train-time forward; the eval forward unless the unit is
        ``stochastic`` and consumes ``key``."""
        return self.apply(params, x)

    def output_shape_for(self, input_shape):
        """Shape of the output for a given input shape; lets initialize
        pre-allocate ``output`` so downstream units can size themselves
        before the first run."""
        raise NotImplementedError

    #: methods every concrete forward must implement (checked at
    #: initialize by verified.verify_contract)
    CONTRACT = ("apply", "output_shape_for")

    def initialize(self, device=None, **kwargs):
        from ..verified import verify_contract
        verify_contract(self, ForwardBase)
        super().initialize(device=device, **kwargs)
        if not self.weights:
            self.init_params()
        out_shape = self.output_shape_for(self.input_shape)
        if not self.output or tuple(self.output.shape) != tuple(out_shape):
            self.output.reset(numpy.zeros(out_shape, numpy.float32))
        for arr in (self.weights, self.bias, self.output):
            arr.initialize(self.device)
        if isinstance(self.input, Array) and self.input.device is None:
            self.input.initialize(self.device)   # a host-made input

    @property
    def input_shape(self):
        v = self.input
        return v.shape if isinstance(v, Array) else tuple(numpy.shape(v))

    def run(self):
        """A standalone forward of the current input (no gradients)."""
        x = self.input.devmem if isinstance(self.input, Array) \
            else self.input
        with torch.no_grad():
            self.output.devmem = self.apply(self.params, x)


class ParamlessForward(ForwardBase):
    """Base for forwards with no trainable parameters (pooling, LRN,
    dropout, activations)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.include_bias = False

    def init_params(self):
        pass

    @property
    def params(self):
        return {}

    def set_params(self, params):
        pass

    def output_shape_for(self, input_shape):
        return tuple(input_shape)


class GradientDescentBase(NNUnitBase):
    """Base for backward/update units.

    Linked attributes (reference GD contract): ``input`` and ``output``
    (the forward's), ``weights``/``bias`` (two-way with the forward).
    Holds the layer's hyperparameters and solver, and the solver state
    (``{param name: state tuple}``) a snapshot or ``convert`` carries.
    """

    hide_from_registry = True
    view_group = "TRAINER"
    MAPPING = None

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.input = None
        self.output = None
        self.weights = None        # linked two-way with the forward
        self.bias = None
        self.forward_unit = None   # set by link_forward / StandardWorkflow
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get("learning_rate_bias",
                                             kwargs.get("learning_rate",
                                                        0.01))
        self.weights_decay = kwargs.get("weights_decay", 0.0)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        self.l1_vs_l2 = kwargs.get("l1_vs_l2", 0.0)
        self.l1_vs_l2_bias = kwargs.get("l1_vs_l2_bias",
                                        kwargs.get("l1_vs_l2", 0.0))
        self.factor_ortho = kwargs.get("factor_ortho", 0.0)
        self.gradient_moment = kwargs.get("gradient_moment", 0.0)
        self.solver_name = kwargs.get(
            "solver", "momentum" if self.gradient_moment else "sgd")
        hyper = dict(kwargs.get("solver_parameters", {}))
        if self.solver_name == "momentum":
            hyper.setdefault("momentum", self.gradient_moment or 0.9)
        self.solver = solvers.factory(self.solver_name, **hyper)
        self.solver_state = {}     # param name -> state tuple

    def link_forward(self, fwd):
        """Wire the standard attribute set to a forward unit."""
        self.forward_unit = fwd
        self.link_attrs(fwd, "input", "output", two_way=False)
        self.link_attrs(fwd, "weights", "bias", two_way=True)
        return self

    def lr_for(self, name):
        return self.learning_rate_bias if name == "bias" \
            else self.learning_rate

    def decay_for(self, name):
        if name == "bias":
            return self.weights_decay_bias, self.l1_vs_l2_bias, 0.0
        return self.weights_decay, self.l1_vs_l2, self.factor_ortho

    def backward_via_vjp(self, params, x, err_output, n_valid):
        """Generic backward through autograd of the forward's ``apply``:
        ``(err_input, {name: grad / n_valid})`` for ``params`` (a dict of
        tensors), the input ``x`` and ``err_output`` (the gradient at the
        output) -- the chain rule the fused step differentiates."""
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        xx = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.forward_unit.apply(dict(zip(names, leaves)), xx)
            grads = torch.autograd.grad(y, leaves + [xx], err_output)
        return grads[-1], {n: g / n_valid for n, g in zip(names, grads)}

    def run(self):
        raise NotImplementedError(
            "%s: the per-unit backward (graph mode) is not ported yet; "
            "train through the fused step" % self)


class GenericVJPBackward(GradientDescentBase):
    """Backward of a paramless forward: the vjp of its ``apply``, no
    parameters to update."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("learning_rate", 0.0)
        super().__init__(workflow, **kwargs)

    def backward(self, params, x, y, err_output, n_valid=None):
        if n_valid is None:
            n_valid = x.shape[0]
        err_in, _ = self.backward_via_vjp({}, x, err_output, n_valid)
        return err_in, {}
