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
``solver_state``), and run as units of their own in graph mode
(``StandardWorkflow(fused=False)``): ``GradientDescentBase.run`` takes
``err_output`` (linked from the evaluator or the GD unit above), runs
``backward`` with the forward's weights before the update, writes
``err_input`` (unless ``need_err_input`` is False), then applies the
regularized solver update to the forward's own Arrays.  Gradients are
divided by ``batch_size``, the valid row count of the minibatch
(padded rows carry zero error).

In graph mode a forward's ``run`` on a train minibatch
(``minibatch_class``, linked from the loader) calls ``apply_train`` with
a fresh key from its ``key_tree`` when it is stochastic, recorded as
``last_key`` for the backward, as the JAX package's ``tpu_run`` does.
Where the GD unit's backward is the vjp of ``apply``
(:meth:`GradientDescentBase.backward_via_vjp`: attention, conv,
pooling, LRN), that train forward keeps its autograd graph and the GD
unit differentiates it: each kernel runs once a step (K7 in the
forward, K8 and K9 in the backward; K5 and K6 alike), where ``jax.vjp``
in the JAX unit traces the forward again.  The GD unit recomputes the
forward only when none is kept for the output it sees (a GD unit run
beside a standalone forward).

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
           "GradientDescentBase", "VJPBackward", "GenericVJPBackward",
           "resolve_use_pallas"]


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
    #: the stochastic units' KeyTree: graph mode draws one key per train
    #: minibatch (``step_key``) and records it as ``last_key``
    key_tree = None
    last_key = None
    #: linked from the loader in graph mode; a train minibatch runs
    #: ``apply_train`` and keeps the graph for a vjp backward
    minibatch_class = None
    #: set by a GD unit whose backward is the vjp of ``apply``
    vjp_backward = False
    #: True where StandardWorkflow gives the layer GenericVJPBackward
    #: when no GD unit has its MAPPING (the paramless forwards,
    #: ResizableAll2All); a layer without it raises there
    GENERIC_BACKWARD = False

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

    def export_params(self):
        """Structural hyperparameters for the package archive: what a
        reader needs to rebuild this unit (the ``config`` of its entry
        in ``model.json``)."""
        return {}

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

    def step_key(self):
        """The next key of this unit's stream (``KeyTree.key_for`` its
        name), recorded as ``last_key``."""
        self.last_key = self.key_tree.key_for(self.name)
        return self.last_key

    def _graph_training(self):
        from .. import loader as loader_mod
        return self.minibatch_class == loader_mod.TRAIN

    def run(self):
        """The forward of the current input.  On a train minibatch of
        graph mode a stochastic unit draws its key, and a unit with a
        vjp backward keeps the autograd graph (``vjp_state_``)."""
        x = self.input.devmem if isinstance(self.input, Array) \
            else self.input
        train = self._graph_training()
        key = self.step_key() if train and self.stochastic else None
        self.vjp_state_ = None
        if train and self.vjp_backward:
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in self.params.items()}
            xx = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = self._forward(leaves, xx, key)
            out = y.detach()
            self.vjp_state_ = (out, y, leaves, xx)
        else:
            with torch.no_grad():
                out = self._forward(self.params, x, key)
        self.output.devmem = out

    def _forward(self, params, x, key):
        if key is None:
            return self.apply(params, x)
        return self.apply_train(params, x, key)


class ParamlessForward(ForwardBase):
    """Base for forwards with no trainable parameters (pooling, LRN,
    dropout, activations)."""

    hide_from_registry = True
    GENERIC_BACKWARD = True

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
    (the forward's), ``weights``/``bias`` (two-way with the forward),
    ``err_output`` (the gradient at the forward's output, from the
    evaluator or the GD unit above) and ``batch_size`` (the loader's
    valid row count).  Produces ``err_input``.  Holds the layer's
    hyperparameters and solver, and the solver state (``{param name:
    state tuple}``) a snapshot or ``convert`` carries.

    Subclasses implement ``backward(params, x, y, err_output, n_valid)
    -> (err_input, {name: grad})``.
    """

    #: True where ``backward`` is the vjp of the forward's ``apply``:
    #: ``link_forward`` then has the forward keep its train graph
    VJP = False
    #: for a stochastic forward: True where the vjp is that of the draw
    #: its train run made (``apply_train`` with ``last_key``), False
    #: where it is that of its eval ``apply`` (the JAX
    #: ``GenericVJPBackward``'s, which differentiates ``fwd.apply``)
    VJP_OF_DRAW = True

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
        self.err_output = None     # linked: evaluator / the GD above
        self.batch_size = None     # linked: loader.minibatch_size
        self.err_input = Array()
        self.need_err_input = bool(kwargs.get("need_err_input", True))

    def __getstate__(self):
        # graph mode keeps the solver state on the parameters' device; a
        # pickle carries it as host numpy (ensure_solver_state moves it
        # back)
        state = super().__getstate__()
        state["solver_state"] = {
            name: tuple(s.detach().to("cpu", copy=True).numpy()
                        if isinstance(s, torch.Tensor) else s
                        for s in st)
            for name, st in self.solver_state.items()}
        return state

    def link_forward(self, fwd):
        """Wire the standard attribute set to a forward unit."""
        self.forward_unit = fwd
        self.link_attrs(fwd, "input", "output", two_way=False)
        self.link_attrs(fwd, "weights", "bias", two_way=True)
        if self.VJP and (self.VJP_OF_DRAW or not fwd.stochastic):
            fwd.vjp_backward = True
        return self

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        self.err_input.initialize(self.device)
        if isinstance(self.err_output, Array) and \
                self.err_output.device is None:
            self.err_output.initialize(self.device)  # a host-made error

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
        output) -- the chain rule the fused step differentiates.  The
        forward's train graph for the output ``y`` it last wrote is
        differentiated where it kept one (graph mode), else the forward
        runs again: with its last key if it is stochastic and
        ``VJP_OF_DRAW``, else its eval ``apply``."""
        fwd = self.forward_unit
        state = getattr(fwd, "vjp_state_", None)
        if state is not None and state[0] is self._dev(self.output):
            fwd.vjp_state_ = None
            _, y, leaves, xx = state
        else:
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in params.items()}
            xx = x.detach().requires_grad_(True)
            key = fwd.last_key if fwd.stochastic and self.VJP_OF_DRAW \
                else None
            with torch.enable_grad():
                y = fwd._forward(leaves, xx, key)
        names = list(leaves)
        wrt = [leaves[n] for n in names] + [xx] * self.need_err_input
        if not wrt:
            return None, {}
        with torch.enable_grad():
            grads = torch.autograd.grad(y, wrt, err_output)
        err_input = grads[-1] if self.need_err_input else None
        return err_input, {n: g / n_valid for n, g in zip(names, grads)}

    def backward(self, params, x, y, err_output, n_valid=None):
        raise NotImplementedError

    # -- graph mode ----------------------------------------------------------
    def _n_valid(self, x):
        return int(self.batch_size) if self.batch_size is not None \
            else x.shape[0]

    def ensure_solver_state(self, params):
        """Fresh solver state where a parameter has none; a carried one
        (host numpy from a snapshot, ``convert`` or the fused step's
        ``sync_solver_state``) moves to the parameter's device."""
        for name, p in params.items():
            state = self.solver_state.get(name)
            if state is None:
                self.solver_state[name] = self.solver.init(p)
            elif any(not isinstance(s, torch.Tensor) or s.device != p.device
                     for s in state):
                self.solver_state[name] = tuple(
                    torch.as_tensor(s).to(p.device) for s in state)

    def apply_updates(self, params, grads):
        """The regularized solver step of every parameter, in place:
        ``p += delta``; the solver state moves to ``solver_state``.
        Returns ``params``."""
        self.ensure_solver_state(params)
        for name, p in params.items():
            decay, l1l2, ortho = self.decay_for(name)
            g = solvers.regularized_grad(grads[name], p, decay, l1l2, ortho)
            delta, self.solver_state[name] = self.solver.update(
                g, p, self.solver_state[name], self.lr_for(name))
            p.add_(delta)
        return params

    def run(self):
        """One backward and update (JAX ``_device_step``'s order):
        ``err_input`` from the weights before the update, then the
        update, handed back to the forward's own Arrays (attention's
        ``proj`` too), whose device copies become the current ones."""
        fwd = self.forward_unit
        x = self._dev(self.input)
        params = dict(fwd.params)
        with torch.no_grad():
            err_in, grads = self.backward(
                params, x, self._dev(self.output),
                self._dev(self.err_output), n_valid=self._n_valid(x))
            if params:
                fwd.set_params(self.apply_updates(params, grads))
        if self.need_err_input:
            self.err_input.devmem = err_in

    @staticmethod
    def _dev(v):
        return v.devmem if isinstance(v, Array) else v


class VJPBackward(GradientDescentBase):
    """A GD unit whose backward is the vjp of the forward's ``apply``
    (conv, attention): ``(err_input, {name: grad / n_valid})``."""

    hide_from_registry = True
    VJP = True

    def backward(self, params, x, y, err_output, n_valid=None):
        if n_valid is None:
            n_valid = x.shape[0]
        return self.backward_via_vjp(params, x, err_output, n_valid)


class GenericVJPBackward(VJPBackward):
    """Backward of a forward without a GD unit of its own: the vjp of
    its ``apply`` (learning rate 0 unless given).  A paramless forward
    (the structural units) has no parameters to update; the forwards
    with parameters that take it (``ResizableAll2All``, and the
    recurrent units through ``GDRNN`` / ``GDLSTM``) get their gradients
    too, where the JAX unit hands the vjp no parameters and so fails on
    them.  For a stochastic forward (the stochastic depooling pair) it
    is the vjp of the eval ``apply``, the expectation, though its train
    run drew a sample: the JAX ``GenericVJPBackward`` differentiates
    ``fwd.apply`` (the fused step differentiates the draw in both
    packages)."""

    hide_from_registry = True
    VJP_OF_DRAW = False

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("learning_rate", 0.0)
        super().__init__(workflow, **kwargs)
