"""FusedTrainStep: forward, loss, backward and update of a whole chain of
forward units as one eager PyTorch step per minibatch.

The port's counterpart of ``veles_tpu/znicz/fused.py``.  The unit graph
stays the build-time description (forwards and GD units are the ones
graph mode would use); at run time one step runs per minibatch:

    x, y = index_select(dataset, idx), index_select(labels, idx)
    loss = masked cross-entropy(chain of apply(params, x), y)
    grads = autograd.grad(loss, params)
    per parameter: g = regularized_grad(g); delta, state = solver(g)
                   param += delta * (lr * lr_scale)

The dataset is resident on the device and gathered inside the step
(``link_fused_gather``, which a FullBatchLoader takes).  The metrics
(n_err, the confusion matrix, the largest row sum of |probabilities -
one-hot|) accumulate in device
tensors and reach the host only at class boundaries, through the same
``n_err`` / ``confusion_matrix`` / ``max_err_output_sum`` Arrays an
evaluator exposes, so the Decision works unchanged.  The step updates
its own copy of the parameters in place; ``sync_weights`` copies them
into the forward units at class boundaries and at the end of a run.

Stochastic units (dropout) draw from a per-step seed, as the JAX
package's step does: ``_seed_counter`` starts at ``seed * 1_000_003 mod
0x7FFF0000`` (``seed`` 42 unless given), advances before each train
step, and the step's key is ``prng.key(counter)``; the stochastic
forward at chain index ``i`` runs ``apply_train`` with ``fold_in(key,
i)``, so its bits equal the JAX step's.  Eval steps run ``apply``.

Not ported: bf16 compute, the persistent executable cache, the
staged-seed path of stochastic units, the ``rng_impl`` switch, the MSE
loss, steps fed by a host-side loader and the whole-workflow graph
compiler's face.  ``compute_dtype``, ``root.common.engine.dtype`` and
``root.common.engine.rng_impl`` raise ``NotImplementedError`` when set
to anything but f32 / threefry2x32 (ROADMAP queue A item 9).
``compute_confusion_matrix=False`` is accepted: the step always
computes the matrix, which costs a small scatter-add a step.
"""

import numpy
import torch

from ..config import root
from ..memory import Array
from .. import prng
from ..result_provider import IResultProvider
from ..units import Unit
from .. import loader as loader_mod
from .all2all import All2AllSoftmax
from .evaluator import EvaluatorSoftmax
from . import solvers

__all__ = ["FusedTrainStep"]


class FusedTrainStep(Unit, IResultProvider):
    """One-step fused trainer over a chain of forward units.

    Parameters: ``forwards`` (list of ForwardBase), ``gd_units`` (one
    GradientDescentBase per forward: hyperparameters and solver state),
    ``loss`` ("softmax"; the MSE loss is not ported yet).
    """

    def __init__(self, workflow, forwards, gd_units, loss="softmax",
                 **kwargs):
        super().__init__(workflow, **kwargs)
        for knob, value, off in (
                ("compute_dtype", kwargs.get("compute_dtype"),
                 (None, "float32")),
                ("root.common.engine.dtype",
                 root.common.engine.get("dtype"), (None, "float32")),
                ("root.common.engine.rng_impl",
                 root.common.engine.get("rng_impl"),
                 (None, "threefry2x32"))):
            if value not in off:
                raise NotImplementedError(
                    "%s=%r is not ported yet: the port's step computes "
                    "in f32 with threefry2x32 (ROADMAP queue A item 9)"
                    % (knob, value))
        if loss != "softmax":
            raise ValueError("the port's fused step trains softmax heads "
                             "only (loss=%r is not ported yet)" % (loss,))
        self.view_group = "TRAINER"
        self.gather_loader = None   # set by link_fused_gather
        self.forwards = list(forwards)
        self.gd_units = list(gd_units)
        assert len(self.gd_units) == len(self.forwards)
        self.loss_kind = loss
        # linked from loader:
        self.minibatch_size = None
        self.minibatch_class = None
        self.last_minibatch = None
        # evaluator-compatible metric surface:
        self.n_err = Array(numpy.zeros(1, numpy.int64))
        self.confusion_matrix = Array()
        self.max_err_output_sum = Array(numpy.zeros(1, numpy.float32))
        self.loss = None
        self.output = Array()      # probabilities of the last minibatch
        # global learning-rate multiplier (a LearningRateAdjuster sets it
        # per epoch); 1.0 = the configured base rates
        self.lr_scale = 1.0
        # the per-step seed of stochastic units (the JAX package's; kept
        # within int32 there)
        self._seed_counter = (int(kwargs.get("seed", 42)) *
                              1_000_003) % 0x7FFF0000
        self.train_steps = 0
        self.eval_steps = 0

    def link_loader(self, loader):
        self.link_attrs(loader, "minibatch_size", "minibatch_class",
                        "last_minibatch")
        return self

    def link_fused_gather(self, loader):
        """Gather each minibatch from the device-resident dataset inside
        the step: the loader then only computes shuffled indices."""
        self.gather_loader = loader
        return self

    # -- construction --------------------------------------------------------
    def initialize(self, device=None, **kwargs):
        # forwards live outside the control graph in fused mode, so the
        # dependency walk has not initialized them: bring them up in
        # chain order (shapes propagate input → output)
        for fwd in self.forwards:
            if not fwd.is_initialized:
                fwd.initialize(device=device, **kwargs)
        super().initialize(**kwargs)
        if not isinstance(self.forwards[-1], All2AllSoftmax):
            raise ValueError("the fused softmax loss needs an "
                             "All2AllSoftmax head, got %r"
                             % self.forwards[-1])
        if self.gather_loader is None:
            raise ValueError("%s gathers its minibatches from a "
                             "FullBatchLoader: call link_fused_gather"
                             % self)
        self.device = self.forwards[0].device
        self._dev_ = self.device.torch_device
        self._n_classes = int(self.forwards[-1].output.shape[-1])
        if not self.confusion_matrix:
            self.confusion_matrix.mem = numpy.zeros(
                (self._n_classes, self._n_classes), numpy.int64)
        self.confusion_matrix.initialize(self.device)
        self.output.initialize(self.device)
        self._cm_dev_ = None    # device-resident running total
        ld = self.gather_loader
        self._data_dev_ = ld.original_data.devmem
        self._y_dev_ = torch.from_numpy(
            ld._dense_labels.astype(numpy.int64)).to(self._dev_)
        self.load_state()

    def load_state(self):
        """(Re)build the step's parameters from the forward units and its
        solver state from the GD units' ``solver_state`` (fresh state
        where a GD unit has none), and clear the metric accumulator."""
        self._params_ = [
            {k: v.detach().clone().requires_grad_(True)
             for k, v in fwd.params.items()}
            for fwd in self.forwards]
        self._opt_ = []
        for gd, params in zip(self.gd_units, self._params_):
            layer = {}
            for name, p in params.items():
                saved = gd.solver_state.get(name)
                layer[name] = (tuple(torch.as_tensor(s).to(self._dev_)
                                     for s in saved) if saved else
                               gd.solver.init(p.detach()))
            self._opt_.append(layer)
        self._macc_ = self._macc_init()

    def _macc_init(self):
        """Fresh device metric accumulator: (n_err, confusion counts
        [pred, true], max row error)."""
        c = self._n_classes
        return (torch.zeros((), dtype=torch.int64, device=self._dev_),
                torch.zeros((c, c), dtype=torch.int64, device=self._dev_),
                torch.zeros((), dtype=torch.float32, device=self._dev_))

    # -- the step ------------------------------------------------------------
    def _logits(self, x, seed=None):
        """The chain's logits; ``seed`` (train steps) keys the stochastic
        forwards."""
        h = x
        key = None
        if seed is not None and any(f.stochastic for f in self.forwards):
            key = prng.key(seed)
        for i, (fwd, params) in enumerate(zip(self.forwards[:-1],
                                              self._params_)):
            if key is not None and fwd.stochastic:
                h = fwd.apply_train(params, h, prng.fold_in(key, i))
            else:
                h = fwd.apply(params, h)
        return self.forwards[-1].apply_logits(self._params_[-1], h)

    def _accumulate(self, probs, y, mask):
        """Fold one step's outputs into the device accumulator (the graph
        evaluator's side channels)."""
        n_err, cm, mx = self._macc_
        pred = torch.argmax(probs, dim=-1)
        valid = mask > 0
        n_err += ((pred != y) & valid).sum()
        onehot = torch.nn.functional.one_hot(y, self._n_classes).to(
            probs.dtype)
        err_rows = (probs - onehot).abs().sum(dim=1) * mask
        torch.maximum(mx, err_rows.max(), out=mx)
        cm.index_put_((pred, y), valid.to(cm.dtype), accumulate=True)

    def _train_step(self, x, y, mask):
        flat = [p for layer in self._params_ for p in layer.values()]
        self._seed_counter = (self._seed_counter + 1) % 0x7FFF0000
        logits = self._logits(x, self._seed_counter)
        loss = EvaluatorSoftmax.loss_from_logits(logits, y, mask)
        grads = iter(torch.autograd.grad(loss, flat))
        lr_scale = float(self.lr_scale)
        with torch.no_grad():
            for gd, params, opt in zip(self.gd_units, self._params_,
                                       self._opt_):
                for name, p in params.items():
                    decay, l1l2, ortho = gd.decay_for(name)
                    g = solvers.regularized_grad(next(grads), p, decay,
                                                 l1l2, ortho)
                    delta, opt[name] = gd.solver.update(
                        g, p, opt[name], gd.lr_for(name) * lr_scale)
                    p.add_(delta)
            probs = torch.softmax(logits.detach(), dim=-1)
            self._accumulate(probs, y, mask)
        return loss.detach(), probs

    def _eval_step(self, x, y, mask):
        with torch.no_grad():
            logits = self._logits(x)
            loss = EvaluatorSoftmax.loss_from_logits(logits, y, mask)
            probs = torch.softmax(logits, dim=-1)
            self._accumulate(probs, y, mask)
        return loss, probs

    def run(self):
        size = int(self.minibatch_size)
        idx = torch.from_numpy(self.gather_loader._padded_indices_)
        if self._dev_.type == "cuda":
            # pinned and asynchronous: the host runs ahead of the card
            idx = idx.pin_memory().to(self._dev_, non_blocking=True)
        x = torch.index_select(self._data_dev_, 0, idx)
        y = torch.index_select(self._y_dev_, 0, idx)
        mask = (torch.arange(x.shape[0], device=self._dev_) < size).to(
            torch.float32)
        if self.minibatch_class == loader_mod.TRAIN:
            self.loss, probs = self._train_step(x, y, mask)
            self.train_steps += 1
        else:
            self.loss, probs = self._eval_step(x, y, mask)
            self.eval_steps += 1
        self.output.devmem = probs
        if bool(self.last_minibatch):
            self._flush_metrics()
            self.sync_weights()

    def _flush_metrics(self):
        """Pull the device accumulator into the evaluator-compatible
        Arrays: one transfer per class boundary, not per step.  The
        confusion matrix stays on the device until someone reads it."""
        n_err, cm, mx = self._macc_
        self._cm_dev_ = cm if self._cm_dev_ is None else self._cm_dev_ + cm
        self.confusion_matrix.devmem = self._cm_dev_
        n, m = torch.stack((n_err.double(), mx.double())).tolist()
        self.n_err.map_write()[0] += int(n)
        self.max_err_output_sum.map_write()[0] = max(
            float(self.max_err_output_sum[0]), m)
        self._macc_ = self._macc_init()

    def sync_weights(self):
        """Copy the step's parameters into the forward units' Arrays (the
        step goes on updating its own tensors in place)."""
        with torch.no_grad():
            for fwd, params in zip(self.forwards, self._params_):
                fwd.set_params({k: v.detach().clone()
                                for k, v in params.items()})

    def sync_solver_state(self):
        """Pull the optimizer state into the GD units' picklable
        ``solver_state`` (host numpy)."""
        for gd, layer in zip(self.gd_units, self._opt_):
            for name, state in layer.items():
                gd.solver_state[name] = tuple(
                    s.detach().cpu().numpy() for s in state)

    def get_metric_values(self):
        return {"n_err": int(self.n_err[0]),
                "loss": None if self.loss is None else float(self.loss)}
