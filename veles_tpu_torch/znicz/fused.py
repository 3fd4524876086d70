"""FusedTrainStep: forward, loss, backward and update of a whole chain of
forward units as one eager PyTorch step per minibatch.

The port's counterpart of ``veles_tpu/znicz/fused.py``.  The unit graph
stays the build-time description (forwards and GD units are the ones
graph mode would use); at run time one step runs per minibatch:

    x, y = index_select(dataset, idx), index_select(labels, idx)
    loss = masked cross-entropy(chain of apply(params, x), y)
           (MSE: masked 0.5 * squared error against the targets)
    grads = autograd.grad(loss, params)
    per parameter: g = regularized_grad(g)
                   delta, state = solver(g, f32(lr) * f32(lr_scale))
                   param += delta

With a FullBatchLoader the dataset is resident on the device and
gathered inside the step (``link_fused_gather``).  Any other loader (a
``ShardedBatchLoader``), or a FullBatchLoader serving host minibatches
(``force_numpy``), serves the minibatch itself and the step runs on its
``minibatch_data`` / ``minibatch_labels`` (``minibatch_targets``), as
the JAX step falls back to its plain step.  The metrics
(n_err, the confusion matrix, the largest row sum of |probabilities -
one-hot|; for MSE the sum of per-sample mean squared errors and the
largest and smallest sample rmse) accumulate in device
tensors and reach the host only at class boundaries, through the same
``n_err`` / ``confusion_matrix`` / ``max_err_output_sum`` / ``metrics``
Arrays an evaluator exposes, so the Decision works unchanged.  The MSE
loss's gradient at the output is ``err / n_valid``, graph mode's
(``EvaluatorMSE.loss_from_output``).  The step updates
its own copy of the parameters in place; ``sync_weights`` copies them
into the forward units at class boundaries and at the end of a run,
and ``sync_solver_state`` its solver state into the GD units before a
snapshot.  A restored step rebuilds both from the units on the device
its ``initialize`` is given (the forwards of a pickled workflow hold a
device stub and are initialized again there).

Stochastic units (dropout) draw from a per-step seed, as the JAX
package's step does: ``_seed_counter`` starts at ``seed * 1_000_003 mod
0x7FFF0000`` (``seed`` 42 unless given), advances before each train
step, and the step's key is ``prng.key(counter)``; the stochastic
forward at chain index ``i`` runs ``apply_train`` with ``fold_in(key,
i)``, so its bits equal the JAX step's.  Eval steps run ``apply``.

**The staged path.**  When a ``MinibatchPrefetcher`` staged the
minibatch (the loader's ``prefetch_staged_``: the padded index vector
and the size, already on the step's device), the step gathers with
those and builds its mask from the size tensor, and a chain with
stochastic forwards takes its seed as a 0-d tensor staged one step
ahead (``_staged_seed_arg``, the JAX step's): the same values, so the
same bits.  With nothing staged the step is the synchronous one above.  The
epoch scan (:class:`~.scan_step.ScanEpochStep`) runs the same train and
eval steps with the solver state written in place (``in_place``), so
a captured CUDA graph reads and writes the same tensors at every
replay; :meth:`_flush_metrics` zeroes the accumulator in place for the
same reason.

Not ported: bf16 compute, the persistent executable cache, the
``rng_impl`` switch and the whole-workflow graph compiler's face.
``compute_dtype``, ``root.common.engine.dtype`` and
``root.common.engine.rng_impl`` raise
``NotImplementedError`` when set to anything but f32 / threefry2x32
(ROADMAP queue A item 9).
``compute_confusion_matrix=False`` is accepted: the step always
computes the matrix, which costs a small scatter-add a step.
"""

import numpy
import torch

from ..backends import Device
from ..config import root
from ..memory import Array
from .. import prng
from ..result_provider import IResultProvider
from ..units import Unit
from .. import loader as loader_mod
from .all2all import All2AllSoftmax
from .evaluator import EvaluatorSoftmax, EvaluatorMSE
from . import solvers

__all__ = ["FusedTrainStep"]


class FusedTrainStep(Unit, IResultProvider):
    """One-step fused trainer over a chain of forward units.

    Parameters: ``forwards`` (list of ForwardBase), ``gd_units`` (one
    GradientDescentBase per forward: hyperparameters and solver state),
    ``loss`` ("softmax" or "mse").
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
        if loss not in ("softmax", "mse"):
            raise ValueError("unknown loss %r (softmax or mse)" % (loss,))
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
        self.metrics = Array(numpy.array([0.0, 0.0, numpy.inf]))
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
        self.link_attrs(loader, "minibatch_data", "minibatch_size",
                        "minibatch_class", "last_minibatch")
        self.link_attrs(loader, "minibatch_targets"
                        if hasattr(loader, "minibatch_targets") else
                        "minibatch_labels")
        return self

    def link_fused_gather(self, loader):
        """Gather each minibatch from the device-resident dataset inside
        the step: the loader then only computes shuffled indices.  A
        loader told to serve host minibatches (``force_numpy``) goes on
        serving them, and the step runs on its ``minibatch_data``."""
        self.gather_loader = loader
        loader.defer_device_gather = not getattr(loader, "force_numpy",
                                                 False)
        return self

    # -- construction --------------------------------------------------------
    def initialize(self, device=None, **kwargs):
        # forwards live outside the control graph in fused mode, so the
        # dependency walk has not initialized them: bring them up in
        # chain order (shapes propagate input → output).  A restored
        # forward holds the pickled device stub: it is initialized again
        # on this device (fault C11)
        if device is None:
            device = Device()
        for fwd in self.forwards:
            if not fwd.is_initialized or fwd.device is not device:
                fwd.initialize(device=device, **kwargs)
        super().initialize(**kwargs)
        self._softmax = self.loss_kind == "softmax"
        if self._softmax and not isinstance(self.forwards[-1],
                                            All2AllSoftmax):
            raise ValueError("the fused softmax loss needs an "
                             "All2AllSoftmax head, got %r"
                             % self.forwards[-1])
        self.device = self.forwards[0].device
        self._dev_ = self.device.torch_device
        self._n_classes = int(self.forwards[-1].output.shape[-1])
        if self._softmax and not self.confusion_matrix:
            self.confusion_matrix.mem = numpy.zeros(
                (self._n_classes, self._n_classes), numpy.int64)
        self.confusion_matrix.initialize(self.device)
        self.output.initialize(self.device)
        self._cm_dev_ = None    # device-resident running total
        ld = self.gather_loader
        # the gather rides inside the step only where the loader defers
        # it; otherwise the loader serves the minibatch (the JAX step's
        # plain step on the host's minibatch)
        self._use_gather_ = ld is not None and ld.defer_device_gather
        if self._use_gather_:
            self._data_dev_ = ld.original_data.devmem
            if self._softmax:
                self._y_dev_ = torch.from_numpy(
                    ld._dense_labels.astype(numpy.int64)).to(self._dev_)
            else:
                self._y_dev_ = ld.original_targets.devmem
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
        [pred, true], max row error); for MSE (sum of sample mean
        squared errors, max sample rmse, min sample rmse)."""
        dev = self._dev_
        if not self._softmax:
            return (torch.zeros((), dtype=torch.float32, device=dev),
                    torch.zeros((), dtype=torch.float32, device=dev),
                    torch.full((), numpy.inf, dtype=torch.float32,
                               device=dev))
        c = self._n_classes
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((c, c), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))

    def _macc_reset(self):
        """Set the accumulator back to :meth:`_macc_init`'s values in
        place."""
        for t in self._macc_:
            t.zero_()
        if not self._softmax:
            self._macc_[2].fill_(numpy.inf)

    # -- the step ------------------------------------------------------------
    def _logits(self, x, seed=None):
        """The chain's logits (the output for MSE); ``seed`` (train
        steps) keys the stochastic forwards."""
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
        last = self.forwards[-1]
        if self._softmax:
            return last.apply_logits(self._params_[-1], h)
        return last.apply(self._params_[-1], h)

    def _loss(self, out, y, mask):
        if self._softmax:
            return EvaluatorSoftmax.loss_from_logits(out, y, mask)
        return EvaluatorMSE.loss_from_output(out, y, mask)

    def _observable(self, out):
        """What ``output`` shows: probabilities for a softmax head (the
        graph forward's output), the output itself for MSE."""
        return torch.softmax(out, dim=-1) if self._softmax else out

    def _accumulate(self, probs, y, mask):
        """Fold one step's outputs into the device accumulator (the graph
        evaluator's side channels)."""
        if not self._softmax:
            sse, mx, mn = self._macc_
            err = (probs - y).reshape(probs.shape[0], -1)
            sample_mse = (err * err).mean(dim=1)
            rmse = torch.sqrt(sample_mse)
            valid = mask > 0
            sse += (sample_mse * mask).sum()
            torch.maximum(mx, torch.where(valid, rmse, -numpy.inf).max(),
                          out=mx)
            torch.minimum(mn, torch.where(valid, rmse, numpy.inf).min(),
                          out=mn)
            return
        n_err, cm, mx = self._macc_
        pred = torch.argmax(probs, dim=-1)
        valid = mask > 0
        n_err += ((pred != y) & valid).sum()
        onehot = torch.nn.functional.one_hot(y, self._n_classes).to(
            probs.dtype)
        err_rows = (probs - onehot).abs().sum(dim=1) * mask
        torch.maximum(mx, err_rows.max(), out=mx)
        cm.index_put_((pred, y), valid.to(cm.dtype), accumulate=True)

    def _train_step(self, x, y, mask, seed, in_place=False):
        """One train step on ``x``, ``y`` under ``mask`` with the key of
        ``seed`` (an int, or a 0-d tensor on the step's device); with
        ``in_place`` the new solver state is copied into the old
        tensors instead of replacing them."""
        flat = [p for layer in self._params_ for p in layer.values()]
        logits = self._logits(x, seed)
        loss = self._loss(logits, y, mask)
        grads = iter(torch.autograd.grad(loss, flat))
        # the JAX step's f32 product f32(lr) * f32(lr_scale) (its scale
        # is an f32 argument of the jitted step; fault C16), made on the
        # host: a captured graph bakes it in (ScanEpochStep captures
        # again when the scale moves)
        lr_scale = numpy.float32(self.lr_scale)
        with torch.no_grad():
            for gd, params, opt in zip(self.gd_units, self._params_,
                                       self._opt_):
                for name, p in params.items():
                    decay, l1l2, ortho = gd.decay_for(name)
                    g = solvers.regularized_grad(next(grads), p, decay,
                                                 l1l2, ortho)
                    delta, state = gd.solver.update(
                        g, p, opt[name],
                        float(numpy.float32(gd.lr_for(name)) * lr_scale))
                    p.add_(delta)
                    if in_place:
                        for old, new in zip(opt[name], state):
                            old.copy_(new)
                    else:
                        opt[name] = state
            probs = self._observable(logits.detach())
            self._accumulate(probs, y, mask)
        return loss.detach(), probs

    def _eval_step(self, x, y, mask):
        with torch.no_grad():
            logits = self._logits(x)
            loss = self._loss(logits, y, mask)
            probs = self._observable(logits)
            self._accumulate(probs, y, mask)
        return loss, probs

    def _gather(self, idx):
        """(x, y) at the indices ``idx`` of the resident dataset."""
        return (torch.index_select(self._data_dev_, 0, idx),
                torch.index_select(self._y_dev_, 0, idx))

    def _staged(self):
        """The ``(indices, size)`` a MinibatchPrefetcher staged on the
        device for this step, or None."""
        if not self._use_gather_:
            return None
        return getattr(self.gather_loader, "prefetch_staged_", None)

    def _seed_tensor(self, seed):
        """``seed`` as a 0-d int64 tensor on the step's device (pinned
        and asynchronous on the card)."""
        t = torch.tensor(seed, dtype=torch.int64)
        if self._dev_.type == "cuda":
            t = t.pin_memory().to(self._dev_, non_blocking=True)
        return t

    def _staged_seed_arg(self):
        """The train seed of the staged path, a 0-d tensor on the step's
        device.  The NEXT seed is made right after this one is taken, on
        the device (this one plus 1, as the counter moves), so it is
        ready under the step in flight, as the JAX step stages it with a
        ``device_put``; a seed staged for another counter (the first
        step, a restored run) is copied from the host now."""
        staged = getattr(self, "_staged_seed_", None)
        if staged is not None and staged[0] == self._seed_counter:
            arg = staged[1]
        else:
            arg = self._seed_tensor(self._seed_counter)
        nxt = (self._seed_counter + 1) % 0x7FFF0000
        self._staged_seed_ = (nxt, torch.remainder(arg + 1, 0x7FFF0000))
        return arg

    def _minibatch(self, staged=None):
        """(x, y) of the current minibatch on the step's device."""
        if staged is not None:
            return self._gather(staged[0])
        if self._use_gather_:
            idx = torch.from_numpy(self.gather_loader._padded_indices_)
            if self._dev_.type == "cuda":
                # pinned and asynchronous: the host runs ahead of the card
                idx = idx.pin_memory().to(self._dev_, non_blocking=True)
            return self._gather(idx)
        x = self.minibatch_data.devmem.to(self._dev_)
        if not self._softmax:
            return x, self.minibatch_targets.devmem.to(self._dev_)
        # a short minibatch's padded labels are -1: any class will do
        # under the mask
        y = self.minibatch_labels.devmem.to(self._dev_, torch.int64)
        return x, y.clamp_min(0)

    def _mask(self, rows, size):
        """1.0 on the first ``size`` (an int or a device scalar) of
        ``rows`` rows, 0.0 on the padding."""
        return (torch.arange(rows, device=self._dev_) < size).to(
            torch.float32)

    def run(self):
        staged = self._staged()
        size = int(self.minibatch_size) if staged is None else staged[1]
        x, y = self._minibatch(staged)
        mask = self._mask(x.shape[0], size)
        if self.minibatch_class == loader_mod.TRAIN:
            self._seed_counter = (self._seed_counter + 1) % 0x7FFF0000
            # only stochastic forwards read the seed
            seed = (self._staged_seed_arg() if staged is not None and
                    any(f.stochastic for f in self.forwards)
                    else self._seed_counter)
            self.loss, probs = self._train_step(x, y, mask, seed)
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
        Arrays: one transfer per class boundary, not per step, then zero
        it in place.  The confusion matrix stays on the device until
        someone reads it."""
        if not self._softmax:
            sse, mx, mn = torch.stack(self._macc_).double().tolist()
            m = self.metrics.map_write()
            m[0] += sse
            m[1] = max(m[1], mx)
            m[2] = min(m[2], mn)
            self._macc_reset()
            return
        n_err, cm, mx = self._macc_
        if self._cm_dev_ is None:
            # a restored step goes on from the snapshot's counts (fault
            # C12), as the JAX step seeds its total from the host
            host = self.confusion_matrix.map_read()
            self._cm_dev_ = cm + torch.as_tensor(host).to(cm) \
                if host is not None and host.any() else cm.clone()
        else:
            self._cm_dev_ = self._cm_dev_ + cm
        self.confusion_matrix.devmem = self._cm_dev_
        n, m = torch.stack((n_err.double(), mx.double())).tolist()
        self.n_err.map_write()[0] += int(n)
        self.max_err_output_sum.map_write()[0] = max(
            float(self.max_err_output_sum[0]), m)
        self._macc_reset()

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
