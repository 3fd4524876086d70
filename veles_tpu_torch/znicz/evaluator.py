"""Evaluator units: turn network output into a loss gradient and metrics.

The port's counterpart of ``veles_tpu/znicz/evaluator.py`` (the Znicz
EvaluatorSoftmax, cross-entropy with n_err and confusion-matrix
accounting, and EvaluatorMSE, the mean squared error against targets),
and the losses the fused train step minimizes (``loss_from_logits``,
``loss_from_output``).

Contract with the GD chain: ``err_output`` is the raw loss gradient at
the forward's output, not yet divided by the batch; the GD units divide
by the valid row count (``batch_size``).  Padded minibatch rows (past
``batch_size``) are zero in ``err_output`` and left out of the metrics.

The JAX units compute the metrics on the host (``map_read`` of the
output every minibatch).  Here they accumulate on the output's device
in the same evaluator-compatible Arrays (``n_err``,
``confusion_matrix``, ``max_err_output_sum``; ``metrics`` for MSE),
whose device copies are the current ones: a reader's ``map_read`` (the
Decision, at the end of a class) brings them to the host, so a
minibatch costs no host sync.  The counts are exact and the float
metrics the JAX units' f32 arithmetic (MSE's sums in float64 as
there).  ``loss`` is the minibatch's loss as a device scalar.
"""

import numpy
import torch

from ..memory import Array
from ..result_provider import IResultProvider
from .nn_units import NNUnitBase

__all__ = ["EvaluatorBase", "EvaluatorSoftmax", "EvaluatorMSE"]


class EvaluatorBase(NNUnitBase, IResultProvider):
    hide_from_registry = True
    view_group = "EVALUATOR"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = None           # linked: the last forward's output
        self.batch_size = None       # linked: loader.minibatch_size
        self.err_output = Array()

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        for value in self.__dict__.values():
            if isinstance(value, Array):
                value.initialize(self.device)

    @staticmethod
    def _dev(v):
        return v.devmem if isinstance(v, Array) else v

    def _masked(self, err):
        """``err`` with the rows past ``batch_size`` zeroed, and the
        valid row count."""
        bs = int(self.batch_size)
        valid = torch.arange(err.shape[0], device=err.device) < bs
        return torch.where(valid[:, None], err, err.new_zeros(())), bs


class EvaluatorSoftmax(EvaluatorBase):
    """Cross-entropy evaluator for All2AllSoftmax outputs.

    ``err_output = (y - onehot(labels))`` with padded rows zeroed;
    metrics: ``n_err`` (running, reset by the Decision at each class
    end), ``confusion_matrix`` [pred, true], ``max_err_output_sum`` (the
    largest row sum of ``|err|``) and ``loss`` (the minibatch's mean of
    ``-log(y[label] + 1e-30)``).
    """

    MAPPING = "evaluator_softmax"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.labels = None           # linked: loader.minibatch_labels
        self.max_idx = None          # linked: All2AllSoftmax.max_idx
        self.n_err = Array(numpy.zeros(1, numpy.int64))
        self.confusion_matrix = Array()
        self.max_err_output_sum = Array(numpy.zeros(1, numpy.float32))
        self.loss = None
        self.compute_confusion_matrix = bool(
            kwargs.get("compute_confusion_matrix", True))

    def initialize(self, device=None, **kwargs):
        n_classes = self.output.shape[-1]
        if self.compute_confusion_matrix and not self.confusion_matrix:
            self.confusion_matrix.mem = numpy.zeros(
                (n_classes, n_classes), numpy.int64)
        super().initialize(device=device, **kwargs)

    def run(self):
        y = self._dev(self.output)
        n_classes = y.shape[-1]
        labels = self._dev(self.labels).long()
        bs = int(self.batch_size)
        valid = labels[:bs]
        onehot = torch.nn.functional.one_hot(
            torch.clamp_min(labels, 0), n_classes).to(y.dtype)
        err, bs = self._masked(y - onehot)
        self.err_output.devmem = err
        pred = (self._dev(self.max_idx)[:bs].long()
                if self.max_idx is not None else torch.argmax(y[:bs], -1))
        self.n_err.devmem = self.n_err.devmem + (pred != valid).sum()
        probs = torch.gather(y[:bs], 1, valid[:, None])[:, 0]
        self.loss = -torch.log(probs + 1e-30).mean()
        self.max_err_output_sum.devmem = torch.maximum(
            self.max_err_output_sum.devmem,
            err[:bs].abs().sum(dim=1).max())
        if self.compute_confusion_matrix:
            cm = self.confusion_matrix.devmem
            cm.index_put_((pred, valid), torch.ones_like(pred),
                          accumulate=True)
            self.confusion_matrix.devmem = cm   # the device copy is newer

    def get_metric_values(self):
        return {"n_err": int(self.n_err[0]),
                "loss": None if self.loss is None else float(self.loss)}

    @staticmethod
    def loss_from_logits(logits, labels, mask):
        """Numerically-stable masked softmax cross-entropy: the mean of
        ``-log softmax(logits)[label]`` over the rows where ``mask`` is
        1 (padded rows of a short minibatch carry 0)."""
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


class EvaluatorMSE(EvaluatorBase):
    """MSE evaluator: ``err_output = y - target`` with padded rows
    zeroed; ``mse`` holds each valid sample's rmse, and ``metrics``
    (float64) accumulates [the sum of per-sample mean squared errors,
    the largest sample rmse, the smallest] until the Decision resets
    it."""

    MAPPING = "evaluator_mse"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.target = None           # linked: loader.minibatch_targets
        self.metrics = Array(numpy.array([0.0, 0.0, numpy.inf]))
        self.mse = Array()

    def run(self):
        y = self._dev(self.output)
        t = self._dev(self.target)
        err, bs = self._masked((y - t).reshape(y.shape[0], -1))
        self.err_output.devmem = err.reshape(y.shape)
        sample_mse = (err[:bs] ** 2).mean(dim=1)
        rmse = torch.sqrt(sample_mse)
        self.mse.devmem = rmse
        m = self.metrics.devmem
        self.metrics.devmem = torch.stack((
            m[0] + sample_mse.sum().double(),
            torch.maximum(m[1], rmse.max().double()),
            torch.minimum(m[2], rmse.min().double())))

    def get_metric_values(self):
        m = self.metrics.map_read()
        return {"mse_sum": float(m[0]), "max_mse": float(m[1]),
                "min_mse": float(m[2])}

    @staticmethod
    def loss_from_output(y, target, mask):
        """Masked MSE whose gradient at ``y`` is exactly ``err *
        mask / n_valid``, the gradient graph mode produces (the evaluator
        emits ``err = y - t``, the GD units divide by the valid row
        count), so fused and graph MSE training agree step for step.
        Value: half the squared error summed over features, averaged
        over the valid rows."""
        err = (y - target).reshape(y.shape[0], -1)
        per_sample = 0.5 * (err * err).sum(dim=1)
        return (per_sample * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
