"""Decision units: epoch accounting, best-error tracking, stop conditions.

The port's copy of ``veles_tpu/znicz/decision.py`` (the Znicz
DecisionGD and DecisionMSE, and TrivialDecision).  The Decision sits
after the train step (fused mode) or the evaluator (graph mode),
watches the loader's class/epoch flags, and drives the control plane:

- reads the per-class error count at each class boundary;
- on epoch end: computes percentages, tracks the best validation error,
  raises ``improved`` (gates a snapshotter) and ``complete`` (ends the
  main loop) Bools;
- stop conditions: ``max_epochs`` reached, or ``fail_iterations`` epochs
  without validation improvement (early stopping).

Pure host-side control: it reads the evaluator's metric Arrays (the
fused step's, or a graph evaluator's) at the end of each class.
"""

import numpy

from ..mutable import Bool
from ..result_provider import IResultProvider
from ..units import Unit
from .. import loader as loader_mod

__all__ = ["DecisionBase", "DecisionGD", "DecisionMSE", "TrivialDecision"]


class DecisionBase(Unit):
    hide_from_registry = True
    view_group = "PLUMBING"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.train_improved = Bool(False)
        self.max_epochs = kwargs.get("max_epochs")
        self.fail_iterations = kwargs.get("fail_iterations", 100)
        # linked from loader:
        self.last_minibatch = None
        self.epoch_ended = None
        self.minibatch_class = None
        self.minibatch_size = None
        self.class_lengths = None
        self.epoch_number = None

    def link_loader(self, loader):
        self.link_attrs(loader, "last_minibatch", "epoch_ended",
                        "minibatch_class", "minibatch_size",
                        "class_lengths", "epoch_number")
        return self


class DecisionGD(DecisionBase, IResultProvider):
    """Decision for classification training (n_err driven)."""

    MAPPING = "decision_gd"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.evaluator = None
        self.n_err = None            # linked: evaluator.n_err Array
        self.epoch_n_err = [0, 0, 0]
        self.epoch_n_err_pt = [100.0, 100.0, 100.0]
        self.best_n_err = None
        self.best_n_err_pt = None
        self.best_epoch = -1
        self.epochs_without_improvement = 0
        self.silent = bool(kwargs.get("silent", False))

    def link_evaluator(self, evaluator):
        self.evaluator = evaluator
        self.link_attrs(evaluator, "n_err")
        return self

    def run(self):
        if not bool(self.last_minibatch):
            return
        cls = self.minibatch_class
        self.epoch_n_err[cls] = int(self.n_err[0])
        length = self.class_lengths[cls] or 1
        self.epoch_n_err_pt[cls] = 100.0 * self.epoch_n_err[cls] / length
        # reset the evaluator's accumulator for the next class/epoch
        self.n_err.map_write()[0] = 0
        if cls == loader_mod.VALID:
            self._on_validation_end()
        if bool(self.epoch_ended):
            self._on_epoch_end()

    def _on_validation_end(self):
        err = self.epoch_n_err[loader_mod.VALID]
        if self.best_n_err is None or err < self.best_n_err:
            self.best_n_err = err
            self.best_n_err_pt = self.epoch_n_err_pt[loader_mod.VALID]
            self.best_epoch = self.epoch_number
            self.epochs_without_improvement = 0
            self.improved <<= True
        else:
            self.epochs_without_improvement += 1
            self.improved <<= False

    def _on_epoch_end(self):
        if not self.silent:
            print("Epoch %d: validation %.2f%%, train %.2f%%%s" % (
                self.epoch_number,
                self.epoch_n_err_pt[loader_mod.VALID],
                self.epoch_n_err_pt[loader_mod.TRAIN],
                " *" if bool(self.improved) else ""))
        if self.max_epochs is not None and \
                self.epoch_number + 1 >= self.max_epochs:
            self.complete <<= True
        if self.epochs_without_improvement >= self.fail_iterations:
            self.complete <<= True

    def get_metric_values(self):
        return {
            "best_validation_error_pt": self.best_n_err_pt,
            "best_epoch": self.best_epoch,
            "train_error_pt": self.epoch_n_err_pt[loader_mod.TRAIN],
        }


class DecisionMSE(DecisionBase, IResultProvider):
    """Decision for regression training (rmse driven; the reference's
    decision.DecisionMSE)."""

    MAPPING = "decision_mse"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.metrics = None          # linked: evaluator.metrics Array
        self.epoch_rmse = [0.0, 0.0, 0.0]
        self.best_rmse = None
        self.best_epoch = -1
        self.epochs_without_improvement = 0
        self.silent = bool(kwargs.get("silent", False))

    def link_evaluator(self, evaluator):
        self.link_attrs(evaluator, "metrics")
        return self

    def run(self):
        if not bool(self.last_minibatch):
            return
        cls = self.minibatch_class
        n = (self.class_lengths[cls] or 1)
        # metrics[0] accumulates per-sample mean squared error
        self.epoch_rmse[cls] = float(numpy.sqrt(self.metrics[0] / n))
        m = self.metrics.map_write()
        m[0] = 0
        m[1] = 0
        m[2] = numpy.inf
        if cls == loader_mod.VALID:
            rmse = self.epoch_rmse[loader_mod.VALID]
            if self.best_rmse is None or rmse < self.best_rmse:
                self.best_rmse = rmse
                self.best_epoch = self.epoch_number
                self.epochs_without_improvement = 0
                self.improved <<= True
            else:
                self.epochs_without_improvement += 1
                self.improved <<= False
        if bool(self.epoch_ended):
            if not self.silent:
                print("Epoch %d: validation rmse %.4f, train rmse %.4f%s" % (
                    self.epoch_number, self.epoch_rmse[loader_mod.VALID],
                    self.epoch_rmse[loader_mod.TRAIN],
                    " *" if bool(self.improved) else ""))
            if self.max_epochs is not None and \
                    self.epoch_number + 1 >= self.max_epochs:
                self.complete <<= True
            if self.epochs_without_improvement >= self.fail_iterations:
                self.complete <<= True

    def get_metric_values(self):
        return {"best_validation_rmse": self.best_rmse,
                "best_epoch": self.best_epoch}


class TrivialDecision(DecisionBase):
    """Fixed-epoch-count decision with no metric tracking."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("max_epochs", 1)
        super().__init__(workflow, **kwargs)

    def run(self):
        if bool(self.epoch_ended) and \
                self.epoch_number + 1 >= self.max_epochs:
            self.complete <<= True
