"""WeightsRollback: restore the best weights when training degrades.

The port of ``veles_tpu/znicz/rollback.py`` (the Znicz rollback unit):
at the end of each epoch whose validation improved it keeps a copy of
the fused step's parameters and solver state; when validation has not
improved for a multiple of ``improvement_limit`` epochs it restores
that copy and multiplies the step's ``lr_damping`` and ``lr_scale`` by
``lr_damping``.

The step updates its tensors in place, and a
:class:`~.scan_step.ScanEpochStep` replays CUDA graphs captured on
them, so the copy is a set of clones and a restore writes the clones
into the step's live tensors (``copy_``): the per-step path, the
scanned eager rows and every replayed graph go on from the restored
values.  Rebinding the step's lists instead, as the JAX unit may, would
leave the graphs training the old tensors.

    rb = WeightsRollback(wf, improvement_limit=1, lr_damping=0.5)
    rb.link_from(wf.decision)
    rb.link_all(wf.fused_step, wf.decision, wf.loader)
"""

import torch

from ..units import Unit

__all__ = ["WeightsRollback"]


def _clone(state):
    return tuple(s.detach().clone() for s in state) \
        if isinstance(state, tuple) else state.detach().clone()


def _copy_into(live, saved):
    if isinstance(live, tuple):
        for dst, src in zip(live, saved):
            dst.copy_(src)
    else:
        live.copy_(saved)


class WeightsRollback(Unit):
    """Keeps the best epoch's parameters and solver state (``rollbacks``
    counts the restores)."""

    MAPPING = "weights_rollback"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.improvement_limit = int(kwargs.get("improvement_limit", 4))
        self.lr_damping = float(kwargs.get("lr_damping", 1.0))
        self.fused_step = None
        self.decision = None
        self.loader = None
        self.epoch_ended = None      # linked
        self.rollbacks = 0

    def init_unpickled(self):
        super().init_unpickled()
        # the copy is transient: a restored unit keeps none until the
        # next improvement (the JAX unit's restore has no attribute)
        self._best_params_ = None
        self._best_opt_ = None

    def link_all(self, fused_step, decision, loader):
        self.fused_step = fused_step
        self.decision = decision
        self.loader = loader
        self.link_attrs(loader, "epoch_ended")
        self.gate_skip = ~loader.epoch_ended
        return self

    def initialize(self, **kwargs):
        super().initialize(**kwargs)
        if self.loader is not None:
            # a derived Bool pickles as its value: a restored unit
            # rebuilds its epoch gate (the JAX unit's stays constant)
            self.gate_skip = ~self.loader.epoch_ended

    def run(self):
        step = self.fused_step
        if bool(self.decision.improved):
            self._best_params_ = [{k: _clone(v) for k, v in layer.items()}
                                  for layer in step._params_]
            self._best_opt_ = [{k: _clone(v) for k, v in layer.items()}
                               for layer in step._opt_]
            return
        stale = getattr(self.decision, "epochs_without_improvement", 0)
        if self._best_params_ is not None and \
                stale and stale % self.improvement_limit == 0:
            with torch.no_grad():
                for live, saved in zip(step._params_, self._best_params_):
                    for k, v in live.items():
                        _copy_into(v, saved[k])
                for live, saved in zip(step._opt_, self._best_opt_):
                    for k, v in live.items():
                        _copy_into(v, saved[k])
            # the damping apart, so a LearningRateAdjuster's per-epoch
            # assignment composes with it instead of erasing it
            step.lr_damping = getattr(step, "lr_damping", 1.0) * \
                self.lr_damping
            step.lr_scale = float(step.lr_scale) * self.lr_damping
            step.sync_weights()
            self.rollbacks += 1
