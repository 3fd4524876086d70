"""StandardWorkflow: config-driven NN training topology builder.

The port's counterpart of ``veles_tpu/znicz/standard_workflow.py`` (the
reference's StandardWorkflow, manualrst_veles_workflow_creation.rst:
101-146): builds repeater → loader → fused train step → decision → loop
from a ``layers`` config list, each entry ``{"type": <MAPPING>, "->":
{forward kwargs}, "<-": {gd kwargs}}`` (flat kwargs are accepted too and
routed by the known GD hyperparameter names).

Only the fused mode is ported: the forwards run inside one
:class:`~.fused.FusedTrainStep` per minibatch, which gathers from the
device-resident dataset of a FullBatchLoader; the graph carries the
host-side control units.  ``initialize(device=None)`` means the card
and raises without one; ``initialize(device=Device(backend="cpu"))``
runs the same workflow on the host.

Not ported yet: graph mode (per-unit GD and evaluator units), the
epoch scan, meshes, the snapshotter, the status reporter, the graph
compiler, the prefetcher and the ``mcdnnic_topology`` notation.  Each
of their knobs raises ``NotImplementedError`` when it is set to
anything but its default (:data:`REFUSED_KNOBS`), so a config that
would snapshot, scan or shard under the JAX package never trains
differently here without a word.  ``web_status`` is accepted and
ignored: the status reporter only watches a run.
"""

from ..backends import Device
from ..loader.fullbatch import FullBatchLoader
from ..plumbing import Repeater
from ..registry import UnitRegistry
from ..workflow import Workflow
from .nn_units import ForwardBase, GradientDescentBase
from .decision import DecisionGD
from .fused import FusedTrainStep
# registers the layer MAPPINGs
from . import (activation, all2all, attention, conv, dropout,  # noqa: F401
               gd, gd_conv, gd_pooling, lrn, pooling)

__all__ = ["StandardWorkflow", "REFUSED_KNOBS"]

#: knobs of the JAX workflow the port does not honour yet: name ->
#: (the values that mean "off", the ROADMAP queue A item that ports it)
REFUSED_KNOBS = {
    "snapshotter": ((None,), "item 8, persistence"),
    "epoch_scan": ((False, None), "item 7, ScanEpochStep"),
    "mesh": ((None,), "item 11, distribution"),
    "model_axis": ((None,), "item 11, distribution"),
    "tp_mode": (("column",), "item 11, distribution"),
    "graph_compile": ((None, False), "item 9, graphcomp"),
}

#: flat layer-config keys that belong to the GD unit
_GD_KEYS = {"learning_rate", "learning_rate_bias", "weights_decay",
            "weights_decay_bias", "l1_vs_l2", "l1_vs_l2_bias",
            "gradient_moment", "solver", "solver_parameters",
            "factor_ortho"}


def _find_pair(type_name):
    """Resolve a layer-type MAPPING to its (forward, gd) classes through
    the unit registry."""
    fwd = gd_cls = None
    for cls in UnitRegistry.units.values():
        if getattr(cls, "MAPPING", None) != type_name:
            continue
        if issubclass(cls, ForwardBase):
            fwd = cls
        elif issubclass(cls, GradientDescentBase):
            gd_cls = cls
    if fwd is None or gd_cls is None:
        raise ValueError("unknown layer type %r (the port has: %s)" % (
            type_name, ", ".join(sorted(
                {c.MAPPING for c in UnitRegistry.units.values()
                 if issubclass(c, ForwardBase) and c.MAPPING}))))
    return fwd, gd_cls


class StandardWorkflow(Workflow):
    """repeater → loader → fused step → decision → loop."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        super().__init__(workflow, **kwargs)
        for knob, (off, item) in REFUSED_KNOBS.items():
            value = kwargs.get(knob, off[0])
            if value not in off:
                raise NotImplementedError(
                    "StandardWorkflow(%s=%r) is not ported yet (ROADMAP "
                    "queue A %s)" % (knob, value, item))
        if kwargs.get("mcdnnic_topology"):
            raise NotImplementedError(
                "mcdnnic_topology is not ported yet; pass layers=")
        if not kwargs.get("fused", True):
            raise NotImplementedError(
                "graph mode (fused=False) is not ported yet")
        self.layers_config = list(kwargs.get("layers", ()))
        self.loss_function = kwargs.get("loss_function", "softmax")
        if self.loss_function != "softmax":
            raise NotImplementedError(
                "loss_function=%r is not ported yet" % self.loss_function)
        self.decision_config = dict(kwargs.get("decision", {}))
        self.loader_config = dict(kwargs.get("loader", {}))
        self.trainer_config = dict(kwargs.get("trainer", {}))
        loader_factory = kwargs.get("loader_factory")
        if loader_factory is None:
            raise ValueError("StandardWorkflow requires loader_factory")
        self.repeater = Repeater(self)
        self.loader = loader_factory(self, **self.loader_config)
        self.forwards = []
        self.gds = []
        self.fused_step = None
        self.decision = None
        self._build()

    # -- construction --------------------------------------------------------
    @staticmethod
    def _split_layer_config(cfg):
        cfg = dict(cfg)
        type_name = cfg.pop("type")
        fwd_kwargs = dict(cfg.pop("->", {}))
        gd_kwargs = dict(cfg.pop("<-", {}))
        for k, v in cfg.items():
            (gd_kwargs if k in _GD_KEYS else fwd_kwargs).setdefault(k, v)
        return type_name, fwd_kwargs, gd_kwargs

    def _build(self):
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        for cfg in self.layers_config:
            type_name, fwd_kwargs, gd_kwargs = self._split_layer_config(cfg)
            fwd_cls, gd_cls = _find_pair(type_name)
            fwd = fwd_cls(self, **fwd_kwargs)
            prev = self.forwards[-1] if self.forwards else None
            if prev is None:
                fwd.link_attrs(self.loader, ("input", "minibatch_data"))
            else:
                fwd.link_attrs(prev, ("input", "output"))
            self.forwards.append(fwd)
            # the GD units own the solver state and hyperparameters the
            # fused step reads
            self.gds.append(gd_cls(self, **gd_kwargs).link_forward(fwd))
        if not self.forwards:
            raise ValueError("StandardWorkflow needs at least one layer")
        self.decision = DecisionGD(self, **self.decision_config)

        self.fused_step = FusedTrainStep(
            self, self.forwards, self.gds, loss=self.loss_function,
            **self.trainer_config)
        self.fused_step.link_from(self.loader)
        self.fused_step.link_loader(self.loader)
        if isinstance(self.loader, FullBatchLoader):
            # device-resident dataset: the gather rides inside the step
            self.fused_step.link_fused_gather(self.loader)
        self.decision.link_from(self.fused_step)
        self.decision.link_loader(self.loader)
        self.decision.link_evaluator(self.fused_step)
        self.repeater.link_from(self.decision)
        self.end_point.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        self.end_point.gate_block = ~self.decision.complete

    def initialize(self, device=None, **kwargs):
        """Bring every unit up on ``device`` (default: ``Device()``, the
        card; raises without one)."""
        if device is None:
            device = Device()
        return super().initialize(device=device, **kwargs)

    def run(self):
        result = super().run()
        self.fused_step.sync_weights()
        return result
