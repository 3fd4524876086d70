"""StandardWorkflow: config-driven NN training topology builder.

The port's counterpart of ``veles_tpu/znicz/standard_workflow.py`` (the
reference's StandardWorkflow, manualrst_veles_workflow_creation.rst:
101-146): builds repeater → loader → forwards → evaluator → decision →
GD units (reversed) → loop from a ``layers`` config list, each entry
``{"type": <MAPPING>, "->": {forward kwargs}, "<-": {gd kwargs}}``
(flat kwargs are accepted too and routed by the known GD
hyperparameter names).  ``loss_function`` is "softmax" (an
All2AllSoftmax head, :class:`~.decision.DecisionGD`) or "mse"
(:class:`~.decision.DecisionMSE`, a FullBatchLoaderMSE's targets).
A paramless layer type with no GD unit of its own (depooling, the
channel splitter and merger, zero_filler) gets a
:class:`~.nn_units.GenericVJPBackward`; a layer with parameters and no
GD unit raises ``ValueError``, as does a ``zero_filler`` layer in a
fused build (its masking runs only as a unit of graph mode).

Two modes, as in the JAX package:

- **fused** (the default): the forwards run inside one
  :class:`~.fused.FusedTrainStep` per minibatch, which gathers from the
  device-resident dataset of a FullBatchLoader; the graph carries the
  host-side control units (loader → step → decision);
- **graph** (``fused=False``): the per-unit chain.  The loader serves
  each minibatch (gathered on its device, or on the host with
  ``force_numpy``), each forward runs as a unit, the
  evaluator (EvaluatorSoftmax or EvaluatorMSE) turns the last output
  into ``err_output``, and the GD units run in reverse behind the
  train gate (``gate_skip`` on every non-train minibatch), the first
  layer's with ``need_err_input=False``.

Both share the forward and GD units, weights and solver state.
``initialize(device=None)`` means the card and raises without one;
``initialize(device=Device(backend="cpu"))`` runs the same workflow on
the host.

``snapshotter={...}`` adds a snapshotter after the decision (the
JAX ``_build``'s place): ``format`` (default
``root.common.snapshot.format``) chooses ``SnapshotterToFile``
("pickle"), ``SnapshotterToShards`` ("shards") or a registered family
member ("db": ``SnapshotterToDB``), the rest are its keyword arguments.
It shoots when validation ends on an improvement
(``skip = ~(improved & valid_ended)``), before the next train pass
moves the weights.  ``snapshotter.restore(path)`` gives the workflow
back; its ``initialize`` rebuilds the gates, the loader keeps its
shuffle order and normalizer, and the run goes on where it stopped.

Not ported yet: the epoch scan, meshes, the status reporter, the graph
compiler, the prefetcher and the ``mcdnnic_topology`` notation.  Each
of their knobs raises ``NotImplementedError`` when it is set to
anything but its default (:data:`REFUSED_KNOBS`), so a config that
would scan or shard under the JAX package never trains differently
here without a word.  ``web_status`` is accepted and ignored: the
status reporter only watches a run.
"""

from ..backends import Device
from ..config import root
from ..loader.fullbatch import FullBatchLoader
from ..plumbing import Repeater
from ..registry import MappedObjectsRegistry, UnitRegistry
from ..workflow import Workflow
from .all2all import All2AllSoftmax
from .nn_units import (ForwardBase, GenericVJPBackward,
                       GradientDescentBase, ParamlessForward)
from .decision import DecisionGD, DecisionMSE
from .evaluator import EvaluatorSoftmax, EvaluatorMSE
from .fused import FusedTrainStep
# registers the layer MAPPINGs
from . import (activation, all2all, attention, conv, dropout,  # noqa: F401
               gd, gd_conv, gd_pooling, lrn, misc_units, pooling)

__all__ = ["StandardWorkflow", "REFUSED_KNOBS"]

#: knobs of the JAX workflow the port does not honour yet: name ->
#: (the values that mean "off", the ROADMAP queue A item that ports it)
REFUSED_KNOBS = {
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
    the unit registry; gd is None where no GD unit has the MAPPING."""
    fwd = gd_cls = None
    for cls in UnitRegistry.units.values():
        if getattr(cls, "MAPPING", None) != type_name:
            continue
        if issubclass(cls, ForwardBase):
            fwd = cls
        elif issubclass(cls, GradientDescentBase):
            gd_cls = cls
    if fwd is None:
        raise ValueError("unknown layer type %r (the port has: %s)" % (
            type_name, ", ".join(sorted(
                {c.MAPPING for c in UnitRegistry.units.values()
                 if issubclass(c, ForwardBase) and c.MAPPING}))))
    return fwd, gd_cls


class StandardWorkflow(Workflow):
    """repeater → loader → fused step → decision → loop, or with
    ``fused=False`` repeater → loader → forwards → evaluator → decision
    → GD units → loop."""

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
        self.fused = bool(kwargs.get("fused", True))
        self.layers_config = list(kwargs.get("layers", ()))
        self.loss_function = kwargs.get("loss_function", "softmax")
        if self.loss_function not in ("softmax", "mse"):
            raise ValueError("unknown loss_function %r (softmax or mse)"
                             % (self.loss_function,))
        self.decision_config = dict(kwargs.get("decision", {}))
        self.loader_config = dict(kwargs.get("loader", {}))
        self.trainer_config = dict(kwargs.get("trainer", {}))
        self.snapshotter_config = kwargs.get("snapshotter")  # dict | None
        self.snapshotter = None
        loader_factory = kwargs.get("loader_factory")
        if loader_factory is None:
            raise ValueError("StandardWorkflow requires loader_factory")
        self.repeater = Repeater(self)
        self.loader = loader_factory(self, **self.loader_config)
        self.forwards = []
        self.gds = []
        self.fused_step = None
        self.evaluator = None
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
        """Units in the JAX ``_build``'s order (the forwards, graph
        mode's evaluator, the decision, the GD units, the step), so the
        unit list, and with it the checksum and a package's
        ``contents.json``, is the JAX workflow's."""
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        gd_pairs = []
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
            gd_pairs.append((gd_cls, gd_kwargs))
        if not self.forwards:
            raise ValueError("StandardWorkflow needs at least one layer")
        softmax = self.loss_function == "softmax"
        if not self.fused:
            self.evaluator = (EvaluatorSoftmax if softmax
                              else EvaluatorMSE)(self)
        self.decision = (DecisionGD if softmax else DecisionMSE)(
            self, **self.decision_config)
        # the GD units own the solver state and hyperparameters the
        # fused step reads
        for (gd_cls, gd_kwargs), fwd in zip(gd_pairs, self.forwards):
            if gd_cls is None:
                if not isinstance(fwd, ParamlessForward):
                    raise ValueError(
                        "no GD unit registered for parameterized layer %r"
                        % type(fwd).MAPPING)
                gd_cls = GenericVJPBackward  # paramless structural layer
            self.gds.append(gd_cls(self, **gd_kwargs).link_forward(fwd))
        if self.snapshotter_config is not None:
            self._build_snapshotter(dict(self.snapshotter_config))
        tail = self._build_fused() if self.fused else self._build_graph()
        self.repeater.link_from(tail)
        self.end_point.link_from(tail)
        self._relink_gates()

    def _build_snapshotter(self, cfg):
        """The snapshotter of ``format`` (JAX ``_build``)."""
        fmt = cfg.pop("format", None)
        if fmt is None:
            fmt = root.common.snapshot.get("format", "pickle")
        if fmt in ("shards", "sharded"):
            from ..checkpoint import SnapshotterToShards as snap_cls
        elif fmt in ("pickle", "file", None):
            from ..snapshotter import SnapshotterToFile as snap_cls
        else:
            from ..snapshotter import SnapshotterBase
            snap_cls = MappedObjectsRegistry.get(SnapshotterBase.mapping,
                                                 fmt)
        self.snapshotter = snap_cls(self, **cfg)
        self.snapshotter.link_decision(self.decision)

    def _link_snapshotter(self, tail):
        if self.snapshotter is None:
            return tail
        self.snapshotter.link_from(tail)
        return self.snapshotter

    def _build_fused(self):
        for fwd in self.forwards:
            if isinstance(fwd, misc_units.ZeroFiller):
                raise ValueError(
                    "zero_filler is graph-mode only; use Conv(grouping=N) "
                    "in fused workflows (see ZeroFiller docstring)")
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
        return self._link_snapshotter(self.decision)

    def _build_graph(self):
        """The per-unit chain (JAX ``_build_graph``); returns its last
        unit."""
        prev = self.loader
        for fwd in self.forwards:
            fwd.link_from(prev)
            # train minibatches draw keys and keep graphs for the GDs
            fwd.link_attrs(self.loader, "minibatch_class")
            prev = fwd
        last_fwd = self.forwards[-1]
        softmax = self.loss_function == "softmax"
        self.evaluator.link_from(last_fwd)
        self.evaluator.link_attrs(last_fwd, "output")
        if isinstance(last_fwd, All2AllSoftmax):
            self.evaluator.link_attrs(last_fwd, "max_idx")
        self.evaluator.link_attrs(
            self.loader, ("labels", "minibatch_labels") if softmax else
            ("target", "minibatch_targets"),
            ("batch_size", "minibatch_size"))
        self.decision.link_from(self.evaluator)
        self.decision.link_loader(self.loader)
        self.decision.link_evaluator(self.evaluator)
        prev = self._link_snapshotter(self.decision)
        for i in reversed(range(len(self.forwards))):
            gd = self.gds[i]
            gd.link_from(prev)
            gd.link_attrs(self.loader, ("batch_size", "minibatch_size"))
            if i == len(self.forwards) - 1:
                gd.link_attrs(self.evaluator, "err_output")
            else:
                gd.link_attrs(self.gds[i + 1], ("err_output", "err_input"))
            if i == 0:
                gd.need_err_input = False  # nothing below to backprop into
            prev = gd
        return prev

    def _relink_gates(self):
        """The loop's gates from the live decision and loader: the
        repeater and the end point on ``complete``, the snapshotter's
        ``skip`` (it shoots when validation ends on an improvement), and
        in graph mode the GD units' train gate (``gate_skip`` on every
        non-train minibatch).  Derived Bools flatten to constants on
        pickle, so a restored workflow rebuilds them (JAX
        ``_relink_gates``)."""
        self.repeater.gate_block = self.decision.complete
        self.end_point.gate_block = ~self.decision.complete
        self.decision.complete <<= False
        if self.snapshotter is not None:
            self.snapshotter.skip = ~(self.decision.improved &
                                      self.loader.valid_ended)
        if not self.fused:
            train_gate = self.make_train_gate(self.loader)
            for gd in self.gds:
                gd.gate_skip = train_gate

    def initialize(self, device=None, **kwargs):
        """Bring every unit up on ``device`` (default: ``Device()``, the
        card; raises without one)."""
        if device is None:
            device = Device()
        if self.restored_from_snapshot:
            self._relink_gates()
        return super().initialize(device=device, **kwargs)

    def run(self):
        result = super().run()
        if self.fused_step is not None:
            self.fused_step.sync_weights()
        return result
