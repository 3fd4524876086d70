"""The forward chain of a package: ``model.json`` written and rebuilt.

The port of ``veles_tpu/export/model.py``.  The JAX package serializes
its forward chain as one StableHLO program (``model.stablehlo``); the
port cannot write StableHLO and does not read it.  It keeps what the
JAX package writes beside that program, ``model.json``: the input's
sample shape, dtype and batch, and for each forward its unit name,
class, parameter names and ``export_params()`` (``config``).  That is
what the native engine rebuilds the chain from
(``native/src/engine.cc:465-534``), and what :func:`build_forwards`
rebuilds it from out of the port's own units, eval mode, on a device:
on the card each unit then launches its hand kernels as a live
workflow's do.
"""

import json

import numpy

from ..device import resolve_device

__all__ = ["FORMAT", "build_forwards", "export_forward", "export_model",
           "forward_fn"]

#: ``model.json``'s ``format``: the chain is its units, no program
FORMAT = "veles_tpu_torch/units"

#: class name in ``model.json`` -> (module under ``veles_tpu_torch``,
#: class): the native engine's list of classes it rebuilds
_CLASSES = dict(
    [(name, ("znicz.all2all", name)) for name in (
        "All2All", "All2AllTanh", "All2AllSigmoid", "All2AllRELU",
        "All2AllStrictRELU", "All2AllSoftmax")] +
    [(name, ("znicz.conv", name)) for name in (
        "Conv", "ConvTanh", "ConvSigmoid", "ConvRELU", "ConvStrictRELU")] +
    [(name, ("znicz.pooling", name)) for name in (
        "MaxPooling", "AvgPooling")] +
    [("LRNormalizerForward", ("znicz.lrn", "LRNormalizerForward")),
     ("DropoutForward", ("znicz.dropout", "DropoutForward")),
     ("MultiHeadAttention", ("znicz.attention", "MultiHeadAttention"))] +
    [(name, ("znicz.activation", name)) for name in (
        "ForwardTanh", "ForwardSigmoid", "ForwardRELU",
        "ForwardStrictRELU")])

#: forward classes of the JAX package whose packages the port refuses,
#: and why: not ported yet (by their ROADMAP queue A item), or ported
#: but not recorded in a package (the JAX units define no
#: ``export_params``, so their ``model.json`` ``config`` is ``{}``)
_UNPORTED = "the unit is not ported yet (ROADMAP queue A %s)"
_UNRECORDED = ("the JAX package records no configuration for it (the unit "
               "has no export_params; its model.json config is {}), so the "
               "chain cannot be rebuilt without model.stablehlo, which the "
               "port does not run")
_REFUSED = dict(
    [(name, _UNPORTED % "item 9") for name in (
        "ResizableAll2All", "KohonenForward", "SimpleRNN", "LSTM")] +
    [(name, _UNPORTED % "item 6b") for name in (
        "StochasticPooling", "StochasticAbsPooling",
        "StochasticPoolingDepooling", "StochasticAbsPoolingDepooling")] +
    [(name, _UNRECORDED) for name in (
        "Cutter", "ChannelSplitter", "ChannelMerger", "ZeroFiller",
        "Deconv", "Depooling")])


def forward_fn(forwards):
    """The chained eval-mode forward over explicit params (a list of
    ``{name: tensor}``, one a unit)."""
    def fn(params, x):
        h = x
        for fwd, p in zip(forwards, params):
            h = fwd.apply(p, h)
        return h
    return fn


def export_forward(workflow, batch="b"):
    """The ``model.json`` metadata of the workflow's forward chain.

    ``batch``: a dimension name (the package serves any batch size) or
    an int (a static-batch package: a server takes only that size)."""
    forwards = workflow.forwards
    if not forwards:
        raise ValueError("workflow has no forward units to export")
    sample_shape = [int(d) for d in forwards[0].input_shape[1:]]
    if not isinstance(batch, str):
        batch = int(batch)
    return {
        "format": FORMAT,
        "input": {"sample_shape": sample_shape,
                  "dtype": str(numpy.dtype(numpy.float32)),
                  "batch": batch},
        "forwards": [
            {"unit": f.name, "class": type(f).__name__,
             "params": sorted(f.params),
             "config": f.export_params()
             if hasattr(f, "export_params") else {}}
            for f in forwards],
    }


def export_model(workflow, path, precision=32, batch="b"):
    """The package with ``model.json`` (and no ``model.stablehlo``)."""
    from .packager import package_export
    metadata = export_forward(workflow, batch=batch)
    return package_export(
        workflow, path, precision=precision,
        extra_files={"model.json": json.dumps(metadata, indent=2)})


def _unit_class(name):
    if name in _REFUSED:
        raise NotImplementedError("a package holding %s cannot be served: "
                                  "%s" % (name, _REFUSED[name]))
    if name not in _CLASSES:
        raise ValueError("a package unit of class %r: the forward chain "
                         "rebuilds %s" % (name, ", ".join(sorted(_CLASSES))))
    import importlib
    module, cls = _CLASSES[name]
    return getattr(importlib.import_module(
        "veles_tpu_torch." + module), cls)


def build_forwards(model_metadata, arrays=None, device=None):
    """Rebuild the package's forward chain from the port's units, eval
    mode, on ``device`` (default: the card, raising without one).

    ``model_metadata`` is ``model.json``; ``arrays`` (``{unit: {attr:
    array}}``, a :class:`~.loader.PackageLoader`'s) is checked to hold
    each unit's parameters.  The units hold no weights: the chain runs
    as ``forward_fn(units)(params, x)``.  Each unit reads the engine
    knobs a live unit reads (``root.common.engine.precise_gemm``,
    ``use_pallas``), so on the card the All2All family launches K4
    under ``precise_gemm``, LRN K5 and attention K7; nothing falls back
    to the plain versions there."""
    from ..backends import Device
    if model_metadata is None:
        raise ValueError("package has no model.json metadata")
    dev = resolve_device(device)
    unit_device = Device(backend=dev.type)
    units = []
    for spec in model_metadata["forwards"]:
        cls = _unit_class(spec["class"])
        missing = set(spec["params"]) - set(
            (arrays or {}).get(spec["unit"], {}))
        if arrays is not None and missing:
            raise ValueError("package unit %r lacks %s"
                             % (spec["unit"], sorted(missing)))
        config = {k: v for k, v in spec["config"].items()
                  if k != "neurons"}
        unit = cls(None, name=spec["unit"], **config)
        unit.device = unit_device
        units.append(unit)
    return units
