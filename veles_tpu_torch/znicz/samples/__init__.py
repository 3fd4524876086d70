"""Sample models of the port (the counterpart of
``veles_tpu.znicz.samples``): the flagship decode model (serving), the
StandardWorkflow training samples MNIST, MnistAE (the MNIST
autoencoder), Kanji (glyph denoising), Lines (a convnet built from an
``mcdnnic_topology`` string), AlexNet, the CIFAR and STL-10 convnets
and the VideoAE conv autoencoder, and DemoKohonen (``kohonen``, the
self-organizing map, trained without gradients).  DemoKohonen, MnistAE,
Kanji and Lines keep the JAX samples' ``run(load, main)``; the other
samples' entries, and the command line that calls them, wait for
ROADMAP queue A item 10."""


def build_standard(cfg, name, default_loader_factory, loss_function,
                   **overrides):
    """Shared config merge of the StandardWorkflow samples: defaults from
    the sample's config namespace, overridden per call (``decision``
    and ``loader`` dicts merge key by key).  The topology is ``layers``
    or the ``mcdnnic_topology`` string (with ``mcdnnic_parameters``),
    whichever the overrides, then the config, give; a ``snapshotter``
    of the config namespace applies unless the call gives one."""
    from ..standard_workflow import StandardWorkflow
    from ...config import Config

    def _cfg_dict(v):
        # config files may ASSIGN a plain dict (root.x.decision =
        # {...}) instead of update()-ing into the tree — accept both
        return v.todict() if isinstance(v, Config) else dict(v)

    decision = _cfg_dict(cfg.decision)
    decision.update(overrides.pop("decision", {}))
    loader = _cfg_dict(cfg.loader)
    loader.update(overrides.pop("loader", {}))
    topology = {}
    mcdnnic = overrides.pop("mcdnnic_topology",
                            cfg.get("mcdnnic_topology"))
    if "layers" in overrides:
        topology["layers"] = overrides.pop("layers")
        overrides.pop("mcdnnic_parameters", None)
    elif mcdnnic:
        params = overrides.pop("mcdnnic_parameters",
                               cfg.get("mcdnnic_parameters"))
        if params is not None:
            params = _cfg_dict(params)
        topology = {"mcdnnic_topology": mcdnnic,
                    "mcdnnic_parameters": params}
    else:
        topology["layers"] = cfg.layers
    if "snapshotter" in cfg and "snapshotter" not in overrides:
        overrides["snapshotter"] = _cfg_dict(cfg.snapshotter)
    return StandardWorkflow(
        None, name=name,
        loader_factory=overrides.pop("loader_factory",
                                     default_loader_factory),
        loader=loader, loss_function=loss_function,
        decision=decision, **topology, **overrides)


# the samples whose loaders the JAX package registers by MAPPING
from . import kanji, lines, mnist_ae  # noqa: E402,F401
