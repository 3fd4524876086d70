"""Sample models of the port (the counterpart of
``veles_tpu.znicz.samples``): the flagship decode model (serving) and
the StandardWorkflow training samples MNIST, AlexNet, the CIFAR and
STL-10 convnets and the VideoAE conv autoencoder.  The JAX samples'
``run(load, main)`` entries wait for the command line (ROADMAP queue A
item 10)."""


def build_standard(cfg, name, default_loader_factory, loss_function,
                   **overrides):
    """Shared config merge of the StandardWorkflow samples: defaults from
    the sample's config namespace, overridden per call (``decision``
    and ``loader`` dicts merge key by key; ``layers`` replaces)."""
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
    layers = overrides.pop("layers", cfg.layers)
    return StandardWorkflow(
        None, name=name,
        loader_factory=overrides.pop("loader_factory",
                                     default_loader_factory),
        loader=loader, loss_function=loss_function,
        decision=decision, layers=layers, **overrides)
