"""What the tests of the training-control units share: the MNIST sample
at a cut size in either package, with a ``LearningRateAdjuster`` and a
``WeightsRollback`` linked after the decision in either order, and a
record of each epoch.

``SCHEDULE`` is the ``arbitrary`` policy of the rollback runs: 0.9 from
epoch 1, 2.0 at epoch 2 (a rate that makes the next validation worse,
so the rollback restores), 0.7 from epoch 3 and 0.5 from epoch 5.
"""

import importlib

import numpy

import _torch_workers  # noqa: F401  (one torch thread share a worker)

SCHEDULE = [(1, 0.9), (2, 2.0), (3, 0.7), (5, 0.5)]
#: the MNIST tests' cross-package tolerance (tests/test_torch_mnist.py),
#: of each parameter tensor's largest magnitude
JAX_WEIGHT_RTOL = 2e-6
SMALL = {"minibatch_size": 60, "n_train": 300, "n_valid": 100}


def mnist_control(pkg, epochs, adjuster=None, rollback=None,
                  order=("adjuster", "rollback"), fused=True, loader=None,
                  **wf_kwargs):
    """The MNIST sample of ``pkg`` (weights seed 42, loader seed 3) with
    an adjuster of ``adjuster`` (its kwargs: ``policy``, ``gamma``,
    ``points``) and a rollback of ``rollback`` (its kwargs), each None
    for none, linked from the decision in ``order``; initialized on the
    CPU.  -> (workflow, {"adjuster": unit, "rollback": unit}, record):
    the record holds, for each epoch, the class n_err, the ``lr_scale``
    the epoch trained at (fused) or the GD units' rates (graph mode),
    and the rollbacks so far."""
    backends = importlib.import_module(pkg + ".backends")
    prng = importlib.import_module(pkg + ".prng")
    mnist = importlib.import_module(pkg + ".znicz.samples.mnist")
    lr_adjust = importlib.import_module(pkg + ".znicz.lr_adjust")
    rollback_mod = importlib.import_module(pkg + ".znicz.rollback")
    prng.get().seed(42)
    ld = dict(SMALL, **(loader or {}))
    ld["prng"] = prng.RandomGenerator().seed(3)
    if pkg == "veles_tpu":
        ld["prefetch_depth"] = 0
    gd = {"learning_rate": 0.03, "weights_decay": 0.0,
          "gradient_moment": 0.9}
    layers = wf_kwargs.pop("layers", [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
         "<-": gd},
        {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": gd}])
    wf = mnist.create_workflow(
        fused=fused, loader=ld,
        decision={"max_epochs": epochs, "silent": True}, layers=layers,
        **wf_kwargs)
    units = {}
    for name in order:
        if name == "adjuster" and adjuster is not None:
            adj = lr_adjust.LearningRateAdjuster(wf, **adjuster)
            adj.link_from(wf.decision)
            adj.link_loader(wf.loader)
            if fused:
                adj.link_fused(wf.fused_step)
            else:
                adj.link_gds(*wf.gds)
            units["adjuster"] = adj
        elif name == "rollback" and rollback is not None:
            rb = rollback_mod.WeightsRollback(wf, **rollback)
            rb.link_from(wf.decision)
            rb.link_all(wf.fused_step, wf.decision, wf.loader)
            units["rollback"] = rb
    wf.initialize(device=backends.Device(backend="cpu"))
    return wf, units, record_epochs(wf, units)


def record_epochs(wf, units):
    """Wrap the decision of ``wf`` to record each epoch (see
    :func:`mnist_control`)."""
    rec = []
    decision = wf.decision
    run = decision.run

    def recording():
        ended = bool(decision.last_minibatch) and \
            bool(decision.epoch_ended)
        run()
        if not ended:
            return
        entry = {"n_err": list(decision.epoch_n_err),
                 "rollbacks": units["rollback"].rollbacks
                 if "rollback" in units else 0}
        if wf.fused_step is not None:
            entry["lr_scale"] = float(wf.fused_step.lr_scale)
        else:
            entry["rates"] = [(g.learning_rate, g.learning_rate_bias)
                              for g in wf.gds]
        rec.append(entry)
    recording.transient_ = True     # a snapshot skips it
    decision.run = recording
    return rec


def host_params(wf):
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def scaled_diff(a, b):
    """Largest |a - b| of any parameter tensor over its largest
    magnitude in ``b``."""
    return max(float(numpy.abs(x[k] - y[k]).max() / numpy.abs(y[k]).max())
               for x, y in zip(a, b) for k in y)


def bitwise(a, b):
    return all(x[k].tobytes() == y[k].tobytes()
               for x, y in zip(a, b, strict=True) for k in y)
