"""The learning-rate adjuster, the port against the JAX package, on the
CPU.

- ``make_policy`` equals the JAX function at every policy (several
  parameter sets each) for epochs 0-40, exactly; an unknown name raises
  ``ValueError`` in both, and ``LearningRateAdjuster`` raises it at
  construction.
- Fault C16: the fused step's effective rate, the ``lr`` its solver is
  given, equals the JAX step's f32 product ``f32(lr) * f32(lr_scale)``
  bit for bit for the rates 0.01, 0.03, 0.05, 0.003 and 0.02 along a
  gamma-0.9 ``exp`` schedule, epochs 1-39 (the parent multiplied two
  Python floats and differed in 69 of these 195).
- tests/test_znicz_extra.py's ``test_lr_adjuster_drives_fused_scale``
  on the port.
- The adjuster on MNIST (300 + 100 digits, 4 epochs, gamma 0.9), fused
  and in graph mode (``link_gds``), against the JAX workflow: each
  epoch's ``lr_scale`` (fused) or GD rates (graph mode) equal, n_err
  equal, every parameter tensor within ``JAX_WEIGHT_RTOL`` of its
  largest magnitude.
- A fused workflow with an adjuster, snapshotted after 2 epochs,
  restored and run to 5, equals the uninterrupted 5-epoch run bit for
  bit (the restored adjuster rebuilds its policy and its epoch gate).
"""

import numpy
import pytest

from _control_shared import (JAX_WEIGHT_RTOL, bitwise, host_params,
                             mnist_control, scaled_diff)

POLICIES = [
    ("exp", {"gamma": 0.9}), ("exp", {"gamma": 0.5}), ("exp", {}),
    ("step", {"gamma": 0.1, "step": 10}), ("step", {"gamma": 0.7,
                                                    "step": 3}),
    ("inv", {"gamma": 1.0, "power": 1.0}), ("inv", {"gamma": 0.01}),
    ("arbitrary", {"points": [(0, 1.0), (2, 0.5), (5, 0.1)]}),
    ("arbitrary", {"points": [(7, 0.3), (1, 0.9)]}),
]
RATES = (0.01, 0.03, 0.05, 0.003, 0.02)


@pytest.mark.parametrize("name,kwargs", POLICIES)
def test_make_policy_equals_jax(name, kwargs):
    from veles_tpu.znicz.lr_adjust import make_policy as jax_policy
    from veles_tpu_torch.znicz.lr_adjust import make_policy
    port, ref = make_policy(name, **kwargs), jax_policy(name, **kwargs)
    for epoch in range(41):
        assert port(epoch) == ref(epoch), (name, kwargs, epoch)


def test_unknown_policy_raises_at_construction():
    from veles_tpu.znicz.lr_adjust import make_policy as jax_policy
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.lr_adjust import (LearningRateAdjuster,
                                                 make_policy)
    for fn in (make_policy, jax_policy):
        with pytest.raises(ValueError, match="unknown lr policy"):
            fn("cosine")
    with pytest.raises(ValueError, match="unknown lr policy"):
        LearningRateAdjuster(Workflow(name="w"), policy="cosine")
    with pytest.raises(KeyError):
        LearningRateAdjuster(Workflow(name="w"), policy="arbitrary")


def _jax_products(lr, scales):
    """The JAX step's rate: ``lr`` (a Python float, as ``gd.lr_for``
    gives it) times the scale passed to the jitted step as a float."""
    import jax
    product = jax.jit(lambda s: lr * s)
    return [numpy.float32(product(float(s))) for s in scales]


def test_fused_rate_is_the_jax_f32_product():
    """Fault C16: one layer a rate, an ``exp`` gamma-0.9 adjuster, one
    train step an epoch for 40 epochs; each step's rates, as the solver
    receives them, are the JAX f32 products bit for bit."""
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
               "<-": {"learning_rate": lr, "gradient_moment": 0.9}}
              for lr in RATES[:-1]]
    layers.append({"type": "softmax", "->": {"output_sample_shape": 10},
                   "<-": {"learning_rate": RATES[-1],
                          "gradient_moment": 0.9}})
    wf, units, _ = mnist_control(
        "veles_tpu_torch", 40, adjuster={"policy": "exp", "gamma": 0.9},
        loader={"n_train": 60, "n_valid": 60}, layers=layers)
    seen = {lr: [] for lr in RATES}
    for gd in wf.gds:
        update = gd.solver.update
        base = gd.learning_rate

        def recording(g, p, state, lr, update=update, base=base):
            seen[base].append(lr)
            return update(g, p, state, lr)
        gd.solver.update = recording
    wf.run()
    scales = [units["adjuster"].scale_for(e) for e in range(1, 40)]
    assert scales[0] == 0.9 and len(scales) == 39
    mismatched = 0
    for lr in RATES:
        got = seen[lr]
        assert len(got) == 2 * 40     # weights and bias, 40 steps
        want = _jax_products(lr, [1.0] + scales)
        for e, w in enumerate(want):
            for rate in got[2 * e:2 * e + 2]:
                # exactly an f32 value, and the JAX one
                assert float(numpy.float32(rate)) == rate, (lr, e)
                assert numpy.float32(rate).tobytes() == w.tobytes(), \
                    (lr, e, rate, w)
            if e and numpy.float32(lr * scales[e - 1]) != w:
                mismatched += 1
    # the double product, rounded once, differs from the f32 one here
    assert mismatched == 69


def test_lr_adjuster_drives_fused_scale():
    """tests/test_znicz_extra.py::test_lr_adjuster_drives_fused_scale:
    the last adjustment runs at the end of epoch 1 (the end-of-epoch-2
    run is skipped: training is over), scale_for(2) = 0.25."""
    wf, _, _ = mnist_control(
        "veles_tpu_torch", 3, adjuster={"policy": "exp", "gamma": 0.5},
        loader={"minibatch_size": 100})
    wf.run()
    assert abs(wf.fused_step.lr_scale - 0.5 ** 2) < 1e-12


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
def test_adjuster_matches_jax(fused):
    adjuster = {"policy": "exp", "gamma": 0.9}
    jwf, _, jrec = mnist_control("veles_tpu", 4, adjuster=adjuster,
                                 fused=fused)
    twf, _, trec = mnist_control("veles_tpu_torch", 4, adjuster=adjuster,
                                 fused=fused)
    assert bitwise(host_params(twf), host_params(jwf))
    jwf.run()
    twf.run()
    assert len(trec) == 4
    assert trec == jrec
    if fused:
        assert [e["lr_scale"] for e in trec] == [1.0, 0.9, 0.9 ** 2,
                                                 0.9 ** 3]
    else:
        assert trec[3]["rates"] == [(0.03 * 0.9 ** 3, 0.03 * 0.9 ** 3)] * 2
    assert scaled_diff(host_params(twf), host_params(jwf)) <= \
        JAX_WEIGHT_RTOL


def test_adjuster_snapshot_resumes_bit_for_bit(tmp_path):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.snapshotter import restore
    adjuster = {"policy": "exp", "gamma": 0.9}
    # the uninterrupted run snapshots too: the snapshotter comes before
    # the adjuster after the decision, so both run at the last epoch's
    # end
    ref, _, _ = mnist_control("veles_tpu_torch", 5, adjuster=adjuster,
                              snapshotter={"prefix": "ref",
                                           "directory": str(tmp_path),
                                           "time_interval": 0})
    ref.run()
    ref.snapshotter.stop()
    snap = {"prefix": "adj", "directory": str(tmp_path),
            "time_interval": 0}
    first, _, _ = mnist_control("veles_tpu_torch", 2, adjuster=adjuster,
                                snapshotter=snap)
    first.run()
    first.snapshotter.stop()
    back = restore(str(tmp_path / "adj_current"))
    adj = [u for u in back.units
           if type(u).__name__ == "LearningRateAdjuster"]
    assert len(adj) == 1 and adj[0].scale_for(3) == 0.9 ** 3
    back.decision.max_epochs = 5
    back.initialize(device=Device(backend="cpu"))
    back.run()
    assert back.decision.epoch_n_err == ref.decision.epoch_n_err
    assert back.fused_step.lr_scale == ref.fused_step.lr_scale == \
        0.9 ** 5
    assert bitwise(host_params(back), host_params(ref))
