"""AlexNet and the convnets of the port against the JAX package, on the CPU.

- *AlexNet* at the JAX test's own size (tests/test_conv_stack.py:197-214:
  full widths, side 67, minibatch 4, 20 classes, 8 train + 4 valid
  images, loader seed 7), weights from ``prng.get().seed(42)`` in both:
  the initial weights are byte-equal; over the first two fused train
  steps, dropout on, the minibatches are equal, each step's seed counter
  and dropout keys are the JAX step's (so the masks are its bits), each
  loss within ``STEP_LOSS_RTOL`` = 1e-4 relative and each parameter
  tensor within ``STEP_WEIGHT_RTOL`` = 1e-4 of its largest magnitude
  (chip_smoke's card-vs-CPU limits); the updates themselves within 1e-2
  of the largest update plus 4 ulps of the weights (measured: AlexNet's
  equal to the last ulp, ~1e-9; the LRN convnet's band form 1.6e-3 of
  its largest update, where a max pooling or RELU decision at a near-tie
  goes the other way under another summation order).
- *The small convnet*: tests/test_conv_stack.py:173-194's CIFAR run
  (conv 8 → max 2x2 → fc 32 → softmax, 300 train + 100 valid, 8
  epochs) in both packages: the first epoch's n_err of each class
  within 1, and both under the JAX test's 25 % gate.
- *The LRN convnet* of chip_smoke phase 4d on 200 train + 100 valid
  images, with ``use_pallas=True`` (the kernel pair's Function on its
  plain versions) and unset (the band form on the CPU), against the
  JAX package's default: the first two train steps, dropout on, at
  the same limits as AlexNet's.
- ``convert.workflow_params_from_jax`` carries the LRN convnet's layers
  (HWIO conv kernels, the empty params of paramless layers) and refuses
  an OIHW kernel and params given to a paramless layer.
"""

import os
import sys

import numpy
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ALEX_LOADER = {"minibatch_size": 4, "n_train": 8, "n_valid": 4,
               "n_classes": 20, "side": 67}
UPDATE_RTOL = 1e-2


def _jax_workflow(sample, layers=None, **loader):
    import importlib
    from veles_tpu import prng
    from veles_tpu.backends import Device
    from veles_tpu.prng import RandomGenerator
    mod = importlib.import_module("veles_tpu.znicz.samples." + sample)
    prng.get().seed(42)
    kw = {"layers": [dict(layer) for layer in layers]} if layers else {}
    wf = mod.create_workflow(
        loader=dict(loader, prng=RandomGenerator().seed(7),
                    prefetch_depth=0),
        decision={"max_epochs": 1, "silent": True}, **kw)
    wf.initialize(device=Device(backend="cpu"))
    return wf


def _jax_steps(wf, n):
    """The JAX twin of ``chip_smoke.train_steps``: -> (losses, indices,
    seed counters)."""
    from veles_tpu.loader import TRAIN
    losses, order, seeds = [], [], []
    for _ in range(n):
        while True:
            wf.loader.run()
            if wf.loader.minibatch_class == TRAIN:
                break
        order.append(wf.loader._padded_indices_.tolist())
        wf.fused_step.run()
        seeds.append(wf.fused_step._seed_counter)
        losses.append(float(wf.fused_step.loss))
    wf.fused_step.sync_weights()
    return losses, order, seeds


def _port_steps(wf, n):
    """``chip_smoke.train_steps`` recording the minibatch indices, the
    seed counters and each dropout layer's key."""
    step = wf.fused_step
    run = step.run
    rec = {"order": [], "seeds": [], "keys": []}

    def recording():
        rec["order"].append(wf.loader._padded_indices_.tolist())
        run()
        rec["seeds"].append(step._seed_counter)
        rec["keys"].append([f.last_key for f in wf.forwards
                            if f.stochastic])

    step.run = recording
    losses = chip_smoke.train_steps(wf, n)
    step.run = run
    return losses, rec


def _jax_dropout_keys(jwf, seed):
    """The keys the JAX fused step gave its stochastic layers for
    ``seed``: ``fold_in(key(seed), layer index)``."""
    key = jax.random.key(seed)
    return [tuple(numpy.asarray(jax.random.key_data(
        jax.random.fold_in(key, i))).tolist())
        for i, f in enumerate(jwf.forwards) if f.stochastic]


def _hold(jwf, twf, n):
    """The first ``n`` train steps of both workflows agree."""
    w0 = chip_smoke.host_weights(twf)
    for f, jf in zip(twf.forwards, jwf.forwards):
        assert sorted(f.host_params) == sorted(jf.host_params), f
        for k, v in f.host_params.items():
            assert v.tobytes() == numpy.asarray(jf.host_params[k]).tobytes()
    j_losses, j_order, j_seeds = _jax_steps(jwf, n)
    t_losses, rec = _port_steps(twf, n)
    assert rec["order"] == j_order
    assert rec["seeds"] == j_seeds
    for seed, keys in zip(j_seeds, rec["keys"]):
        assert keys == _jax_dropout_keys(jwf, seed)
    j_weights = [{k: numpy.asarray(v) for k, v in f.host_params.items()}
                 for f in jwf.forwards]
    t_weights = chip_smoke.host_weights(twf)
    chip_smoke.steps_agree("port vs JAX", t_losses, t_weights, j_losses,
                           j_weights)
    for w, ref, init in zip(t_weights, j_weights, w0):
        for k in ref:
            update = ref[k] - init[k]
            ulp = numpy.spacing(numpy.abs(init[k]).max())
            limit = UPDATE_RTOL * numpy.abs(update).max() + 4 * ulp
            assert numpy.abs((w[k] - init[k]) - update).max() <= limit, k
    return t_losses


def test_alexnet_two_train_steps_match_jax():
    jwf = _jax_workflow("alexnet", **ALEX_LOADER)
    twf = chip_smoke.alexnet_workflow("cpu", epochs=1, **ALEX_LOADER)
    assert [type(f).__name__ for f in twf.forwards] == \
        [type(f).__name__ for f in jwf.forwards]
    assert [f.output.shape for f in twf.forwards] == \
        [tuple(f.output.shape) for f in jwf.forwards]
    norms = [f for f in twf.forwards if f.MAPPING == "norm"]
    assert [f._resolved_use_pallas() for f in norms] == [False, False]
    losses = _hold(jwf, twf, 2)
    assert all(numpy.isfinite(losses))


def _epoch_errors(wf):
    """Run ``wf``; -> its per-epoch n_err lists."""
    errs = []
    decision = wf.decision
    end = decision._on_epoch_end

    def on_epoch_end():
        errs.append(list(decision.epoch_n_err))
        end()

    decision._on_epoch_end = on_epoch_end
    wf.run()
    return errs


def test_small_convnet_matches_jax_and_trains():
    """tests/test_conv_stack.py:173-194 through both packages."""
    from veles_tpu import prng as jprng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.prng import RandomGenerator as JaxRandom
    from veles_tpu.znicz.samples import cifar as jcifar
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import cifar
    gd = {"learning_rate": 0.02, "gradient_moment": 0.9}
    layers = [
        {"type": "conv_str", "->": {"n_kernels": 8, "kx": 5, "ky": 5,
                                    "padding": 2}, "<-": gd},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_str", "->": {"output_sample_shape": 32},
         "<-": gd},
        {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": gd}]
    loader = {"minibatch_size": 50, "n_train": 300, "n_valid": 100,
              "normalization_type": "range_linear"}
    decision = {"max_epochs": 8, "silent": True}
    jprng.get().seed(42)
    jwf = jcifar.create_workflow(
        loader=dict(loader, prng=JaxRandom().seed(7), prefetch_depth=0),
        layers=layers, decision=decision)
    jwf.initialize(device=JaxDevice(backend="cpu"))
    prng.get().seed(42)
    twf = cifar.create_workflow(
        loader=dict(loader, prng=RandomGenerator().seed(7)),
        layers=layers, decision=decision)
    twf.initialize(device=Device(backend="cpu"))
    assert twf.loader.provenance == jwf.loader.provenance == "synthetic"
    assert twf.loader.original_data.map_read().tobytes() == \
        numpy.asarray(jwf.loader.original_data.map_read()).tobytes()
    j_errs, t_errs = _epoch_errors(jwf), _epoch_errors(twf)
    assert max(abs(a - b) for a, b in zip(t_errs[0], j_errs[0])) <= 1
    for wf in (jwf, twf):
        assert wf.is_finished
        assert wf.decision.best_n_err_pt < 25.0, wf.decision.best_n_err_pt


@pytest.mark.parametrize("use_pallas", [None, True])
def test_lrn_convnet_matches_jax(use_pallas):
    """The LRN convnet's first two train steps, dropout on, port
    against JAX, with each LRN form of the port."""
    twf = chip_smoke.lrn_net_workflow("cpu", use_pallas=use_pallas,
                                      epochs=1, n_train=200, n_valid=100)
    norms = [f for f in twf.forwards if f.MAPPING == "norm"]
    assert [f._resolved_use_pallas() for f in norms] == \
        [bool(use_pallas)] * 2
    jwf = _jax_workflow("cifar", layers=chip_smoke.LRN_NET_LAYERS,
                        **dict(chip_smoke.LRN_NET_LOADER, n_train=200,
                               n_valid=100))
    assert twf.loader.original_data.map_read().tobytes() == \
        numpy.asarray(jwf.loader.original_data.map_read()).tobytes()
    _hold(jwf, twf, 2)


def test_workflow_params_from_jax_carries_conv_layers():
    from veles_tpu_torch.convert import workflow_params_from_jax
    loader = dict(chip_smoke.LRN_NET_LOADER, n_train=50, n_valid=10,
                  minibatch_size=10)
    jwf = _jax_workflow("cifar", layers=chip_smoke.LRN_NET_LAYERS,
                        **loader)
    twf = chip_smoke.lrn_net_workflow("cpu", epochs=1, **loader)
    params = [{k: numpy.asarray(v) * 2.0 for k, v in f.host_params.items()}
              for f in jwf.forwards]
    assert [sorted(p) for p in params] == \
        [["bias", "weights"], [], [], ["bias", "weights"], [], [],
         ["bias", "weights"], [], ["bias", "weights"]]
    assert params[0]["weights"].shape == (5, 5, 3, 32)     # HWIO
    workflow_params_from_jax(twf, params)
    for f, want in zip(twf.forwards, params):
        for k, v in f.host_params.items():
            assert v.tobytes() == want[k].astype(numpy.float32).tobytes()
    conv = twf.fused_step._params_[0]["weights"].detach().numpy()
    assert conv.tobytes() == params[0]["weights"].astype(
        numpy.float32).tobytes()
    oihw = [dict(p) for p in params]
    oihw[3] = dict(oihw[3], weights=oihw[3]["weights"].transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="weights"):
        workflow_params_from_jax(twf, oihw)
    given = [dict(p) for p in params]
    given[1] = {"weights": numpy.ones((5, 5), numpy.float32)}
    with pytest.raises(ValueError, match="no parameters"):
        workflow_params_from_jax(twf, given)
    extra = [dict(p) for p in params]
    extra[0] = dict(extra[0], proj=numpy.ones(3, numpy.float32))
    with pytest.raises(ValueError, match="proj"):
        workflow_params_from_jax(twf, extra)
