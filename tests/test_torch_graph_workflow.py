"""Graph mode's StandardWorkflow of the port against the JAX package's.

Mirrors tests/test_standard_workflow.py (``test_graph_converges``,
``test_fused_equals_graph``, ``test_fused_equals_graph_partial_
minibatches``, ``test_mse_fused_equals_graph``,
``test_mse_fused_metrics_side_channels``, ``test_fused_confusion_
matrix_matches_graph``) and tests/test_znicz_core.py
``test_graph_mode_training_converges``, on the CPU, on the JAX test's
data (gaussian blobs; a tanh regression for MSE) from the same seeds in
both packages:

- the port's graph mode against the JAX graph mode: the trained weights
  within ``1e-5`` (the two differ in f32 summation order only; the
  initial weights are byte-equal), each epoch's ``n_err`` of every
  class equal, the confusion matrices equal, ``max_err_output_sum``
  within ``1e-5``; for MSE each epoch's rmse within ``1e-5`` relative;
- the port's graph mode against its fused mode: the JAX tests' own
  ``2e-4`` on the weights (validation error within 1 point, rmse within
  ``1e-3``), the confusion matrices equal;
- the MNIST sample (600 train / 200 valid digits) in graph mode against
  the JAX graph mode, 2 epochs: n_err of every class equal, weights
  within ``1e-5``;
- a convnet with LRN and dropout (conv 5x5 → LRN → max pooling → fc →
  dropout 0.5 → softmax) on small synthetic images, both LRN forms: the
  dropout keys each train step draws and so the masks bit-equal to the
  JAX graph mode's, weights within ``1e-5``, n_err equal;
- tests/test_znicz_core.py's hand-wired graph (units linked one by one,
  no StandardWorkflow): under its gate (< 10 %), the best error and
  each epoch's n_err equal to the JAX run's, weights within ``1e-5``.
"""

import importlib

import numpy
import pytest

import jax

WEIGHT_ATOL = 1e-5
MODE_ATOL = 2e-4          # the JAX tests' fused-vs-graph tolerance

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 20},
     "<-": {"learning_rate": 0.2, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.2, "gradient_moment": 0.9}},
]
MSE_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "all2all", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
]


def _mods(pkg):
    return {n: importlib.import_module("%s.%s" % (pkg, n))
            for n in ("backends", "loader", "prng", "znicz.standard_workflow",
                      "prng.random_generator")}


def _blob_loader(pkg):
    loader = _mods(pkg)["loader"]

    class BlobLoader(loader.FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(4)
            centers = rng.uniform(-2, 2, (4, 8))
            data, labels = [], []
            for c in range(4):
                data.append(centers[c] +
                            0.35 * rng.standard_normal((50, 8)))
                labels += [c] * 50
            data = numpy.concatenate(data).astype(numpy.float32)
            order = rng.permutation(len(data))
            self.original_data.mem = data[order]
            self.original_labels = list(numpy.array(labels)[order])
            self.class_lengths[loader.TEST] = 0
            self.class_lengths[loader.VALID] = 50
            self.class_lengths[loader.TRAIN] = 150
    return BlobLoader


def _regression_loader(pkg):
    loader = _mods(pkg)["loader"]

    class RegressionLoader(loader.FullBatchLoaderMSE):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(11)
            x = rng.uniform(-1, 1, (200, 6)).astype(numpy.float32)
            w = rng.standard_normal((6, 3)).astype(numpy.float32)
            t = numpy.tanh(x @ w) + 0.05 * rng.standard_normal(
                (200, 3)).astype(numpy.float32)
            self.original_data.mem = x
            self.original_targets.mem = t.astype(numpy.float32)
            self.class_lengths[loader.TEST] = 0
            self.class_lengths[loader.VALID] = 50
            self.class_lengths[loader.TRAIN] = 150
    return RegressionLoader


def build(pkg, fused, max_epochs=3, seed=77, minibatch=25, mse=False):
    """tests/test_standard_workflow.py's ``build`` / ``build_mse`` for
    ``pkg``, recording each epoch's per-class n_err (rmse for MSE)."""
    m = _mods(pkg)
    m["prng.random_generator"]._generators.clear()
    m["prng.random_generator"].get(0).seed(seed)
    wf = m["znicz.standard_workflow"].StandardWorkflow(
        None, name="std_mse" if mse else "std",
        loader_factory=(_regression_loader if mse else _blob_loader)(pkg),
        loader={"minibatch_size": minibatch,
                "prng": m["prng"].RandomGenerator().seed(5)},
        layers=MSE_LAYERS if mse else LAYERS,
        loss_function="mse" if mse else "softmax",
        decision={"max_epochs": max_epochs, "silent": True}, fused=fused)
    wf.initialize(device=m["backends"].Device(backend="cpu"))
    _record_epochs(wf, mse)
    return wf


def _record_epochs(wf, mse=False):
    wf.epochs_ = []
    decision = wf.decision
    run = decision.run

    def recording():
        last = bool(decision.last_minibatch)
        run()
        if last:
            cls = decision.minibatch_class
            wf.epochs_.append((decision.epoch_number, cls,
                               decision.epoch_rmse[cls] if mse else
                               decision.epoch_n_err[cls]))
    decision.run = recording


def _weights(wf):
    return [(numpy.array(f.weights.map_read()),
             numpy.array(f.bias.map_read())) for f in wf.forwards]


def _same_weights(a, b, atol):
    for (wa, ba), (wb, bb) in zip(_weights(a), _weights(b)):
        numpy.testing.assert_allclose(wa, wb, rtol=0, atol=atol)
        numpy.testing.assert_allclose(ba, bb, rtol=0, atol=atol)


def test_graph_converges():
    wf = build("veles_tpu_torch", fused=False, max_epochs=8)
    assert wf.evaluator is not None and wf.fused_step is None
    wf.run()
    assert wf.is_finished
    assert wf.decision.best_n_err_pt < 10.0, wf.decision.best_n_err_pt


@pytest.mark.parametrize("minibatch", [25, 40])
def test_graph_equals_jax_graph(minibatch):
    """25 divides every class, 40 leaves short minibatches (10 valid,
    30 train rows): the gradients divide by the valid rows."""
    jwf = build("veles_tpu", fused=False, minibatch=minibatch)
    twf = build("veles_tpu_torch", fused=False, minibatch=minibatch)
    _same_weights(twf, jwf, 0)              # byte-equal initial weights
    jwf.run()
    twf.run()
    assert twf.epochs_ == jwf.epochs_
    _same_weights(twf, jwf, WEIGHT_ATOL)
    assert numpy.array_equal(twf.evaluator.confusion_matrix.map_read(),
                             jwf.evaluator.confusion_matrix.map_read())
    assert float(twf.evaluator.max_err_output_sum[0]) == pytest.approx(
        float(jwf.evaluator.max_err_output_sum[0]), abs=WEIGHT_ATOL)
    assert twf.decision.best_n_err_pt == jwf.decision.best_n_err_pt


@pytest.mark.parametrize("minibatch", [25, 40])
def test_fused_equals_graph(minibatch):
    """tests/test_standard_workflow.py's two fused-vs-graph tests (the
    second with short minibatches) on the port."""
    wf_f = build("veles_tpu_torch", fused=True, minibatch=minibatch)
    wf_g = build("veles_tpu_torch", fused=False, minibatch=minibatch)
    wf_f.run()
    wf_g.run()
    _same_weights(wf_f, wf_g, MODE_ATOL)
    assert wf_f.decision.epoch_n_err_pt[1] == pytest.approx(
        wf_g.decision.epoch_n_err_pt[1], abs=1.0)


def test_fused_confusion_matrix_matches_graph():
    wf_f = build("veles_tpu_torch", fused=True, max_epochs=2)
    wf_g = build("veles_tpu_torch", fused=False, max_epochs=2)
    wf_f.run()
    wf_g.run()
    cm_f = numpy.asarray(wf_f.fused_step.confusion_matrix.map_read())
    cm_g = numpy.asarray(wf_g.evaluator.confusion_matrix.map_read())
    assert cm_f.shape == cm_g.shape == (4, 4)
    assert cm_f.sum() == cm_g.sum() > 0
    assert numpy.array_equal(cm_f, cm_g)
    assert float(wf_f.fused_step.max_err_output_sum[0]) == pytest.approx(
        float(wf_g.evaluator.max_err_output_sum[0]), abs=1e-4)


def test_mse_graph_equals_jax_graph():
    jwf = build("veles_tpu", fused=False, minibatch=40, seed=13, mse=True)
    twf = build("veles_tpu_torch", fused=False, minibatch=40, seed=13,
                mse=True)
    jwf.run()
    twf.run()
    _same_weights(twf, jwf, WEIGHT_ATOL)
    assert [e[:2] for e in twf.epochs_] == [e[:2] for e in jwf.epochs_]
    for (_, _, t), (_, _, j) in zip(twf.epochs_, jwf.epochs_):
        assert t == pytest.approx(j, rel=1e-5)
    assert twf.decision.best_rmse == pytest.approx(jwf.decision.best_rmse,
                                                   rel=1e-5)
    tm = twf.evaluator.get_metric_values()
    jm = jwf.evaluator.get_metric_values()
    for k in ("mse_sum", "max_mse"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5), k


def test_mse_fused_equals_graph():
    wf_f = build("veles_tpu_torch", fused=True, minibatch=40, seed=13,
                 mse=True)
    wf_g = build("veles_tpu_torch", fused=False, minibatch=40, seed=13,
                 mse=True)
    wf_f.run()
    wf_g.run()
    _same_weights(wf_f, wf_g, MODE_ATOL)
    assert wf_f.decision.best_rmse == pytest.approx(
        wf_g.decision.best_rmse, abs=1e-3)


def test_mse_fused_metrics_side_channels():
    """The fused MSE step fills metrics[1]/[2] (max / min sample rmse)
    as the graph evaluator does, not only the sum."""
    wf = build("veles_tpu_torch", fused=True, max_epochs=2, minibatch=40,
               seed=13, mse=True)
    step = wf.fused_step
    seen = {"mx": 0.0, "mn": numpy.inf}
    orig = step._flush_metrics

    def spy():
        orig()
        seen["mx"] = max(seen["mx"], float(step.metrics[1]))
        seen["mn"] = min(seen["mn"], float(step.metrics[2]))
    step._flush_metrics = spy
    wf.run()
    assert 0.0 < seen["mx"] < numpy.inf
    assert 0.0 < seen["mn"] <= seen["mx"]


MNIST_LOADER = {"minibatch_size": 60, "n_train": 600, "n_valid": 200,
                "normalization_type": "range_linear"}
MNIST_GD = {"learning_rate": 0.03, "weights_decay": 0.0,
            "gradient_moment": 0.9}
MNIST_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
     "<-": MNIST_GD},
    {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": MNIST_GD}]


def test_mnist_graph_equals_jax_graph():
    runs = []
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        m = _mods(pkg)
        mnist = importlib.import_module(pkg + ".znicz.samples.mnist")
        m["prng"].get().seed(42)
        loader = dict(MNIST_LOADER, prng=m["prng"].RandomGenerator().seed(3))
        if pkg == "veles_tpu":
            loader["prefetch_depth"] = 0
        wf = mnist.create_workflow(
            fused=False, loader=loader, layers=MNIST_LAYERS,
            decision={"max_epochs": 2, "silent": True})
        wf.initialize(device=m["backends"].Device(backend="cpu"))
        _record_epochs(wf)
        wf.run()
        runs.append(wf)
    jwf, twf = runs
    assert twf.epochs_ == jwf.epochs_
    _same_weights(twf, jwf, WEIGHT_ATOL)


def _image_loader(pkg):
    loader = _mods(pkg)["loader"]

    class Images(loader.FullBatchLoader):
        """Four classes of 8x8x3 images: a bright quadrant each."""

        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(6)
            labels = rng.randint(0, 4, 100)
            x = rng.uniform(-0.5, 0.5, (100, 8, 8, 3)).astype(numpy.float32)
            for i, c in enumerate(labels):
                r, q = divmod(int(c), 2)
                x[i, 4 * r:4 * r + 4, 4 * q:4 * q + 4] += 1.0
            self.original_data.mem = x
            self.original_labels = list(labels)
            self.class_lengths[loader.TEST] = 0
            self.class_lengths[loader.VALID] = 30
            self.class_lengths[loader.TRAIN] = 70
    return Images


def _convnet(pkg, use_pallas):
    m = _mods(pkg)
    m["prng.random_generator"]._generators.clear()
    m["prng.random_generator"].get(0).seed(21)
    gd = {"learning_rate": 0.05, "gradient_moment": 0.9}
    wf = m["znicz.standard_workflow"].StandardWorkflow(
        None, name="convnet", loader_factory=_image_loader(pkg),
        loader={"minibatch_size": 20,
                "prng": m["prng"].RandomGenerator().seed(8)},
        layers=[
            {"type": "conv_str", "->": {"n_kernels": 6, "kx": 5, "ky": 5,
                                        "padding": 2}, "<-": gd},
            {"type": "norm", "->": {"use_pallas": use_pallas}},
            {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
            {"type": "all2all_str", "->": {"output_sample_shape": 16},
             "<-": gd},
            {"type": "dropout", "->": {"dropout_ratio": 0.5}},
            {"type": "softmax", "->": {"output_sample_shape": 4}, "<-": gd},
        ],
        decision={"max_epochs": 2, "silent": True}, fused=False)
    wf.initialize(device=m["backends"].Device(backend="cpu"))
    _record_epochs(wf)
    drop = wf.forwards[4]
    wf.keys_ = []
    run = drop.run

    def recording():
        run()
        if drop.last_key is not None and drop._graph_training():
            wf.keys_.append(drop.last_key)
    drop.run = recording
    return wf


@pytest.mark.parametrize("use_pallas", [None, True])
def test_dropout_lrn_convnet_equals_jax_graph(use_pallas):
    jwf = _convnet("veles_tpu", use_pallas)
    twf = _convnet("veles_tpu_torch", use_pallas)
    jwf.run()
    twf.run()
    jkeys = [tuple(numpy.asarray(jax.random.key_data(k)).tolist())
             for k in jwf.keys_]
    assert len(jkeys) == 2 * 4          # 4 train minibatches an epoch
    assert twf.keys_ == jkeys
    shape = tuple(twf.forwards[4].output.shape)
    for tk, jk in zip(twf.keys_, jwf.keys_):
        assert numpy.array_equal(
            twf.forwards[4].mask(tk, shape, "cpu").numpy(),
            numpy.asarray(jax.random.bernoulli(jk, 0.5, shape)))
    assert twf.epochs_ == jwf.epochs_
    for tf, jf in zip(twf.forwards, jwf.forwards):
        for k, v in jf.host_params.items():
            numpy.testing.assert_allclose(tf.host_params[k], v, rtol=0,
                                          atol=WEIGHT_ATOL, err_msg=k)


def _hand_built_graph(pkg):
    """tests/test_znicz_core.py's ``test_graph_mode_training_converges``
    graph, wired unit by unit (no StandardWorkflow) in ``pkg``."""
    m = {n: importlib.import_module("%s.%s" % (pkg, n))
         for n in ("backends", "loader", "prng", "workflow", "plumbing",
                   "znicz.all2all", "znicz.evaluator", "znicz.decision",
                   "znicz.gd")}
    loader_mod = m["loader"]

    class BlobLoader(loader_mod.FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(4)
            n_per, n_classes, dim = 40, 3, 6
            centers = rng.uniform(-2, 2, (n_classes, dim))
            data, labels = [], []
            for c in range(n_classes):
                data.append(centers[c] +
                            0.3 * rng.standard_normal((n_per, dim)))
                labels += [c] * n_per
            data = numpy.concatenate(data).astype(numpy.float32)
            order = rng.permutation(len(data))
            self.original_data.mem = data[order]
            self.original_labels = list(numpy.array(labels)[order])
            self.class_lengths[loader_mod.TEST] = 0
            self.class_lengths[loader_mod.VALID] = 30
            self.class_lengths[loader_mod.TRAIN] = 90

    RG = m["prng"].RandomGenerator
    a2a, ev_mod, gd_mod = (m["znicz.all2all"], m["znicz.evaluator"],
                           m["znicz.gd"])
    wf = m["workflow"].Workflow(name="train")
    repeater = m["plumbing"].Repeater(wf)
    loader = BlobLoader(wf, minibatch_size=30, prng=RG().seed(10))
    hidden = a2a.All2AllTanh(wf, output_sample_shape=16, prng=RG().seed(20))
    out = a2a.All2AllSoftmax(wf, output_sample_shape=3, prng=RG().seed(21))
    ev = ev_mod.EvaluatorSoftmax(wf)
    decision = m["znicz.decision"].DecisionGD(wf, max_epochs=15,
                                              silent=True)
    gd_out = gd_mod.GDSoftmax(wf, learning_rate=0.5)
    gd_hidden = gd_mod.GDTanh(wf, learning_rate=0.5)
    repeater.link_from(wf.start_point)
    loader.link_from(repeater)
    hidden.link_from(loader)
    hidden.link_attrs(loader, ("input", "minibatch_data"))
    out.link_from(hidden)
    out.link_attrs(hidden, ("input", "output"))
    ev.link_from(out)
    ev.link_attrs(out, "output", "max_idx")
    ev.link_attrs(loader, ("labels", "minibatch_labels"),
                  ("batch_size", "minibatch_size"))
    decision.link_from(ev)
    decision.link_loader(loader)
    decision.link_evaluator(ev)
    gd_out.link_from(decision)
    gd_out.link_forward(out)
    gd_out.link_attrs(ev, "err_output")
    gd_hidden.link_from(gd_out)
    gd_hidden.link_forward(hidden)
    gd_hidden.link_attrs(gd_out, ("err_output", "err_input"))
    for gd in (gd_out, gd_hidden):
        gd.gate_skip = wf.make_train_gate(loader)
    repeater.link_from(gd_hidden)
    wf.end_point.link_from(gd_hidden)
    wf.end_point.gate_block = ~decision.complete
    repeater.gate_block = decision.complete
    wf.initialize(device=m["backends"].Device(backend="cpu"))
    wf.run()
    return wf, decision, (hidden, out)


def test_hand_built_graph_converges_as_the_jax_one():
    """The JAX test's hand-wired graph (no StandardWorkflow): the gate
    (< 10 %) and, against the JAX run, the best error and each epoch's
    n_err equal, the weights within ``WEIGHT_ATOL``."""
    (jwf, jdec, jfwds), (twf, tdec, tfwds) = (
        _hand_built_graph(pkg) for pkg in ("veles_tpu", "veles_tpu_torch"))
    assert twf.is_finished
    assert tdec.best_n_err_pt < 10.0, tdec.best_n_err_pt
    assert tdec.best_n_err_pt == jdec.best_n_err_pt
    assert tdec.epoch_n_err == jdec.epoch_n_err
    for tf, jf in zip(tfwds, jfwds):
        for k, v in jf.host_params.items():
            numpy.testing.assert_allclose(tf.host_params[k], v, rtol=0,
                                          atol=WEIGHT_ATOL, err_msg=k)
