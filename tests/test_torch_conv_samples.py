"""The STL-10 and VideoAE samples and the structural layers in
``StandardWorkflow``, the port against the JAX package, on the CPU.

- The samples' ``create_workflow`` in both modes against the JAX
  samples from the same seeds (weights seed 42, loader seed 3): STL-10
  on 100 train + 50 valid synthetic images for one epoch, VideoAE on
  100 + 50 synthetic frames for two.  The datasets are byte-equal, the
  initial weights byte-equal; after the run every parameter tensor
  within ``SAMPLE_RTOL`` of its largest magnitude, STL-10's n_err of
  every class equal, VideoAE's rmse of every epoch and class within
  ``RMSE_RTOL`` relative.  ``precise_gemm`` stays 0: the port's softmax
  head honours it and the JAX head drops it.
- The STL-10 loader reads ``stl10_binary/*.bin`` under
  ``root.common.dirs.datasets`` when present (two tiny files written
  here), the same arrays in both packages.
- The port-only mirrors of tests/test_samples_gates.py's
  ``test_stl10_sample_trains`` and tests/test_mcdnnic_samples.py's
  ``test_video_ae_reconstructs``, at those tests' sizes and gates.
- ``StandardWorkflow`` with the structural layers (conv → cutter →
  channel_splitter → channel_merger → depooling → deconv → softmax) on
  small images, fused and graph mode, two epochs: weights within
  ``WEIGHT_ATOL`` of the JAX workflow's in the same mode, n_err equal;
  each paramless layer without a GD unit of its own gets
  ``GenericVJPBackward``; a parameterized layer without one raises the
  JAX ``ValueError``; a fused build with a ``zero_filler`` raises the
  JAX ``ValueError``.
- Graph mode with ``zero_filler`` (conv → zero_filler → softmax, the
  filler's target the conv): after two train steps the weights within
  ``WEIGHT_ATOL`` of the JAX graph mode's.  The JAX unit's own ``run``
  writes no output (the layer after it sees zeros) and, once a train
  step has updated its target, fails on the weights' read-only host
  view (ROADMAP §C, "Deviations in the reference itself"); the JAX
  workflow here runs the unit as its docstring describes it, the
  identity forward and then the mask, which is what the port's does.
"""

import importlib

import numpy
import pytest

SAMPLE_RTOL = 2e-6
RMSE_RTOL = 1e-5
WEIGHT_ATOL = 1e-5


def _mods(pkg):
    return {n: importlib.import_module("%s.%s" % (pkg, n)) for n in (
        "backends", "config", "loader", "prng", "znicz.standard_workflow")}


def _host(wf):
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def _scaled_diff(a, b):
    """Largest |a - b| of any parameter tensor over its largest
    magnitude in ``b``."""
    return max(float(numpy.abs(x[k] - y[k]).max() / numpy.abs(y[k]).max())
               for x, y in zip(a, b) for k in y)


def _record_epochs(wf, mse):
    """Each class boundary's (epoch, class, n_err or rmse)."""
    epochs = []
    decision = wf.decision
    run = decision.run

    def recording():
        last = bool(decision.last_minibatch)
        run()
        if last:
            cls = decision.minibatch_class
            epochs.append((decision.epoch_number, cls,
                           float(decision.epoch_rmse[cls]) if mse else
                           decision.epoch_n_err[cls]))
    decision.run = recording
    return epochs


def _sample(pkg, name, fused, epochs, **loader):
    """The sample ``name`` of ``pkg`` from the gate tests' seeds,
    initialized on the CPU."""
    m = _mods(pkg)
    mod = importlib.import_module("%s.znicz.samples.%s" % (pkg, name))
    m["prng"].get().seed(42)
    loader = dict(loader, prng=m["prng"].RandomGenerator().seed(3))
    if pkg == "veles_tpu":
        loader["prefetch_depth"] = 0
    wf = mod.create_workflow(fused=fused, loader=loader,
                             decision={"max_epochs": epochs,
                                       "silent": True})
    wf.initialize(device=m["backends"].Device(backend="cpu"))
    return wf


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name,epochs", [("stl10", 1), ("video_ae", 2)])
def test_sample_matches_jax(name, epochs, fused):
    small = {"n_train": 100, "n_valid": 50}
    jwf = _sample("veles_tpu", name, fused, epochs, **small)
    twf = _sample("veles_tpu_torch", name, fused, epochs, **small)
    assert (twf.fused_step is None) == (jwf.fused_step is None) == \
        (not fused)
    assert [type(f).__name__ for f in twf.forwards] == \
        [type(f).__name__ for f in jwf.forwards]
    assert [type(g).__name__ for g in twf.gds] == \
        [type(g).__name__ for g in jwf.gds]
    assert twf.loader.original_data.map_read().tobytes() == \
        numpy.asarray(jwf.loader.original_data.map_read()).tobytes()
    for t, j in zip(_host(twf), _host(jwf)):
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].tobytes() == j[k].tobytes(), k
    mse = name == "video_ae"
    j_epochs, t_epochs = _record_epochs(jwf, mse), _record_epochs(twf, mse)
    jwf.run()
    twf.run()
    assert _scaled_diff(_host(twf), _host(jwf)) <= SAMPLE_RTOL
    assert [e[:2] for e in t_epochs] == [e[:2] for e in j_epochs]
    assert len(t_epochs) == 2 * epochs
    for (_, _, t), (_, _, j) in zip(t_epochs, j_epochs):
        if mse:
            assert abs(t - j) <= RMSE_RTOL * j, (t, j)
        else:
            assert t == j


def test_stl10_reads_binary_files_when_present(tmp_path):
    """Two train and one test image in the STL-10 binary layout (uint8,
    channel-major, each channel column-major; labels 1-10)."""
    from veles_tpu.config import root as jroot
    from veles_tpu.znicz.samples.stl10 import Stl10Loader as JaxLoader
    from veles_tpu.workflow import Workflow as JaxWorkflow
    from veles_tpu_torch.config import root
    from veles_tpu_torch.znicz.samples.stl10 import Stl10Loader
    from veles_tpu_torch.workflow import Workflow
    d = tmp_path / "stl10_binary"
    d.mkdir()
    rng = numpy.random.RandomState(0)
    for split, n in (("train", 2), ("test", 1)):
        (d / ("%s_X.bin" % split)).write_bytes(
            rng.randint(0, 256, n * 3 * 96 * 96).astype(numpy.uint8)
            .tobytes())
        (d / ("%s_y.bin" % split)).write_bytes(
            rng.randint(1, 11, n).astype(numpy.uint8).tobytes())
    loaded = []
    for cfg, cls, wf_cls in ((jroot, JaxLoader, JaxWorkflow),
                             (root, Stl10Loader, Workflow)):
        saved = cfg.common.dirs.get("datasets")
        cfg.common.dirs.datasets = str(tmp_path)
        try:
            loader = cls(wf_cls(name="w"), minibatch_size=1)
            loader.load_data()
        finally:
            cfg.common.dirs.datasets = saved
        loaded.append((numpy.asarray(loader.original_data.mem),
                       [int(v) for v in loader.original_labels],
                       list(loader.class_lengths)))
    (jx, jy, jl), (tx, ty, tl) = loaded
    assert tx.shape == (3, 96, 96, 3) and tx.tobytes() == jx.tobytes()
    assert ty == jy and tl == jl and tl[1:] == [1, 2]


def test_stl10_sample_trains():
    """tests/test_samples_gates.py::test_stl10_sample_trains on the
    port: 300 + 100 synthetic images, 6 epochs, best validation error
    under 50 %."""
    wf = _sample("veles_tpu_torch", "stl10", True, 6, minibatch_size=50,
                 n_train=300, n_valid=100)
    assert wf.loader.original_data.shape == (400, 96, 96, 3)
    wf.run()
    res = wf.gather_results()
    assert res["best_validation_error_pt"] < 50.0, res


def test_video_ae_reconstructs():
    """tests/test_mcdnnic_samples.py::test_video_ae_reconstructs on the
    port: 150 + 50 frames, 20 epochs, best validation rmse under half
    the targets' standard deviation."""
    wf = _sample("veles_tpu_torch", "video_ae", True, 20, minibatch_size=50,
                 n_train=150, n_valid=50)
    assert [type(f).MAPPING for f in wf.forwards] == [
        "conv_tanh", "max_pooling", "depooling", "deconv"]
    wf.run()
    res = wf.gather_results()
    floor = float(wf.loader.original_targets.map_read().std())
    assert res["best_validation_rmse"] < 0.5 * floor, (
        res["best_validation_rmse"], floor)


# -- the structural layers in StandardWorkflow --------------------------------

_GD = {"learning_rate": 0.05, "gradient_moment": 0.9}

STRUCTURAL_LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                 "padding": 1}, "<-": _GD},
    {"type": "cutter", "->": {"top": 1, "left": 1, "crop_h": 6,
                              "crop_w": 6}},
    {"type": "channel_splitter", "->": {"groups": 2}},
    {"type": "channel_merger"},
    {"type": "depooling", "->": {"kx": 2, "ky": 2}},
    # pt + pb = k - 1: the JAX unit's declared shape is the one it
    # computes, so its workflow sizes the softmax right
    {"type": "deconv", "->": {"n_kernels": 3, "kx": 3, "ky": 3,
                              "sliding": (2, 2), "padding": 1,
                              "include_bias": True}, "<-": _GD},
    {"type": "softmax", "->": {"output_sample_shape": 4}, "<-": _GD},
]


def _image_loader(pkg):
    loader = _mods(pkg)["loader"]

    class Images(loader.FullBatchLoader):
        """Four classes of 8x8x4 images: a bright quadrant each."""

        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(6)
            labels = rng.randint(0, 4, 100)
            x = rng.uniform(-0.5, 0.5, (100, 8, 8, 4)).astype(numpy.float32)
            for i, c in enumerate(labels):
                r, q = divmod(int(c), 2)
                x[i, 4 * r:4 * r + 4, 4 * q:4 * q + 4] += 1.0
            self.original_data.mem = x
            self.original_labels = list(labels)
            self.class_lengths[loader.TEST] = 0
            self.class_lengths[loader.VALID] = 30
            self.class_lengths[loader.TRAIN] = 70
    return Images


def _structural(pkg, fused, layers=STRUCTURAL_LAYERS, epochs=2):
    m = _mods(pkg)
    m["prng"].get().seed(21)
    loader = {"minibatch_size": 20, "prng": m["prng"].RandomGenerator()
              .seed(8)}
    if pkg == "veles_tpu":
        loader["prefetch_depth"] = 0
    return m["znicz.standard_workflow"].StandardWorkflow(
        None, name="structural", loader_factory=_image_loader(pkg),
        loader=loader, layers=[dict(layer) for layer in layers],
        decision={"max_epochs": epochs, "silent": True}, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_structural_layers_train_as_the_jax_workflow(fused):
    from veles_tpu_torch.backends import Device
    from veles_tpu.backends import Device as JaxDevice
    jwf = _structural("veles_tpu", fused)
    twf = _structural("veles_tpu_torch", fused)
    assert [type(g).__name__ for g in twf.gds] == [
        "GDTanhConv", "GDCutter", "GenericVJPBackward", "GenericVJPBackward",
        "GenericVJPBackward", "GDDeconv", "GDSoftmax"]
    assert [type(g).__name__ for g in twf.gds] == \
        [type(g).__name__ for g in jwf.gds]
    jwf.initialize(device=JaxDevice(backend="cpu"))
    twf.initialize(device=Device(backend="cpu"))
    assert [f.output.shape for f in twf.forwards] == [
        (20, 8, 8, 4), (20, 6, 6, 4), (2, 20, 6, 6, 2), (20, 6, 6, 4),
        (20, 12, 12, 4), (20, 23, 23, 3), (20, 4)]
    w0 = _host(twf)
    for t, j in zip(w0, _host(jwf)):
        for k in t:
            assert t[k].tobytes() == j[k].tobytes(), k
    j_epochs, t_epochs = _record_epochs(jwf, False), _record_epochs(twf,
                                                                    False)
    jwf.run()
    twf.run()
    assert t_epochs == j_epochs and len(t_epochs) == 4
    w = _host(twf)
    for t, j in zip(w, _host(jwf)):
        for k in j:
            numpy.testing.assert_allclose(t[k], j[k], rtol=0,
                                          atol=WEIGHT_ATOL, err_msg=k)
    # every parameterized layer trained
    assert all(not numpy.array_equal(a[k], b[k])
               for a, b in zip(w, w0) for k in a)


def test_parameterized_layer_without_a_gd_unit_raises():
    from veles_tpu_torch.registry import UnitRegistry
    from veles_tpu_torch.znicz.misc_units import Deconv

    class UngradedDeconv(Deconv):
        MAPPING = "ungraded_deconv"

    try:
        with pytest.raises(ValueError, match="no GD unit registered for "
                           "parameterized layer 'ungraded_deconv'"):
            _structural("veles_tpu_torch", False, layers=[
                {"type": "ungraded_deconv",
                 "->": {"n_kernels": 2, "kx": 3, "ky": 3}},
                STRUCTURAL_LAYERS[-1]])
    finally:
        UnitRegistry.units.pop("UngradedDeconv", None)
    with pytest.raises(ValueError, match="unknown layer type 'no_such'"):
        _structural("veles_tpu_torch", False, layers=[{"type": "no_such"}])


ZERO_FILLER_LAYERS = [
    {"type": "conv", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                            "padding": 1}, "<-": _GD},
    {"type": "zero_filler", "->": {"grouping": 2}},
    {"type": "softmax", "->": {"output_sample_shape": 4}, "<-": _GD},
]


def test_fused_build_refuses_zero_filler():
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        with pytest.raises(ValueError, match="zero_filler is graph-mode "
                           r"only; use Conv\(grouping=N\)"):
            _structural(pkg, True, layers=ZERO_FILLER_LAYERS)


def _jax_zero_filler_run(unit):
    """The JAX ``ZeroFiller`` run as its docstring describes it: the
    identity forward (the JAX ``ForwardBase.run``), then the mask on the
    target's weights (host side, on a writable copy)."""
    from veles_tpu.znicz.nn_units import ForwardBase

    def run():
        ForwardBase.run(unit)
        w = numpy.array(unit.target_unit.weights.map_read())
        unit.target_unit.weights.mem = w * unit.make_mask(w.shape)
    return run


def test_graph_zero_filler_trains_as_the_jax_graph():
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader import TRAIN
    jwf = _structural("veles_tpu", False, layers=ZERO_FILLER_LAYERS)
    twf = _structural("veles_tpu_torch", False, layers=ZERO_FILLER_LAYERS)
    assert type(twf.gds[1]).__name__ == "GenericVJPBackward"
    for wf in (jwf, twf):
        wf.forwards[1].target_unit = wf.forwards[0]
    jwf.forwards[1].run = _jax_zero_filler_run(jwf.forwards[1])
    jwf.initialize(device=JaxDevice(backend="cpu"))
    twf.initialize(device=Device(backend="cpu"))
    mask = twf.forwards[1].make_mask((3, 3, 4, 4))
    assert 0 < mask.sum() < mask.size
    for wf in (jwf, twf):
        for _ in range(2):
            while True:
                wf.loader.run()
                if wf.loader.minibatch_class == TRAIN:
                    break
            for fwd in wf.forwards:
                fwd.run()
            wf.evaluator.run()
            for gd in reversed(wf.gds):
                gd.run()
    numpy.testing.assert_array_equal(
        twf.forwards[1].output.map_read(), twf.forwards[0].output.map_read())
    for t, j in zip(_host(twf), _host(jwf)):
        for k in j:
            numpy.testing.assert_allclose(t[k], j[k], rtol=0,
                                          atol=WEIGHT_ATOL, err_msg=k)


def test_the_jax_zero_filler_run_writes_no_output_and_fails_on_device():
    """The deviation the port does not follow: the JAX unit's ``run``
    leaves its output at the zeros ``initialize`` made, and once its
    target's weights live on the device it fails on their read-only host
    view."""
    import jax.numpy as jnp
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.memory import Array
    from veles_tpu.prng import RandomGenerator
    from veles_tpu.workflow import Workflow
    from veles_tpu.znicz import Conv, ZeroFiller
    x = numpy.random.RandomState(1).uniform(-1, 1, (2, 5, 5, 4)).astype(
        numpy.float32)
    wf = Workflow(name="w")
    conv = Conv(wf, prng=RandomGenerator().seed(13), n_kernels=4, kx=3,
                ky=3)
    conv.input = Array(x)
    zf = ZeroFiller(wf, target_unit=conv)
    zf.link_attrs(conv, ("input", "output"))
    conv.initialize(device=JaxDevice(backend="cpu"))
    zf.initialize(device=JaxDevice(backend="cpu"))
    conv.run()
    zf.run()
    assert numpy.asarray(conv.output.map_read()).any()
    assert not numpy.asarray(zf.output.map_read()).any()
    conv.weights.devmem = jnp.asarray(conv.weights.map_read())
    with pytest.raises(ValueError, match="read-only"):
        zf.run()


def test_samples_name_the_jax_sample_config():
    """The samples' config namespaces hold the JAX samples' layers,
    loader and decision."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root
    importlib.import_module("veles_tpu.znicz.samples.stl10")
    importlib.import_module("veles_tpu.znicz.samples.video_ae")
    importlib.import_module("veles_tpu_torch.znicz.samples.stl10")
    importlib.import_module("veles_tpu_torch.znicz.samples.video_ae")
    for name in ("stl10", "video_ae"):
        assert getattr(root, name).todict() == \
            getattr(jroot, name).todict(), name
