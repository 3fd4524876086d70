"""The MnistAE, Kanji and Lines samples and the MCDNN string notation,
the port against the JAX package, on the CPU.

- ``parse_mcdnnic_topology`` equals the JAX function on the strings of
  tests/test_mcdnnic_samples.py (and a flat-parameter and an
  avg-pooling one), and raises the same errors; ``StandardWorkflow``
  refuses ``layers=`` together with ``mcdnnic_topology=`` with the JAX
  message, and builds Lines' layers from its string.
- The three samples' ``create_workflow`` in both modes against the JAX
  samples from the same seeds (weights seed 42, loader seed 3), two
  epochs on a cut dataset: the loaders' arrays byte for byte, the
  initial weights byte for byte; after the run every parameter tensor
  within ``SAMPLE_RTOL`` of its largest magnitude, the rmse of every
  class and epoch within ``RMSE_RTOL`` relative (MnistAE, Kanji), n_err
  of every class and epoch equal (Lines).
- Fault C15: a sample whose config namespace holds a ``snapshotter``
  gets one in both packages (the port dropped it), and it writes.
- The port-only mirrors of the JAX gates at their own sizes:
  tests/test_samples_gates.py's MnistAE (2000 + 500, 8 epochs, rmse <
  0.5478) and tests/test_mcdnnic_samples.py's Kanji (400 + 100, 40
  epochs, rmse < 0.6 x the targets' std) and Lines (200 + 60, 12
  epochs, < 10 %).
- The loaders' MAPPINGs are registered once ``veles_tpu_torch.znicz``
  and its samples are imported.
"""

import importlib
import os

import numpy
import pytest

from _control_shared import host_params, scaled_diff

#: every parameter tensor's largest |port - JAX| over its largest
#: magnitude (f32 summation order: XLA's dot against torch's matmul)
SAMPLE_RTOL = 2e-6
#: each class's rmse of each epoch, relative
RMSE_RTOL = 1e-5

#: MnistAE moves its weights by 24-80 % of their scale a step, so the
#: summation-order difference (1.1e-7 of scale after its first step)
#: grows 3-6x a step: 100 train rows, one step an epoch, keep two
#: epochs within SAMPLE_RTOL (3.5e-7 fused, 4.4e-7 graph mode; 300
#: rows, six steps, reach 2.8e-6 / 7.8e-6)
SMALL = {"mnist_ae": {"n_train": 100, "n_valid": 100},
         "kanji": {"n_train": 100, "n_valid": 50},
         "lines": {"n_train": 80, "n_valid": 40}}


def _sample(pkg, name, fused, epochs, **kw):
    """The sample ``name`` of ``pkg`` from the gate tests' seeds,
    initialized on the CPU."""
    backends = importlib.import_module(pkg + ".backends")
    prng = importlib.import_module(pkg + ".prng")
    mod = importlib.import_module("%s.znicz.samples.%s" % (pkg, name))
    prng.get().seed(42)
    loader = dict(kw.pop("loader", {}),
                  prng=prng.RandomGenerator().seed(3))
    if pkg == "veles_tpu":
        loader["prefetch_depth"] = 0
    wf = mod.create_workflow(fused=fused, loader=loader,
                             decision={"max_epochs": epochs,
                                       "silent": True}, **kw)
    wf.initialize(device=backends.Device(backend="cpu"))
    return wf


def _record_epochs(wf, mse):
    """Each class boundary's (epoch, class, rmse or n_err)."""
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


# -- the notation -------------------------------------------------------------

PARSE_CASES = [
    ("12x256x256-32C5-MP2-64C5-AP3-1024N-10N",
     {"->": {"weights_stddev": 0.01}, "<-": {"learning_rate": 0.1}}),
    ("1x32x32-8C5-MP2-16C5-MP2-64N-4N",
     {"->": {"weights_stddev": 0.1},
      "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}),
    ("20C3-AP2-10N", {"learning_rate": 0.2}),
    ("100N-10N", None),
]


@pytest.mark.parametrize("topology,params", PARSE_CASES)
def test_mcdnnic_parse_matches_jax(topology, params):
    from veles_tpu.znicz.standard_workflow import \
        parse_mcdnnic_topology as jax_parse
    from veles_tpu_torch.znicz.standard_workflow import \
        parse_mcdnnic_topology
    assert parse_mcdnnic_topology(topology, params) == \
        jax_parse(topology, params)


@pytest.mark.parametrize("topology,match", [
    ("32C5-BOGUS-10N", "unrecognized mcdnnic token"),
    ("1x32x32", "no layers"),
    ("", "no layers")])
def test_mcdnnic_rejects_garbage_as_jax(topology, match):
    from veles_tpu.znicz.standard_workflow import \
        parse_mcdnnic_topology as jax_parse
    from veles_tpu_torch.znicz.standard_workflow import \
        parse_mcdnnic_topology
    with pytest.raises(ValueError, match=match) as port:
        parse_mcdnnic_topology(topology)
    with pytest.raises(ValueError, match=match) as ref:
        jax_parse(topology)
    assert str(port.value) == str(ref.value)


def test_mcdnnic_and_layers_are_exclusive():
    from veles_tpu_torch.znicz.samples.lines import LinesLoader
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    with pytest.raises(ValueError, match="not both"):
        StandardWorkflow(
            None, loader_factory=LinesLoader, loader={},
            layers=[{"type": "softmax",
                     "->": {"output_sample_shape": 4}}],
            mcdnnic_topology="10N")


def test_lines_builds_from_its_string():
    from veles_tpu_torch.znicz.samples import lines
    wf = lines.create_workflow(loader=SMALL["lines"])
    assert [type(f).MAPPING for f in wf.forwards] == [
        "conv_str", "max_pooling", "conv_str", "max_pooling",
        "all2all_tanh", "softmax"]
    assert [f.n_kernels for f in wf.forwards[::2][:2]] == [8, 16]
    assert wf.gds[0].learning_rate == 0.05
    # layers= replaces the string, as in the JAX build_standard
    wf = lines.create_workflow(loader=SMALL["lines"], layers=[
        {"type": "softmax", "->": {"output_sample_shape": 4}}])
    assert [type(f).MAPPING for f in wf.forwards] == ["softmax"]


# -- the samples against the JAX package --------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["mnist_ae", "kanji", "lines"])
def test_sample_matches_jax(name, fused):
    jwf = _sample("veles_tpu", name, fused, 2, loader=SMALL[name])
    twf = _sample("veles_tpu_torch", name, fused, 2, loader=SMALL[name])
    assert [type(f).__name__ for f in twf.forwards] == \
        [type(f).__name__ for f in jwf.forwards]
    assert [type(g).__name__ for g in twf.gds] == \
        [type(g).__name__ for g in jwf.gds]
    mse = name != "lines"
    arrays = ["original_data"] + (["original_targets"] if mse else [])
    for attr in arrays:
        assert getattr(twf.loader, attr).map_read().tobytes() == \
            numpy.asarray(getattr(jwf.loader, attr).map_read()).tobytes()
    assert [int(v) for v in twf.loader.original_labels] == \
        [int(v) for v in jwf.loader.original_labels]
    assert list(twf.loader.class_lengths) == list(jwf.loader.class_lengths)
    for t, j in zip(host_params(twf), host_params(jwf)):
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].tobytes() == j[k].tobytes(), k
    j_epochs, t_epochs = _record_epochs(jwf, mse), _record_epochs(twf, mse)
    jwf.run()
    twf.run()
    assert scaled_diff(host_params(twf), host_params(jwf)) <= SAMPLE_RTOL
    assert [e[:2] for e in t_epochs] == [e[:2] for e in j_epochs]
    assert len(t_epochs) == 4
    for (_, _, t), (_, _, j) in zip(t_epochs, j_epochs):
        if mse:
            assert abs(t - j) <= RMSE_RTOL * j, (t, j)
        else:
            assert t == j


def test_glyphs_and_lines_equal_the_jax_ones():
    from veles_tpu.znicz.samples import kanji as jkanji, lines as jlines
    from veles_tpu_torch.znicz.samples import kanji, lines
    assert kanji.make_glyphs(16).tobytes() == jkanji.make_glyphs(16).tobytes()
    assert kanji.make_glyphs(5, side=12, seed=3).tobytes() == \
        jkanji.make_glyphs(5, side=12, seed=3).tobytes()
    for orientation in range(4):
        assert lines.draw_line(orientation).tobytes() == \
            jlines.draw_line(orientation).tobytes()
        assert lines.draw_line(
            orientation, rng=numpy.random.RandomState(orientation)
        ).tobytes() == jlines.draw_line(
            orientation, rng=numpy.random.RandomState(orientation)
        ).tobytes()


# -- fault C15: the config namespace's snapshotter ----------------------------

@pytest.mark.parametrize("pkg", ["veles_tpu", "veles_tpu_torch"])
def test_build_standard_takes_the_config_snapshotter(pkg, tmp_path):
    """``root.<sample>.snapshotter = {...}`` gives the sample a
    snapshotter in both packages (the port dropped it: fault C15)."""
    config = importlib.import_module(pkg + ".config")
    mnist_ae = importlib.import_module(pkg + ".znicz.samples.mnist_ae")
    cfg = config.root.mnist_ae
    cfg.snapshotter = {"prefix": "ae", "directory": str(tmp_path),
                       "time_interval": 0}
    try:
        wf = _sample(pkg, "mnist_ae", True, 1,
                     loader={"n_train": 100, "n_valid": 100})
        assert wf.snapshotter is not None
        assert wf.snapshotter.prefix == "ae"
        wf.run()
        wf.snapshotter.stop()
    finally:
        del cfg.snapshotter
    assert "snapshotter" not in cfg
    assert any(n.startswith("ae") for n in os.listdir(str(tmp_path)))
    assert mnist_ae.create_workflow(
        loader={"n_train": 100, "n_valid": 100}).snapshotter is None


# -- the gates, on the port ---------------------------------------------------

def test_mnist_ae_rmse_gate():
    """tests/test_samples_gates.py::test_mnist_ae_rmse_gate on the port:
    2000 + 500 digits, minibatch 100, 8 epochs, best validation rmse
    under the published 0.5478."""
    wf = _sample("veles_tpu_torch", "mnist_ae", True, 8,
                 loader={"minibatch_size": 100, "n_train": 2000,
                         "n_valid": 500})
    assert wf.loader.provenance in ("fixture", "real")
    wf.run()
    res = wf.gather_results()
    assert res["best_validation_rmse"] < 0.5478, res


def test_kanji_denoises_to_targets():
    """tests/test_mcdnnic_samples.py::test_kanji_denoises_to_targets on
    the port: 400 + 100, minibatch 50, 40 epochs, best validation rmse
    under 0.6 of the targets' standard deviation."""
    wf = _sample("veles_tpu_torch", "kanji", True, 40,
                 loader={"minibatch_size": 50, "n_train": 400,
                         "n_valid": 100})
    wf.run()
    res = wf.gather_results()
    floor = float(wf.loader.original_targets.map_read().std())
    assert res["best_validation_rmse"] < 0.6 * floor, (
        res["best_validation_rmse"], floor)


def test_lines_sample_trains_via_mcdnnic():
    """tests/test_mcdnnic_samples.py::test_lines_sample_trains_via_mcdnnic
    on the port: 200 + 60, minibatch 40, 12 epochs, under 10 %."""
    wf = _sample("veles_tpu_torch", "lines", True, 12,
                 loader={"minibatch_size": 40, "n_train": 200,
                         "n_valid": 60})
    wf.run()
    res = wf.gather_results()
    assert res["best_validation_error_pt"] < 10.0, res


def test_mappings_registered():
    import veles_tpu_torch.znicz  # noqa: F401
    import veles_tpu_torch.znicz.samples  # noqa: F401
    from veles_tpu_torch.registry import UnitRegistry
    mappings = {getattr(c, "MAPPING", None)
                for c in UnitRegistry.units.values()}
    for name in ("lr_adjuster", "weights_rollback", "image_saver",
                 "mnist_ae_loader", "kanji_loader", "lines_loader"):
        assert name in mappings, name
