"""Graph mode's data path of the port against the JAX package's, on the CPU.

Mirrors tests/test_loader.py ``test_normalized_loader`` and
``test_mse_loader`` and tests/test_data_layer.py ``test_input_joiner``:

- ``FullBatchLoader`` serves the JAX loader's minibatches over two
  epochs, on its host path (``force_numpy``: ``fill_minibatch``, the
  normalization baked in, ``map_minibatch_labels``) and through its
  device gather, the JAX loader on its numpy backend (its host path)
  and on its CPU device (its device gather): the same classes, sizes
  and indices, the data within ``1e-6`` (one f32 rounding of the
  normalizer; measured equal) and the labels equal; the port's padded
  rows are zero, their labels and indices -1;
- ``FullBatchLoaderMSE`` serves the targets at the minibatch's indices
  (padded rows zero) on both paths, equal to the JAX loader's on both
  backends;
- with ``defer_device_gather`` (the fused step's mode) the loader serves
  indices only and ``materialize_minibatch`` fills on demand;
- ``InputJoiner`` concatenates its inputs as the JAX unit does.
"""

import importlib

import numpy
import pytest
import torch

DATA_ATOL = 1e-6


def _pkg(pkg):
    m = {n: importlib.import_module("%s.%s" % (pkg, n))
         for n in ("backends", "loader", "prng", "workflow", "memory")}
    return m


def _synthetic(pkg, mse=False):
    """tests/test_loader.py's loaders: 60 train / 20 valid / 10 test
    samples of 8 features (4 classes), or 30 / 10 of 6 features with 3
    targets."""
    loader = _pkg(pkg)["loader"]
    TEST, VALID, TRAIN = loader.TEST, loader.VALID, loader.TRAIN

    class Synthetic(loader.FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(7)
            self.original_data.mem = rng.uniform(-1, 1, (90, 8)).astype(
                numpy.float32)
            self.original_labels = list(rng.randint(0, 4, 90))
            self.class_lengths[TEST] = 10
            self.class_lengths[VALID] = 20
            self.class_lengths[TRAIN] = 60

    class SyntheticMSE(loader.FullBatchLoaderMSE):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(3)
            self.original_data.mem = rng.uniform(-1, 1, (40, 6)).astype(
                numpy.float32)
            self.original_targets.mem = rng.uniform(-1, 1, (40, 3)).astype(
                numpy.float32)
            self.class_lengths[TEST] = 0
            self.class_lengths[VALID] = 10
            self.class_lengths[TRAIN] = 30
    return SyntheticMSE if mse else Synthetic


def _loader(pkg, backend, mse=False, **kwargs):
    m = _pkg(pkg)
    kwargs.setdefault("minibatch_size", 16 if not mse else 8)
    kwargs.setdefault("prng", m["prng"].RandomGenerator().seed(
        5 if mse else 123))
    ld = _synthetic(pkg, mse)(m["workflow"].Workflow(name="w"), **kwargs)
    ld.initialize(device=m["backends"].Device(backend=backend))
    return ld


def _served(ld, attr, n):
    return numpy.array(getattr(ld, attr).map_read()[:n])


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("jax_backend", ["numpy", "cpu"])
@pytest.mark.parametrize("normalization", ["none", "mean_disp",
                                           "range_linear"])
def test_loader_serves_the_jax_minibatches(jax_backend, normalization,
                                              host):
    jld = _loader("veles_tpu", jax_backend,
                  normalization_type=normalization)
    tld = _loader("veles_tpu_torch", "cpu", force_numpy=host,
                  normalization_type=normalization)
    if normalization == "mean_disp":    # the JAX test's own check
        assert abs(numpy.asarray(tld.original_data.mem[30:]).mean()) < 0.2
    for step in range(2 * 7):           # 1 + 2 + 4 minibatches an epoch
        jld.run()
        tld.run()
        n = tld.minibatch_size
        assert (tld.minibatch_class, n, tld.epoch_number) == (
            jld.minibatch_class, jld.minibatch_size, jld.epoch_number)
        assert numpy.array_equal(_served(tld, "minibatch_indices", n),
                                 _served(jld, "minibatch_indices", n))
        numpy.testing.assert_allclose(
            _served(tld, "minibatch_data", n),
            _served(jld, "minibatch_data", n), rtol=0, atol=DATA_ATOL)
        assert numpy.array_equal(_served(tld, "minibatch_labels", n),
                                 _served(jld, "minibatch_labels", n))
        # the device copy the first forward reads is the host's
        assert torch.equal(tld.minibatch_data.devmem,
                           torch.from_numpy(tld.minibatch_data.map_read()))
        assert tld.minibatch_data.devmem.dtype == torch.float32
        if n < tld.max_minibatch_size:
            assert not tld.minibatch_data.map_read()[n:].any()
            assert (tld.minibatch_labels.map_read()[n:] == -1).all()
            assert (tld.minibatch_indices.map_read()[n:] == -1).all()


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("jax_backend", ["numpy", "cpu"])
def test_mse_loader_serves_targets(jax_backend, host):
    jld = _loader("veles_tpu", jax_backend, mse=True)
    tld = _loader("veles_tpu_torch", "cpu", mse=True, force_numpy=host)
    assert not tld.has_labels
    for _ in range(6):                  # 2 + 4 minibatches an epoch
        jld.run()
        tld.run()
        n = tld.minibatch_size
        assert n == jld.minibatch_size
        idx = _served(tld, "minibatch_indices", n)
        assert numpy.array_equal(idx, _served(jld, "minibatch_indices", n))
        assert numpy.array_equal(_served(tld, "minibatch_targets", n),
                                 tld.original_targets.mem[idx])
        assert numpy.array_equal(_served(tld, "minibatch_targets", n),
                                 _served(jld, "minibatch_targets", n))
        assert not tld.minibatch_targets.map_read()[n:].any()


def test_deferred_gather_serves_indices_only():
    """The fused step's mode: indices only; ``materialize_minibatch``
    fills the Arrays on demand for a host-side reader."""
    ld = _loader("veles_tpu_torch", "cpu")
    ld.defer_device_gather = True
    ld.run()
    n = ld.minibatch_size
    assert not ld.minibatch_data.map_read().any()
    idx = ld._padded_indices_[:n]
    assert numpy.array_equal(ld.minibatch_indices.map_read()[:n], idx)
    ld.materialize_minibatch()
    assert numpy.array_equal(ld.minibatch_data.map_read()[:n],
                             ld.original_data.mem[idx])
    assert numpy.array_equal(ld.minibatch_labels.map_read()[:n],
                             ld._dense_labels[idx])


def test_input_joiner():
    outs = []
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        m = _pkg(pkg)
        joiner = importlib.import_module(pkg + ".input_joiner")
        wf = m["workflow"].Workflow(None)

        class Src:
            pass
        a, b, c = Src(), Src(), Src()
        a.output = numpy.ones((3, 2), numpy.float32)
        b.output = numpy.full((3, 4), 2.0, numpy.float32)
        c.output = m["memory"].Array(
            numpy.arange(12, dtype=numpy.float32).reshape(3, 2, 2))
        j = joiner.InputJoiner(wf)
        j.link_inputs((a, "output"), (b, "output"), (c, "output"))
        j.initialize(device=m["backends"].Device(backend="cpu"))
        assert j.output.shape == (3, 10)    # preallocated at initialize
        j.run()
        outs.append(numpy.array(j.output.map_read()))
    want, got = outs
    assert got.shape == (3, 10)
    assert (got[:, :2] == 1).all() and (got[:, 2:6] == 2).all()
    assert numpy.array_equal(got, want)


def test_input_joiner_needs_a_card_unless_told_cpu(monkeypatch):
    from veles_tpu_torch.input_joiner import InputJoiner
    from veles_tpu_torch.workflow import Workflow
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        InputJoiner(Workflow(None)).initialize()
