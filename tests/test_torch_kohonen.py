"""The Kohonen map (``znicz/kohonen.py``) and the DemoKohonen sample
against the JAX package's, on the CPU.

- ``KohonenForward``: the winners of a random codebook equal the JAX
  unit's and the squared distances are within ``DIST_ATOL``; of
  duplicated codebook rows the first wins in both packages.
- ``KohonenTrainer`` in the DemoKohonen workflow: the dataset and the
  initial codebook byte for byte, then after one epoch the codebook
  within ``CODEBOOK_ATOL`` and the quantization error within
  ``QERROR_RTOL`` relative; also on a cut dataset whose last minibatch
  is padded (108 points in minibatches of 50), where the padded rows
  change nothing.  Mid-epoch the public ``weights`` hold the last
  epoch's codebook, as in the JAX unit.
- The mirror of ``tests/test_samples_gates.py::
  test_kohonen_som_organizes`` (12 epochs): the quantization error
  falls below half of the first epoch's in both packages, the codebook
  is ``(64, 2)``, the results surface through ``gather_results``, and
  the whole ``qerror_history`` is within ``QERROR_RTOL`` relative of
  the JAX one (the online update compounds rounding, so the codebooks
  are held only after one epoch).
- ``convert.trainer_params_from_jax`` carries a JAX codebook into the
  port's trainer before and after ``initialize``; a wrong shape or name
  raises.
"""

import importlib

import numpy
import pytest
import torch

DIST_ATOL = 1e-5
CODEBOOK_ATOL = 1e-5
QERROR_RTOL = 1e-4
GATE_EPOCHS = 12


def _mod(pkg, name):
    return importlib.import_module("%s.%s" % (pkg, name))


def _cpu(pkg):
    return _mod(pkg, "backends").Device(backend="cpu")


def _forward(pkg, w, x):
    """A KohonenForward of ``pkg`` over the codebook ``w`` and the
    samples ``x``, run once; -> (winners, distances)."""
    Array = _mod(pkg, "memory").Array
    unit = _mod(pkg, "znicz.kohonen").KohonenForward(
        _mod(pkg, "workflow").Workflow(None), shape=(4, 4))
    unit.weights.mem = w.copy()
    unit.minibatch_data = Array(x.copy())
    if pkg == "veles_tpu_torch":
        unit.minibatch_data.initialize(_cpu(pkg))
    unit.initialize(device=_cpu(pkg))
    unit.run()
    return (numpy.asarray(unit.output.map_read()),
            numpy.asarray(unit.distances.map_read()))


def test_forward_winners_equal_jax():
    rng = numpy.random.RandomState(11)
    w = rng.randn(16, 5).astype(numpy.float32)
    x = rng.randn(40, 5).astype(numpy.float32)
    (jwin, jd), (win, d) = (_forward(pkg, w, x)
                            for pkg in ("veles_tpu", "veles_tpu_torch"))
    assert win.dtype == jwin.dtype == numpy.int32
    assert win.tolist() == jwin.tolist()
    assert numpy.abs(d - jd).max() <= DIST_ATOL
    brute = ((x[:, None, :] - w[None]) ** 2).sum(-1)
    assert win.tolist() == brute.argmin(1).tolist()


def test_duplicated_rows_the_first_wins():
    """Rows 3, 9 and 12 are one vector, and each sample is that vector:
    every winner is 3, in both packages and in the trainer's loop."""
    from veles_tpu_torch.znicz import kohonen
    rng = numpy.random.RandomState(5)
    w = rng.randn(16, 3).astype(numpy.float32)
    w[9] = w[12] = w[3]
    x = numpy.repeat(w[3:4], 6, axis=0) + numpy.float32(1e-3)
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        win, _ = _forward(pkg, w, x)
        assert win.tolist() == [3] * 6, pkg
    # the trainer's winner is the same first index: its update is the
    # one centred on neuron 3, not on 9 or 12
    grid = torch.tensor([[i // 4, i % 4] for i in range(16)],
                        dtype=torch.float32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x[0])
    w1, _ = kohonen.train_batch(tw, torch.zeros(()), tx[None], 1, grid,
                                0.5, 2.0)

    def centred(win):
        neigh = torch.exp(-((grid - grid[win]) ** 2).sum(dim=1) / 2.0)
        return tw + 0.5 * neigh[:, None] * (tx[None, :] - tw)
    assert torch.equal(w1, centred(3))
    assert not torch.equal(w1, centred(9))
    assert not torch.equal(w1, centred(12))


def demo(pkg, epochs, **loader):
    """The DemoKohonen workflow of ``pkg``, initialized on the CPU, its
    loader shuffling with a generator seeded 3."""
    mod = _mod(pkg, "znicz.samples.kohonen")
    loader["prng"] = _mod(pkg, "prng").RandomGenerator().seed(3)
    wf = mod.create_workflow(loader=loader,
                             decision={"max_epochs": epochs,
                                       "silent": True})
    wf.initialize(device=_cpu(pkg))
    return wf


def _codebook(wf):
    return numpy.array(wf.trainer.weights.map_read())


@pytest.mark.parametrize("n_train", [1000, 110])
def test_one_epoch_codebook_matches_jax(n_train):
    jwf = demo("veles_tpu", 1, n_train=n_train)
    wf = demo("veles_tpu_torch", 1, n_train=n_train)
    assert wf.loader.original_data.map_read().tobytes() == \
        numpy.asarray(jwf.loader.original_data.map_read()).tobytes()
    assert _codebook(wf).tobytes() == _codebook(jwf).tobytes()
    assert _codebook(wf).shape == (64, 2)
    jwf.run()
    wf.run()
    assert numpy.abs(_codebook(wf) - _codebook(jwf)).max() <= CODEBOOK_ATOL
    (q,), (jq,) = wf.decision.qerror_history, jwf.decision.qerror_history
    assert abs(q - jq) <= QERROR_RTOL * jq
    assert wf.trainer.get_metric_values() == {
        "mean_quantization_error": q}


def test_padded_rows_change_nothing():
    """108 points in minibatches of 50: the last minibatch holds 8 valid
    rows of 50, and the trainer's pass over it is the same whatever the
    42 padded rows hold."""
    from veles_tpu_torch.loader import TRAIN
    from veles_tpu_torch.znicz import kohonen
    wf = demo("veles_tpu_torch", 1, n_train=110)
    ld, tr = wf.loader, wf.trainer
    sizes = []
    while True:
        ld.run()
        sizes.append(ld.minibatch_size)
        if bool(ld.last_minibatch):
            break
        tr.run()
    assert ld.minibatch_class == TRAIN and sizes == [50, 50, 8]
    xb = ld.minibatch_data.devmem
    assert xb.shape[0] == 50
    w, q = tr._w_.clone(), tr._qacc_.clone()
    lr, sigma = tr._schedule()
    args = (tr._grid_, lr, 2.0 * sigma * sigma)
    full = kohonen.train_batch(w, q, xb, 8, *args)
    junk = xb.clone()
    junk[8:] = 1e3
    other = kohonen.train_batch(w, q, junk, 8, *args)
    assert all(torch.equal(a, b) for a, b in zip(full, other))
    assert not torch.equal(full[0], w)


def test_weights_hold_the_last_epochs_codebook_mid_epoch():
    wf = demo("veles_tpu_torch", 2)
    first = _codebook(wf)
    ld, tr = wf.loader, wf.trainer
    for _ in range(3):
        ld.run()
        tr.run()
    assert _codebook(wf).tobytes() == first.tobytes()
    assert not torch.equal(tr._w_, torch.from_numpy(first))


def test_demo_kohonen_organizes_as_jax():
    """``test_kohonen_som_organizes`` on both packages."""
    results = []
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        wf = demo(pkg, GATE_EPOCHS)
        wf.run()
        h = wf.decision.qerror_history
        assert len(h) == GATE_EPOCHS
        assert h[-1] < h[0] * 0.5, (pkg, h[0], h[-1])
        assert _codebook(wf).shape == (64, 2)
        res = wf.gather_results()
        assert res["final_quantization_error"] == h[-1]
        results.append(numpy.array(h))
    jh, h = results
    assert (numpy.abs(h - jh) / jh).max() <= QERROR_RTOL


def test_trainer_params_from_jax():
    from veles_tpu_torch.convert import trainer_params_from_jax
    jwf = demo("veles_tpu", 1)
    jwf.run()
    trained = numpy.array(jwf.trainer.weights.map_read())
    # before initialize: the unit skips its random init
    mod = _mod("veles_tpu_torch", "znicz.samples.kohonen")
    wf = mod.create_workflow(decision={"max_epochs": 1, "silent": True},
                             loader={"prng": _mod(
                                 "veles_tpu_torch",
                                 "prng").RandomGenerator().seed(3)})
    trainer_params_from_jax(wf.trainer, {"weights": trained})
    wf.initialize(device=_cpu("veles_tpu_torch"))
    assert _codebook(wf).tobytes() == trained.tobytes()
    assert torch.equal(wf.trainer._w_, torch.from_numpy(trained))
    # after it: the live codebook reloads
    fresh = demo("veles_tpu_torch", 1)
    trainer_params_from_jax(fresh.trainer, {"weights": trained})
    assert torch.equal(fresh.trainer._w_, torch.from_numpy(trained))
    with pytest.raises(ValueError, match="weights"):
        trainer_params_from_jax(fresh.trainer, {"weights": trained[:, :1]})
    with pytest.raises(ValueError, match="given"):
        trainer_params_from_jax(fresh.trainer, {"codebook": trained})
