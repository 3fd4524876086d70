"""The CD-1 RBM (``znicz/rbm.py``) and ``prng.split`` against the JAX
package, on the CPU.

- ``prng.split`` gives ``jax.random.split``'s keys bit for bit (jax 0.9's
  partitionable threefry) for several seeds, seeds at and around the
  RBM's counter wrap ``0x7FFF0000`` among them, and 2, 3 and 5 keys;
  keys held as 0-d tensors give the same words; ``uniform`` of the first
  split key gives ``jax.random.uniform``'s bits.
- The first train minibatch of the JAX test's workflow
  (``tests/test_znicz_extra.py::test_rbm_reconstruction_improves``: 64
  visible, 32 hidden, 600 binary rows, minibatch 50): ``ph`` within
  ``PH_ATOL`` of JAX's, the uniforms bit for bit, and the hidden draws
  equal apart from counted flips, each within ``FLIP_ATOL`` of ``ph``
  (an ulp of ``sigmoid`` or of the matmul can move ``ph`` across a draw;
  the count is the junit record's ``hidden_flips``).
- The reconstruction error of each of two epochs within ``ERROR_RTOL``
  relative of the JAX trainer's, and the published weights and biases
  within ``PARAM_ATOL``; the trainer starts from the JAX package's
  initial weights (``RandomGenerator`` seeded 2) and zero biases, byte
  for byte, and its counter steps from ``seed % 0x7FFF0000``.
- The port-only mirror of the JAX test's gate: six epochs bring the
  error below 0.7 of the first.
- ``convert.trainer_params_from_jax`` carries the JAX trainer's three
  arrays into the port's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu_torch import prng

PH_ATOL = 1e-6
FLIP_ATOL = 1e-6
ERROR_RTOL = 1e-4
PARAM_ATOL = 1e-5
WRAP = 0x7FFF0000
SPLIT_SEEDS = [0, 11, 12, 12345, 2 ** 31 - 1, WRAP - 1, WRAP, WRAP + 1]


def _words(keys):
    return [tuple(int(w) for w in k) for k in numpy.asarray(keys)]


@pytest.mark.parametrize("seed", SPLIT_SEEDS)
def test_split_equals_jax(seed):
    jk = jax.random.PRNGKey(seed)
    assert prng.key(seed) == tuple(numpy.asarray(jk).tolist())
    for num in (2, 3, 5):
        assert prng.split(prng.key(seed), num) == \
            _words(jax.random.split(jk, num))
    held = prng.split(prng.key(torch.tensor(seed, dtype=torch.int64)))
    assert [tuple(int(w) for w in k) for k in held] == \
        _words(jax.random.split(jk))
    kh, _ = jax.random.split(jk)
    want = numpy.asarray(jax.random.uniform(kh, (50, 32)))
    got = prng.uniform(prng.split(prng.key(seed))[0], (50, 32), "cpu")
    assert got.numpy().tobytes() == want.tobytes()


def _mod(pkg, name):
    return importlib.import_module("%s.%s" % (pkg, name))


def rbm_workflow(pkg, **trainer):
    """The JAX test's hand-built workflow: repeater → binary loader →
    RBMTrainer, initialized on the CPU; -> (workflow, loader, trainer)."""
    loader_base = _mod(pkg, "loader.base")

    class BinaryLoader(_mod(pkg, "loader.fullbatch").FullBatchLoader):
        def load_data(self):
            rng = numpy.random.RandomState(5)
            # binary patterns with structure: 8 prototypes + noise
            protos = (rng.rand(8, 64) > 0.5).astype(numpy.float32)
            idx = rng.randint(0, 8, 600)
            data = protos[idx]
            flip = rng.rand(*data.shape) < 0.05
            data[flip] = 1.0 - data[flip]
            self.original_data.mem = data
            self.class_lengths[loader_base.TEST] = 0
            self.class_lengths[loader_base.VALID] = 0
            self.class_lengths[loader_base.TRAIN] = 600
            self.has_labels = False

    wf = _mod(pkg, "workflow").Workflow(None)
    rep = _mod(pkg, "plumbing").Repeater(wf)
    rep.link_from(wf.start_point)
    ld = BinaryLoader(wf, minibatch_size=50,
                      prng=_mod(pkg, "prng").RandomGenerator().seed(2))
    ld.link_from(rep)
    rbm = _mod(pkg, "znicz.rbm").RBMTrainer(
        wf, **dict({"n_hidden": 32, "learning_rate": 0.2}, **trainer))
    rbm.link_from(ld)
    rbm.link_loader(ld)
    wf.initialize(device=_mod(pkg, "backends").Device(backend="cpu"))
    return wf, ld, rbm


def _epochs(ld, rbm, n):
    errors = []
    for _ in range(n):
        for _ in range(12):
            ld.run()
            rbm.run()
        errors.append(float(rbm.recon_error[0]))
    return errors


@pytest.mark.parametrize("seed", [11, WRAP - 1])
def test_first_minibatch_draws_equal_jax(seed, record_property):
    """The hidden sample of the first train minibatch (the counter
    stepped once: ``seed + 1`` modulo the wrap)."""
    from veles_tpu_torch.znicz import rbm as rbm_mod
    _, ld, rbm = rbm_workflow("veles_tpu_torch", seed=seed)
    _, jld, jrbm = rbm_workflow("veles_tpu", seed=seed)
    ld.run()
    jld.run()
    v = ld.minibatch_data.devmem
    jv = numpy.asarray(jld.minibatch_data.map_read())
    assert v.numpy().tobytes() == jv.tobytes()
    w = numpy.array(jrbm.weights.map_read())
    hb = numpy.array(jrbm.hbias.map_read())
    assert rbm.weights.map_read().tobytes() == w.tobytes()
    assert not hb.any() and not rbm.hbias.map_read().any()
    step = (seed % WRAP + 1) % WRAP
    # the JAX cd1's hidden sample (veles_tpu/znicz/rbm.py:69-73)
    kh, _ = jax.random.split(jax.random.PRNGKey(step))
    jph = jax.nn.sigmoid(jnp.asarray(jv) @ jnp.asarray(w) +
                         jnp.asarray(hb))
    ju = jax.random.uniform(kh, jph.shape)
    jh = numpy.asarray((ju < jph).astype(jnp.float32))
    jph, ju = numpy.asarray(jph), numpy.asarray(ju)
    ph, u, h = rbm_mod.hidden_draw(rbm._w_, rbm._hb_, v, step)
    ph, u, h = ph.numpy(), u.numpy(), h.numpy()
    assert u.tobytes() == ju.tobytes()
    assert numpy.abs(ph - jph).max() <= PH_ATOL
    flips = numpy.flatnonzero(h != jh)
    record_property("hidden_flips", int(flips.size))
    assert numpy.abs(u.ravel()[flips] - jph.ravel()[flips]).max(
        initial=0.0) <= FLIP_ATOL
    assert flips.size <= 2
    # the trainer's own step draws with that counter
    rbm.run()
    assert rbm._seed_counter == step


def test_error_trajectory_and_parameters_match_jax():
    _, ld, rbm = rbm_workflow("veles_tpu_torch")
    _, jld, jrbm = rbm_workflow("veles_tpu")
    got, want = _epochs(ld, rbm, 2), _epochs(jld, jrbm, 2)
    for g, w in zip(got, want):
        assert abs(g - w) <= ERROR_RTOL * w, (got, want)
    for name in ("weights", "vbias", "hbias"):
        a = getattr(rbm, name).map_read()
        b = numpy.asarray(getattr(jrbm, name).map_read())
        assert a.shape == b.shape
        assert numpy.abs(a - b).max() <= PARAM_ATOL, name
    assert rbm.get_metric_values() == {"reconstruction_error": got[-1]}


def test_reconstruction_improves():
    """``test_rbm_reconstruction_improves`` on the port."""
    _, ld, rbm = rbm_workflow("veles_tpu_torch")
    errors = _epochs(ld, rbm, 6)
    assert errors[-1] < errors[0] * 0.7, errors


def test_trainer_params_from_jax():
    from veles_tpu_torch.convert import trainer_params_from_jax
    _, jld, jrbm = rbm_workflow("veles_tpu")
    _epochs(jld, jrbm, 1)
    arrays = {name: numpy.array(getattr(jrbm, name).map_read())
              for name in ("weights", "vbias", "hbias")}
    _, ld, rbm = rbm_workflow("veles_tpu_torch")
    trainer_params_from_jax(rbm, arrays)
    for name, live in (("weights", rbm._w_), ("vbias", rbm._vb_),
                       ("hbias", rbm._hb_)):
        assert live.numpy().tobytes() == arrays[name].tobytes(), name
    with pytest.raises(ValueError, match="given"):
        trainer_params_from_jax(rbm, {"weights": arrays["weights"]})
