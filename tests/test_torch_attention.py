"""The attention unit of the port against the JAX package, on the CPU.

- Seeded alike, ``MultiHeadAttention`` gets the JAX unit's initial
  ``weights`` / ``proj`` / ``bias`` bytes.
- Its forward matches the JAX unit within 1e-5 (no mask, causal, window
  10), through the oracle (``use_pallas=False``) and through the flash
  autograd Function (``use_pallas=True``: the kernels' plain versions on
  the CPU).
- ``GDMultiHeadAttention.backward`` matches ``jax.vjp`` of the JAX
  unit's apply within 1e-5 (tests/test_attention_unit.py:44-62).
- The tri-state ``use_pallas`` and ``mesh`` behave as documented.
- The needle task of tests/test_attention_unit.py:112-156 through
  ``StandardWorkflow``, port against JAX from the same seeds, the
  initial weights carried across with ``workflow_params_from_jax``:
  minibatch order and per-epoch n_err equal for 2 epochs, the loss at
  each epoch end within ``rtol=1e-5`` and the weights within
  ``WEIGHT_ATOL`` = 1e-6 (the two differ in f32 summation order only;
  measured 3.0e-8 after 18 train steps, with either ``use_pallas``).
  Then the JAX test's 25-epoch gate: best validation error under 40 %
  (chance is 75 %).
"""

import numpy
import pytest
import torch

import jax

T, D, C = 8, 8, 4
GD = {"learning_rate": 0.01, "gradient_moment": 0.9}
EPOCHS = 2
LOSS_RTOL = 1e-5
WEIGHT_ATOL = 1e-6


def _input(b=4, t=8, d=12):
    rng = numpy.random.RandomState(1)
    return rng.uniform(-1, 1, (b, t, d)).astype(numpy.float32)


def _jax_unit(x, **kw):
    from veles_tpu.backends import Device
    from veles_tpu.memory import Array
    from veles_tpu.prng import RandomGenerator
    from veles_tpu.workflow import Workflow
    from veles_tpu.znicz.attention import MultiHeadAttention
    u = MultiHeadAttention(Workflow(name="attn"), heads=2,
                           prng=RandomGenerator().seed(7), **kw)
    u.input = Array(x.copy())
    u.initialize(device=Device(backend="cpu"))
    return u


def _port_unit(x, **kw):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.attention import MultiHeadAttention
    u = MultiHeadAttention(Workflow(name="attn"), heads=2,
                           prng=RandomGenerator().seed(7), **kw)
    u.input = Array(x.copy())
    u.initialize(device=Device(backend="cpu"))
    return u


def test_initial_params_equal_jax_bytes():
    x = _input()
    jparams = _jax_unit(x).host_params
    tparams = _port_unit(x).host_params
    assert sorted(tparams) == ["bias", "proj", "weights"]
    for name, value in tparams.items():
        assert value.tobytes() == numpy.asarray(jparams[name]).tobytes(), \
            name


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mask", [{}, {"causal": True},
                                  {"causal": True, "window": 10}])
def test_forward_matches_jax(mask, use_pallas):
    x = _input(t=24)
    ju = _jax_unit(x, use_pallas=False, **mask)
    ju.run()
    tu = _port_unit(x, use_pallas=use_pallas, **mask)
    assert tu._resolved_use_pallas() is use_pallas
    tu.run()
    numpy.testing.assert_allclose(tu.output.map_read(),
                                  numpy.asarray(ju.output.map_read()),
                                  rtol=1e-5, atol=1e-5)
    assert tu.export_params() == ju.export_params()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_backward_is_the_jax_vjp(use_pallas):
    from veles_tpu_torch.znicz.attention import GDMultiHeadAttention
    x = _input()
    ju = _jax_unit(x, causal=True)
    tu = _port_unit(x, causal=True, use_pallas=use_pallas)
    gd = GDMultiHeadAttention(tu.workflow, learning_rate=0.0)
    gd.link_forward(tu)
    rng = numpy.random.RandomState(2)
    err = rng.uniform(-1, 1, x.shape).astype(numpy.float32)
    params = {k: numpy.asarray(v) for k, v in ju.params.items()}
    _, pull = jax.vjp(lambda p, xx: ju.apply(p, xx), params, x)
    g_ref, e_ref = pull(err)
    err_in, grads = gd.backward(tu.params, torch.tensor(x), None,
                                torch.tensor(err))
    numpy.testing.assert_allclose(err_in.numpy(), numpy.asarray(e_ref),
                                  rtol=1e-5, atol=1e-5)
    assert sorted(grads) == ["bias", "proj", "weights"]
    for name, g in grads.items():
        numpy.testing.assert_allclose(
            g.numpy(), numpy.asarray(g_ref[name]) / x.shape[0],
            rtol=1e-5, atol=1e-5, err_msg=name)


def test_resolve_use_pallas_semantics():
    """True / False force; AUTO is the kernels on the unit's own device
    when it is the card, the oracle elsewhere; with no device yet, the
    card when torch sees one."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.znicz.nn_units import resolve_use_pallas

    class FakeCard:
        BACKEND = "cuda"

    cpu = Device(backend="cpu")
    assert resolve_use_pallas(True, cpu) is True
    assert resolve_use_pallas(False, FakeCard()) is False
    assert resolve_use_pallas(None, FakeCard()) is True
    assert resolve_use_pallas(None, cpu) is False
    assert resolve_use_pallas(None, None) is torch.cuda.is_available()


def test_use_pallas_auto_default_and_config():
    from veles_tpu_torch.config import root
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.attention import MultiHeadAttention
    assert root.common.engine.get("use_pallas", None) is None
    unit = _port_unit(_input())
    assert unit.use_pallas is None
    assert unit._resolved_use_pallas() is False      # on the CPU
    assert MultiHeadAttention(Workflow(name="w"), heads=2,
                              use_pallas=True)._resolved_use_pallas()
    root.common.engine.use_pallas = True
    try:
        assert MultiHeadAttention(Workflow(name="w"),
                                  heads=2).use_pallas is True
    finally:
        root.common.engine.use_pallas = None


def test_mesh_and_bad_windows_raise():
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.attention import MultiHeadAttention
    wf = Workflow(name="w")
    with pytest.raises(NotImplementedError, match="mesh"):
        MultiHeadAttention(wf, heads=2, mesh=object())
    with pytest.raises(ValueError, match="causal"):
        MultiHeadAttention(wf, heads=2, window=4)
    for w in (0, -3):
        with pytest.raises(ValueError, match=">= 1"):
            MultiHeadAttention(wf, heads=2, causal=True, window=w)
    unit = MultiHeadAttention(wf, heads=5)
    from veles_tpu_torch.memory import Array
    unit.input = Array(_input())
    with pytest.raises(ValueError, match="divide"):
        unit.init_params()


# -- the needle task through StandardWorkflow ---------------------------------

def _needle(n=600):
    """tests/test_attention_unit.py's data: find the marked position's
    payload class."""
    rng = numpy.random.RandomState(3)
    x = rng.uniform(-0.2, 0.2, (n, T, D)).astype(numpy.float32)
    labels = rng.randint(0, C, n)
    pos = rng.randint(0, T, n)
    for i in range(n):
        x[i, pos[i], 0] = 2.0
        x[i, pos[i], 1 + labels[i]] = 2.0
    return x, list(labels.astype(numpy.int32))


def _layers(**fwd):
    return [{"type": "multihead_attention", "->": dict(fwd, heads=2),
             "<-": dict(GD)},
            {"type": "softmax", "->": {"output_sample_shape": C},
             "<-": dict(GD)}]


def _jax_workflow(epochs=EPOCHS):
    from veles_tpu import prng
    from veles_tpu.backends import Device
    from veles_tpu.loader.base import TEST, TRAIN, VALID
    from veles_tpu.loader.fullbatch import FullBatchLoader
    from veles_tpu.prng import RandomGenerator
    from veles_tpu.znicz.standard_workflow import StandardWorkflow

    class NeedleLoader(FullBatchLoader):
        def load_data(self):
            self.original_data.mem, self.original_labels = _needle()
            self.class_lengths[TEST] = 0
            self.class_lengths[VALID] = 150
            self.class_lengths[TRAIN] = 450

    prng.get().seed(42)
    wf = StandardWorkflow(
        None, name="attn-wf", loader_factory=NeedleLoader,
        loader={"minibatch_size": 50, "prng": RandomGenerator().seed(5),
                "prefetch_depth": 0},
        layers=_layers(), loss_function="softmax",
        decision={"max_epochs": epochs, "silent": True}, fused=True)
    wf.initialize(device=Device(backend="cpu"))
    return wf


def _port_workflow(epochs=EPOCHS, **fwd):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader.base import TEST, TRAIN, VALID
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

    class NeedleLoader(FullBatchLoader):
        def load_data(self):
            self.original_data.mem, self.original_labels = _needle()
            self.class_lengths[TEST] = 0
            self.class_lengths[VALID] = 150
            self.class_lengths[TRAIN] = 450

    prng.get().seed(42)
    wf = StandardWorkflow(
        None, name="attn-wf", loader_factory=NeedleLoader,
        loader={"minibatch_size": 50, "prng": RandomGenerator().seed(5)},
        layers=_layers(**fwd), loss_function="softmax",
        decision={"max_epochs": epochs, "silent": True}, fused=True)
    wf.initialize(device=Device(backend="cpu"))
    return wf


def _record(wf):
    rec = {"order": [], "epochs": []}
    step, decision = wf.fused_step, wf.decision
    step_run, epoch_end = step.run, decision._on_epoch_end

    def run():
        ld = step.gather_loader
        rec["order"].append((int(ld.minibatch_class),
                             int(ld.minibatch_size),
                             ld._padded_indices_.tolist()))
        step_run()

    def on_epoch_end():
        rec["epochs"].append((list(decision.epoch_n_err), float(step.loss)))
        epoch_end()

    step.run = run
    decision._on_epoch_end = on_epoch_end
    return rec


@pytest.mark.parametrize("use_pallas", [None, True])
def test_needle_training_matches_jax(use_pallas):
    """AUTO (the oracle on the CPU) and the flash Function's plain
    versions both follow the JAX package's trajectory."""
    from veles_tpu_torch.convert import workflow_params_from_jax
    jwf = _jax_workflow()
    twf = _port_workflow(use_pallas=use_pallas)
    jparams = [{k: numpy.array(v) for k, v in f.host_params.items()}
               for f in jwf.forwards]
    for fwd, want in zip(twf.forwards, jparams):
        for name, value in fwd.host_params.items():
            assert value.tobytes() == want[name].tobytes(), name
    workflow_params_from_jax(twf, jparams)
    jrec, trec = _record(jwf), _record(twf)
    jwf.run()
    twf.run()
    assert trec["order"] == jrec["order"]
    assert [(c, s) for c, s, _ in trec["order"][:3]] == [(1, 50)] * 3
    assert len(trec["epochs"]) == len(jrec["epochs"]) == EPOCHS
    for (t_err, t_loss), (j_err, j_loss) in zip(trec["epochs"],
                                                jrec["epochs"]):
        assert t_err == j_err
        assert t_loss == pytest.approx(j_loss, rel=LOSS_RTOL)
    for fwd, jfwd in zip(twf.forwards, jwf.forwards):
        for name, value in fwd.host_params.items():
            diff = numpy.abs(value - numpy.asarray(
                jfwd.host_params[name])).max()
            assert diff <= WEIGHT_ATOL, (name, diff)


def test_needle_training_reaches_the_jax_gate():
    wf = _port_workflow(epochs=25)
    wf.run()
    res = wf.gather_results()
    assert res["best_validation_error_pt"] < 40.0, res   # chance = 75
    step = wf.fused_step
    assert (step.train_steps, step.eval_steps) == (25 * 9, 25 * 3)


def test_fused_step_trains_proj():
    """``proj`` is a weight of the fused step like ``weights``: it moves,
    and ``sync_weights`` carries it back to the unit."""
    wf = _port_workflow(epochs=1)
    unit = wf.forwards[0]
    before = {k: v.copy() for k, v in unit.host_params.items()}
    wf.run()
    after = unit.host_params
    for name in ("weights", "proj", "bias"):
        assert not numpy.allclose(before[name], after[name]), name
    assert torch.equal(wf.fused_step._params_[0]["proj"].detach(),
                       unit.proj.devmem)
    assert set(wf.gds[0].solver_state) <= {"weights", "proj", "bias"}


def test_workflow_params_from_jax_carries_proj():
    from veles_tpu_torch.convert import workflow_params_from_jax
    wf = _port_workflow(epochs=1)
    layers = [{k: numpy.full_like(v, 0.01 * (i + 1))
               for k, v in f.host_params.items()}
              for i, f in enumerate(wf.forwards)]
    layers[0]["proj"] = numpy.full((D, D), 0.5, numpy.float32)
    velocity = [{k: (numpy.full_like(v, 0.25),) for k, v in layer.items()}
                for layer in layers]
    workflow_params_from_jax(wf, layers, velocity)
    step = wf.fused_step
    assert torch.equal(step._params_[0]["proj"].detach(),
                       torch.full((D, D), 0.5))
    assert torch.equal(step._opt_[0]["proj"][0], torch.full((D, D), 0.25))
    assert numpy.array_equal(wf.forwards[0].host_params["proj"],
                             layers[0]["proj"])
    bad = [dict(layers[0], proj=numpy.zeros((D, D + 1), numpy.float32)),
           layers[1]]
    with pytest.raises(ValueError, match="proj"):
        workflow_params_from_jax(wf, bad)
