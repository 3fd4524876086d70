"""The MNIST slice of the port against the JAX package, on the CPU.

Both packages build the MnistSimple sample (784 → 100 scaled-tanh → 10
softmax, minibatch 60, momentum 0.9, lr 0.03) on the committed digits
fixture cut to 600 train / 200 validation images, from the same seeds
(``prng.get().seed(42)`` for the weights, ``RandomGenerator().seed(3)``
for the loader), with ``precise_gemm`` 0 and 1.  The port's initial
weights equal the JAX ones byte for byte; they are then carried across
with ``convert.workflow_params_from_jax`` all the same.  Two epochs each:

- the minibatch order (indices, padding, sizes, classes) is equal;
- per-epoch n_err of both classes is equal;
- the loss at each epoch end within ``rtol=1e-5``, and the final
  weights within ``atol=2e-6`` (the two differ only in f32 summation
  order: XLA's dot against torch's matmul; measured ~6e-8).

The JAX package's softmax head computes its logits with a plain matmul
whatever ``precise_gemm`` says; the port's runs them through the
compensated GEMM too, which changes the sums only in their last bits.
"""

import numpy
import pytest
import torch

SMALL = {"minibatch_size": 60, "n_train": 600, "n_valid": 200,
         "normalization_type": "range_linear"}
#: the sample's topology, spelled out: another test of the same process
#: may have changed either package's ``root.mnist``
GD = {"learning_rate": 0.03, "weights_decay": 0.0, "gradient_moment": 0.9}
LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
           "<-": GD},
          {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": GD}]
EPOCHS = 2
LOSS_RTOL = 1e-5
WEIGHT_ATOL = 2e-6


def _layers(precise):
    return [dict(layer, **{"->": dict(layer["->"], precise_gemm=precise)})
            for layer in LAYERS]


def _record(wf):
    """Wrap the fused step and the decision of ``wf`` to record the
    minibatch order and the per-epoch numbers."""
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
        rec["epochs"].append((list(decision.epoch_n_err),
                              float(step.loss)))
        epoch_end()

    step.run = run
    decision._on_epoch_end = on_epoch_end
    return rec


def _jax_workflow(precise):
    from veles_tpu import prng
    from veles_tpu.backends import Device
    from veles_tpu.prng import RandomGenerator
    from veles_tpu.znicz.samples import mnist
    prng.get().seed(42)
    wf = mnist.create_workflow(
        loader=dict(SMALL, prng=RandomGenerator().seed(3),
                    prefetch_depth=0),
        decision={"max_epochs": EPOCHS, "silent": True},
        layers=_layers(precise))
    wf.initialize(device=Device(backend="cpu"))
    return wf


def _port_workflow(precise, epochs=EPOCHS, **loader):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import mnist
    prng.get().seed(42)
    wf = mnist.create_workflow(
        layers=_layers(precise),
        loader=dict(SMALL, prng=RandomGenerator().seed(3), **loader),
        decision={"max_epochs": epochs, "silent": True})
    wf.initialize(device=Device(backend="cpu"))
    return wf


@pytest.mark.parametrize("precise", [0, 1])
def test_training_matches_jax(precise):
    from veles_tpu_torch.convert import workflow_params_from_jax
    jwf = _jax_workflow(precise)
    twf = _port_workflow(precise)
    assert jwf.loader.provenance == twf.loader.provenance == "fixture"
    jparams = [{k: numpy.array(v) for k, v in f.host_params.items()}
               for f in jwf.forwards]
    for fwd, want in zip(twf.forwards, jparams):
        for name, value in fwd.host_params.items():
            assert value.tobytes() == want[name].tobytes(), name
    jwf.fused_step.sync_solver_state()
    workflow_params_from_jax(twf, jparams,
                             [gd.solver_state for gd in jwf.gds])
    jrec, trec = _record(jwf), _record(twf)
    jwf.run()
    twf.run()
    assert trec["order"] == jrec["order"]
    # 200 validation images: 3 full minibatches and a padded one of 20
    sizes = [(c, s) for c, s, _ in trec["order"][:4]]
    assert sizes == [(1, 60)] * 3 + [(1, 20)]
    assert trec["order"][3][2][20:] == [trec["order"][3][2][0]] * 40
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
    assert twf.gather_results()["best_validation_error_pt"] == \
        jwf.gather_results()["best_validation_error_pt"]


def test_cpu_run_learns_well_under_chance():
    wf = _port_workflow(0, epochs=4, n_train=1200)
    wf.run()
    res = wf.gather_results()
    # ten classes: chance is 90 % error
    assert res["best_validation_error_pt"] < 25.0, res
    cm = wf.fused_step.confusion_matrix.map_read()
    assert cm.sum() == 4 * (200 + 1200)   # every image of every epoch


def test_precise_gemm_routes_every_matmul_through_k4(monkeypatch):
    """precise_gemm=1: a train step runs five compensated GEMMs (two
    forwards; the head's dx and dW; the first layer's dW, its dx being
    skipped), an eval step two.  On the CPU they take the plain version
    and count no kernel launch."""
    from veles_tpu_torch.znicz import gemm
    wf = _port_workflow(1, epochs=1)
    calls = []
    plain = gemm.precise_matmul_reference

    def counting(a, b, level=1):
        calls.append(wf.loader.minibatch_class)
        return plain(a, b, level)

    monkeypatch.setattr(gemm, "precise_matmul_reference", counting)
    launches = gemm.precise_matmul.launches
    wf.run()
    step = wf.fused_step
    assert (step.train_steps, step.eval_steps) == (10, 4)
    assert calls.count(2) == 5 * step.train_steps
    assert calls.count(1) == 2 * step.eval_steps
    assert gemm.precise_matmul.launches == launches


def test_workflow_params_from_jax_checks_and_reloads():
    from veles_tpu_torch.convert import workflow_params_from_jax
    wf = _port_workflow(0, epochs=1)
    layers = [{k: numpy.full_like(v, 0.01 * (i + 1))
               for k, v in f.host_params.items()}
              for i, f in enumerate(wf.forwards)]
    velocity = [{k: (numpy.full_like(v, 0.5),) for k, v in layer.items()}
                for layer in layers]
    workflow_params_from_jax(wf, layers, velocity)
    step = wf.fused_step
    assert torch.equal(step._params_[1]["weights"].detach(),
                       torch.full((100, 10), 0.02))
    assert torch.equal(step._opt_[0]["bias"][0], torch.full((100,), 0.5))
    with pytest.raises(ValueError):
        workflow_params_from_jax(wf, layers[:1])
    with pytest.raises(ValueError):
        workflow_params_from_jax(wf, layers[::-1])
