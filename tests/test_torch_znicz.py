"""The port's znicz building blocks against the JAX package's, on the CPU.

- Every solver's update (and ``regularized_grad``) on the same numpy
  inputs: the JAX package's numpy path against the port's torch path.
  Elementwise f32 arithmetic in the same order rounds alike, so the
  tolerance is one f32 rounding: ``rtol=1e-6``.
- Every activation of the All2All family, and the units themselves as a
  standalone forward (``initialize`` + ``run``) from the same seeds,
  with and without ``precise_gemm``: ``atol=1e-6`` (the matmul sums in
  another order than XLA's dot).
- ``StandardWorkflow`` routes flat layer keys as the JAX one does and
  refuses what the port does not have yet.
"""

import numpy
import pytest
import torch

from veles_tpu.znicz import activations as jact
from veles_tpu.znicz import solvers as jsolvers
from veles_tpu_torch.znicz import activations as tact
from veles_tpu_torch.znicz import solvers as tsolvers

RTOL = 1e-6


def _t(a):
    return torch.from_numpy(numpy.array(a))


@pytest.mark.parametrize("name,hyper", [
    ("sgd", {}), ("momentum", {"momentum": 0.9}), ("adagrad", {}),
    ("adadelta", {"rho": 0.9}), ("rprop", {"eta_plus": 1.3})])
def test_solver_updates_match_jax(name, hyper):
    rng = numpy.random.RandomState(len(name))
    p = rng.standard_normal((7, 5)).astype(numpy.float32)
    js, ts = jsolvers.factory(name, **hyper), tsolvers.factory(name, **hyper)
    j_state, t_state = js.init(p, numpy), ts.init(_t(p))
    for step in range(3):
        g = rng.standard_normal(p.shape).astype(numpy.float32)
        jg = jsolvers.regularized_grad(g, p, 0.01, 0.3, numpy, 0.05)
        tg = tsolvers.regularized_grad(_t(g), _t(p), 0.01, 0.3, 0.05)
        numpy.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL)
        j_delta, j_state = js.update(jg, p, j_state, 0.03, numpy)
        t_delta, t_state = ts.update(tg, _t(p), t_state, 0.03)
        numpy.testing.assert_allclose(t_delta.numpy(), j_delta, rtol=RTOL,
                                      atol=1e-12)
        for a, b in zip(t_state, j_state):
            numpy.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                          atol=1e-12)
        p = (p + j_delta).astype(numpy.float32)
    with pytest.raises(ValueError):
        tsolvers.factory("nope")


@pytest.mark.parametrize("name", ["linear", "tanh"])
def test_activations_match_jax(name):
    x = numpy.linspace(-30, 30, 241).astype(numpy.float32)
    want = numpy.asarray(jact.get(name).fwd_jnp(x))
    got = tact.get(name).fwd(_t(x)).numpy()
    numpy.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("precise", [0, 1])
@pytest.mark.parametrize("cls", ["All2All", "All2AllTanh",
                                 "All2AllSoftmax"])
def test_standalone_all2all_forward_matches_jax(cls, precise):
    """``tests/test_precise_gemm.py``'s opt-in case on both packages:
    the same seeded unit, initialized on the CPU and run once."""
    import importlib
    x = numpy.random.RandomState(3).standard_normal(
        (16, 4, 6)).astype(numpy.float32)
    outs = []
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        Array = importlib.import_module(pkg + ".memory").Array
        Device = importlib.import_module(pkg + ".backends").Device
        prng = importlib.import_module(pkg + ".prng")
        Workflow = importlib.import_module(pkg + ".workflow").Workflow
        unit_cls = getattr(importlib.import_module(pkg + ".znicz.all2all"),
                           cls)
        u = unit_cls(Workflow(name="w"), output_sample_shape=8,
                     precise_gemm=precise,
                     prng=prng.RandomGenerator().seed(4))
        u.input = Array(x.copy())
        u.initialize(device=Device(backend="cpu"))
        u.run()
        outs.append((numpy.array(u.output.map_read()),
                     u.weights.map_read().tobytes()))
    (want, jw), (got, tw) = outs
    assert tw == jw                      # same seeded init, byte for byte
    assert got.shape == want.shape == (16, 8)
    numpy.testing.assert_allclose(got, want, atol=1e-6)


def test_standard_workflow_routes_and_refuses():
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.znicz.samples import mnist
    loader = {"n_train": 120, "n_valid": 60}
    flat = [{"type": "all2all_tanh", "output_sample_shape": 20,
             "learning_rate": 0.1, "gradient_moment": 0.5},
            {"type": "softmax", "output_sample_shape": 10,
             "solver": "sgd"}]
    wf = mnist.create_workflow(loader=loader, layers=flat)
    assert wf.forwards[0].output_sample_shape == (20,)
    assert (wf.gds[0].learning_rate, wf.gds[0].solver.name,
            wf.gds[0].solver.hyper) == (0.1, "momentum", {"momentum": 0.5})
    assert wf.gds[1].solver.name == "sgd"
    wf.initialize(device=Device(backend="cpu"))
    assert wf.forwards[0].weights.shape == (784, 20)
    with pytest.raises(ValueError, match="unknown layer type"):
        mnist.create_workflow(loader=loader,
                              layers=[{"type": "stochastic_pooling",
                                       "kx": 2, "ky": 2}])
    with pytest.raises(NotImplementedError, match="graph mode"):
        mnist.create_workflow(fused=False, loader=loader)
