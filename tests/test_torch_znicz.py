"""The port's znicz building blocks against the JAX package's, on the CPU.

- Every solver's update (and ``regularized_grad``) on the same numpy
  inputs: the JAX package's numpy path against the port's torch path.
  Elementwise f32 arithmetic in the same order rounds alike, so the
  tolerance is one f32 rounding: ``rtol=1e-6``.
- Every activation of the All2All family, and the units themselves as a
  standalone forward (``initialize`` + ``run``) from the same seeds,
  with and without ``precise_gemm``: ``atol=1e-6`` (the matmul sums in
  another order than XLA's dot).
- ``StandardWorkflow`` routes flat layer keys as the JAX one does,
  refuses what the port does not have yet, and builds graph mode's
  unit chain.
- ``ResizableAll2All`` (mirroring ``tests/test_znicz_core.py::
  test_resizable_all2all_resets_output``): after ``resize`` grows or
  shrinks the unit, ``output`` has the new width, the kept columns are
  the old ones bit for bit, and the weights, the bias and the forward
  (plain and ``precise_gemm``) equal the JAX unit's resized alike.  In
  ``StandardWorkflow`` the layer gets ``GenericVJPBackward``, where the
  JAX workflow refuses it (it registers no GD unit for the MAPPING);
  two fused epochs of the MNIST sample train to the JAX workflow's
  weights (within ``WEIGHT_ATOL``, ``tests/test_torch_mnist.py``'s
  limit, n_err equal) when the JAX workflow is given the same fallback,
  and to the port's own ``all2all`` layer's bit for bit; two epochs of
  graph mode to the JAX graph mode's ``all2all`` layer's.
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
                                 "All2AllSoftmax", "ResizableAll2All"])
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
    # stochastic pooling resolves to its forward and GD pair; a type
    # nothing registers still raises
    from veles_tpu_torch.znicz.gd_pooling import GDStochasticPooling
    from veles_tpu_torch.znicz.pooling import StochasticPooling
    sp = mnist.create_workflow(loader=loader,
                               layers=[{"type": "stochastic_pooling",
                                        "kx": 2, "ky": 2}] + flat)
    assert type(sp.forwards[0]) is StochasticPooling
    assert type(sp.gds[0]) is GDStochasticPooling
    assert (sp.forwards[0].kx, sp.forwards[0].ky) == (2, 2)
    with pytest.raises(ValueError, match="unknown layer type"):
        mnist.create_workflow(loader=loader,
                              layers=[{"type": "no_such_pooling",
                                       "kx": 2, "ky": 2}])
    # graph mode builds the unit chain: the forwards, the evaluator on
    # the last one, the decision, the GD units reversed behind the
    # train gate, the first layer's without err_input
    from veles_tpu_torch.loader import TRAIN, VALID
    from veles_tpu_torch.znicz.evaluator import EvaluatorSoftmax
    g = mnist.create_workflow(fused=False, loader=loader, layers=flat)
    assert g.fused_step is None
    assert isinstance(g.evaluator, EvaluatorSoftmax)
    assert g.evaluator in g.forwards[-1].links_to
    assert g.decision in g.evaluator.links_to
    assert list(g.decision.links_to) == [g.gds[1]]
    assert list(g.gds[1].links_to) == [g.gds[0]]
    assert g.repeater in g.gds[0].links_to
    assert g.gds[1].err_output is g.evaluator.err_output
    assert g.gds[0].err_output is g.gds[1].err_input
    assert (g.gds[0].need_err_input, g.gds[1].need_err_input) == (False,
                                                                   True)
    g.initialize(device=Device(backend="cpu"))
    for cls, skipped in ((TRAIN, False), (VALID, True)):
        g.loader.minibatch_class = cls
        assert [bool(gd.gate_skip) for gd in g.gds] == [skipped] * 2


WEIGHT_ATOL = 2e-6


def _resizable(pkg, precise):
    import importlib
    Array = importlib.import_module(pkg + ".memory").Array
    Device = importlib.import_module(pkg + ".backends").Device
    prng = importlib.import_module(pkg + ".prng")
    Workflow = importlib.import_module(pkg + ".workflow").Workflow
    cls = importlib.import_module(pkg + ".znicz.all2all").ResizableAll2All
    unit = cls(Workflow(name="resize"), output_sample_shape=8,
               precise_gemm=precise, prng=prng.RandomGenerator().seed(7))
    x = numpy.random.RandomState(2).standard_normal(
        (4, 6)).astype(numpy.float32)
    unit.input = Array(x)
    unit.initialize(device=Device(backend="cpu"))
    return unit


@pytest.mark.parametrize("precise", [0, 1])
def test_resizable_all2all_resizes_as_jax(precise):
    units = [_resizable(pkg, precise)
             for pkg in ("veles_tpu", "veles_tpu_torch")]
    assert units[1].output.shape == (4, 8)
    for width in (12, 5, 9):
        old = [numpy.array(u.weights.map_read()) for u in units]
        old_b = [numpy.array(u.bias.map_read()) for u in units]
        for u in units:
            u.resize(width)
        (jw, jb), (w, b) = ((numpy.asarray(u.weights.map_read()),
                             numpy.asarray(u.bias.map_read()))
                            for u in units)
        assert units[1].output.shape == (4, width)
        assert units[1].neurons_number == width
        assert w.shape == (6, width) and b.shape == (width,)
        keep = min(old[1].shape[1], width)
        assert w[:, :keep].tobytes() == old[1][:, :keep].tobytes()
        assert b[:keep].tobytes() == old_b[1][:keep].tobytes()
        assert w.tobytes() == jw.tobytes() and b.tobytes() == jb.tobytes()
        for u in units:
            u.run()
        want = numpy.asarray(units[0].output.map_read())
        got = units[1].output.map_read()
        assert got.shape == want.shape == (4, width)
        numpy.testing.assert_allclose(got, want, atol=1e-6)
    assert units[1].export_params() == units[0].export_params()


def _resizable_workflow(pkg, layer="all2all_resizable", fused=True,
                        epochs=2):
    import importlib
    mnist = importlib.import_module(pkg + ".znicz.samples.mnist")
    prng = importlib.import_module(pkg + ".prng")
    Device = importlib.import_module(pkg + ".backends").Device
    prng.get().seed(42)
    gd = {"learning_rate": 0.01, "gradient_moment": 0.9}
    loader = {"n_train": 300, "n_valid": 100,
              "prng": prng.RandomGenerator().seed(3)}
    if pkg == "veles_tpu":
        loader["prefetch_depth"] = 0
    wf = mnist.create_workflow(
        fused=fused, loader=loader,
        decision={"max_epochs": epochs, "silent": True},
        layers=[{"type": layer, "->": {
                     "output_sample_shape": 24}, "<-": dict(gd)},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": dict(gd)}])
    wf.initialize(device=Device(backend="cpu"))
    return wf


def jax_generic_fallback(monkeypatch):
    """The JAX workflow given the port's rule: ``all2all_resizable``
    without a GD unit of its own gets ``GenericVJPBackward``."""
    from veles_tpu.znicz import standard_workflow as jsw
    from veles_tpu.znicz.nn_units import GenericVJPBackward
    find = jsw._find_pair

    def find_pair(type_name):
        fwd, gd = find(type_name)
        if type_name == "all2all_resizable" and gd is None:
            gd = GenericVJPBackward
        return fwd, gd
    monkeypatch.setattr(jsw, "_find_pair", find_pair)


@pytest.mark.parametrize("fused", [True, False])
def test_resizable_all2all_trains_in_standard_workflow(fused, monkeypatch):
    """Fused: against the JAX workflow given the port's fallback, and the
    port's ``all2all`` layer bit for bit.  Graph mode: the JAX
    ``GenericVJPBackward`` hands the vjp no parameters, so the JAX side
    is its ``all2all`` layer (the same linear layer, its GD unit's
    explicit gradient)."""
    with pytest.raises(ValueError, match="no GD unit registered for "
                       "parameterized layer 'all2all_resizable'"):
        _resizable_workflow("veles_tpu", fused=fused)
    jax_generic_fallback(monkeypatch)
    jwf = _resizable_workflow(
        "veles_tpu", "all2all_resizable" if fused else "all2all", fused)
    wf = _resizable_workflow("veles_tpu_torch", fused=fused)
    assert [type(g).__name__ for g in wf.gds] == ["GenericVJPBackward",
                                                   "GDSoftmax"]
    assert type(wf.forwards[0]).__name__ == "ResizableAll2All"
    before = numpy.array(wf.forwards[0].weights.map_read())
    assert before.tobytes() == numpy.asarray(
        jwf.forwards[0].weights.map_read()).tobytes()
    jwf.run()
    wf.run()
    assert wf.decision.epoch_n_err == jwf.decision.epoch_n_err
    for f, jf in zip(wf.forwards, jwf.forwards):
        for k, want in jf.host_params.items():
            want = numpy.asarray(want)
            got = f.host_params[k]
            assert numpy.abs(got - want).max() <= WEIGHT_ATOL, k
    assert numpy.abs(wf.forwards[0].weights.map_read() - before).max() > 0
    if not fused:
        return
    # the linear All2All's training, bit for bit
    plain = _resizable_workflow("veles_tpu_torch", "all2all")
    plain.run()
    for f, pf in zip(wf.forwards, plain.forwards):
        for k, want in pf.host_params.items():
            assert f.host_params[k].tobytes() == want.tobytes(), k
