"""The conv family of the port against the JAX package, on the CPU.

Each unit is built in both packages from the same seeds on the same
numpy input (``make_unit`` of tests/test_conv_stack.py: uniform [-1, 1)
NHWC, weights from ``RandomGenerator().seed(13)``):

- ``Conv`` and its activation variants (the four ``CONV_CASES`` of
  tests/test_conv_stack.py, grouping included, and an asymmetric
  padding): initial weights byte-equal; the forward against the JAX
  unit's ``apply`` within 1e-5 and its im2col twin ``apply_numpy``
  within 1e-4 (the JAX test's tolerance; sums of up to 75 products in
  another order); ``GradientDescentConv.backward`` against ``jax.vjp``
  of the JAX unit's apply within 1e-5.
- ``MaxPooling``, ``AvgPooling`` and ``MaxAbsPooling``, unpadded, padded
  symmetrically and past half the window (which ``max_pool2d`` refuses
  and the unit pads itself), forward and vjp within 1e-6.
- ``DropoutForward``: eval is the identity; the train output equals the
  JAX unit's ``apply_train`` bit for bit for the same key (the masks are
  ``jax.random.bernoulli``'s bits); the backward regenerates the mask.
- The activation units: forwards and backwards (the explicit
  derivatives of the JAX units in both, graph mode's) within 1e-5
  (libm's log, tanh and sqrt against XLA's, a few ulps apart).  The
  new All2All members: initial weights byte-equal, forwards within
  1e-6.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

SHAPE = (4, 12, 12, 3)

CONV_CASES = [
    ("Conv", {"n_kernels": 8, "kx": 3, "ky": 3}),
    ("ConvTanh", {"n_kernels": 4, "kx": 5, "ky": 5, "padding": 2}),
    ("ConvStrictRELU", {"n_kernels": 6, "kx": 3, "ky": 3,
                        "sliding": (2, 2), "padding": 1}),
    ("Conv", {"n_kernels": 6, "kx": 3, "ky": 3, "grouping": 3}),
    ("ConvSigmoid", {"n_kernels": 5, "kx": 3, "ky": 2,
                     "padding": (1, 0, 2, 1)}),
    ("ConvRELU", {"n_kernels": 3, "kx": 2, "ky": 4, "sliding": (1, 2)}),
]

POOL_CASES = [
    {"kx": 3, "ky": 3, "sliding": (2, 2)},
    {"kx": 2, "ky": 2},
    {"kx": 3, "ky": 3, "sliding": (2, 2), "padding": 1},
    # padding past half the window, asymmetric
    {"kx": 3, "ky": 2, "sliding": (2, 1), "padding": (1, 2, 2, 0)},
]


def _input(shape=SHAPE, seed=1):
    return numpy.random.RandomState(seed).uniform(-1, 1, shape).astype(
        numpy.float32)


def _jax_unit(name, x, module="veles_tpu.znicz", seed=13, **kwargs):
    import importlib
    from veles_tpu.backends import Device
    from veles_tpu.memory import Array
    from veles_tpu.prng import RandomGenerator
    from veles_tpu.workflow import Workflow
    cls = getattr(importlib.import_module(module), name)
    u = cls(Workflow(name="w"), prng=RandomGenerator().seed(seed), **kwargs)
    u.input = Array(x.copy())
    u.initialize(device=Device(backend="cpu"))
    return u


def _port_unit(name, x, module, seed=13, **kwargs):
    import importlib
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.workflow import Workflow
    cls = getattr(importlib.import_module("veles_tpu_torch.znicz." + module),
                  name)
    u = cls(Workflow(name="w"), prng=RandomGenerator().seed(seed), **kwargs)
    u.input = Array(x.copy())
    u.initialize(device=Device(backend="cpu"))
    return u


def _apply(u, x):
    with torch.no_grad():
        return u.apply(u.params, torch.tensor(x)).numpy()


@pytest.mark.parametrize("name,kwargs", CONV_CASES)
def test_conv_matches_jax(name, kwargs):
    x = _input()
    ju = _jax_unit(name, x, **kwargs)
    tu = _port_unit(name, x, "conv", **kwargs)
    for k, v in tu.host_params.items():
        assert v.tobytes() == numpy.asarray(ju.host_params[k]).tobytes(), k
    assert tu.output.shape == tuple(ju.output.shape)
    jparams = {k: jnp.asarray(v) for k, v in ju.host_params.items()}
    want = numpy.asarray(ju.apply(jparams, jnp.asarray(x)))
    got = _apply(tu, x)
    assert got.shape == want.shape == tu.output_shape_for(x.shape)
    numpy.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(
        got, ju.apply_numpy(ju.host_params, x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,kwargs", CONV_CASES)
def test_conv_backward_is_the_jax_vjp(name, kwargs):
    from veles_tpu_torch.znicz.gd_conv import GradientDescentConv
    x = _input()
    ju = _jax_unit(name, x, **kwargs)
    tu = _port_unit(name, x, "conv", **kwargs)
    gd = GradientDescentConv(tu.workflow, learning_rate=0.0)
    gd.link_forward(tu)
    err = _input(tu.output.shape, seed=2)
    params = {k: jnp.asarray(v) for k, v in ju.host_params.items()}
    _, pull = jax.vjp(lambda p, xx: ju.apply(p, xx), params,
                      jnp.asarray(x))
    g_ref, e_ref = pull(jnp.asarray(err))
    err_in, grads = gd.backward(tu.params, torch.tensor(x), None,
                                torch.tensor(err))
    numpy.testing.assert_allclose(err_in.numpy(), numpy.asarray(e_ref),
                                  rtol=1e-5, atol=1e-5)
    assert sorted(grads) == ["bias", "weights"]
    for k, g in grads.items():
        numpy.testing.assert_allclose(
            g.numpy(), numpy.asarray(g_ref[k]) / x.shape[0],
            rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kwargs", POOL_CASES)
@pytest.mark.parametrize("name", ["MaxPooling", "AvgPooling",
                                  "MaxAbsPooling"])
def test_pooling_matches_jax_values_and_vjp(name, kwargs):
    from veles_tpu_torch.znicz.gd_pooling import GDMaxPooling
    x = _input(seed=4)
    ju = _jax_unit(name, x, **kwargs)
    tu = _port_unit(name, x, "pooling", **kwargs)
    want, pull = jax.vjp(lambda xx: ju.apply({}, xx), jnp.asarray(x))
    got = _apply(tu, x)
    assert got.shape == tuple(want.shape) == tu.output_shape_for(x.shape)
    numpy.testing.assert_allclose(got, numpy.asarray(want), rtol=1e-6,
                                  atol=1e-6)
    err = _input(got.shape, seed=5)
    gd = GDMaxPooling(tu.workflow)
    gd.link_forward(tu)
    err_in, grads = gd.backward({}, torch.tensor(x), None, torch.tensor(err))
    assert grads == {}
    numpy.testing.assert_allclose(err_in.numpy(),
                                  numpy.asarray(pull(jnp.asarray(err))[0]),
                                  rtol=1e-6, atol=1e-6)


def test_maxabs_keeps_sign():
    x = numpy.zeros((1, 2, 2, 1), numpy.float32)
    x[0, :, :, 0] = [[-5, 1], [2, 3]]
    u = _port_unit("MaxAbsPooling", x, "pooling", kx=2, ky=2)
    assert _apply(u, x)[0, 0, 0, 0] == -5


def test_pooling_refuses_the_knobs_it_does_not_port():
    x = _input()
    for knob in ("pool_separable", "pool_bf16"):
        with pytest.raises(NotImplementedError):
            _port_unit("MaxPooling", x, "pooling", kx=2, ky=2, **{knob: True})


@pytest.mark.parametrize("ratio,seed", [(0.5, 0), (0.3, 7), (0.9, 1234)])
def test_dropout_masks_are_jax_bits(ratio, seed):
    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.dropout import DropoutBackward
    x = _input((5, 7, 3, 11), seed=3)
    ju = _jax_unit("DropoutForward", x, dropout_ratio=ratio)
    tu = _port_unit("DropoutForward", x, "dropout", dropout_ratio=ratio)
    assert numpy.array_equal(_apply(tu, x), x)       # eval: the identity
    jkey = jax.random.fold_in(jax.random.key(seed), 3)
    key = prng.fold_in(prng.key(seed), 3)
    assert tuple(numpy.asarray(jax.random.key_data(jkey)).tolist()) == key
    want = numpy.asarray(ju.apply_train({}, jnp.asarray(x), jkey))
    got = tu.apply_train({}, torch.tensor(x), key).numpy()
    assert got.tobytes() == want.tobytes()
    assert tu.last_key == key
    gd = DropoutBackward(tu.workflow)
    gd.link_forward(tu)
    err = _input(x.shape, seed=6)
    err_in, _ = gd.backward({}, torch.tensor(x), None, torch.tensor(err))
    from veles_tpu.znicz.dropout import DropoutBackward as JaxBackward
    jgd = JaxBackward(ju.workflow)
    jgd.link_forward(ju)
    ju._last_key_ = jkey            # what graph mode's forward records
    want = numpy.asarray(jgd.backward({}, jnp.asarray(x), None,
                                      jnp.asarray(err))[0])
    assert err_in.numpy().tobytes() == want.tobytes()


ACTIVATIONS = ["Tanh", "Sigmoid", "RELU", "StrictRELU", "Log", "TanhLog",
               "SinCos"]


@pytest.mark.parametrize("act", ACTIVATIONS + ["Mul"])
def test_activation_units_match_jax(act):
    import importlib
    jmod = importlib.import_module("veles_tpu.znicz.activation")
    x = _input(seed=8) * 4.0
    x[0, 0, 0] = 0.0            # strict RELU's tie: gradient 0.5 in both
    kw = {"factor": 1.5} if act == "Mul" else {}
    ju = _jax_unit("Forward" + act, x, "veles_tpu.znicz.activation", **kw)
    tu = _port_unit("Forward" + act, x, "activation", **kw)
    y = ju.apply({}, jnp.asarray(x))
    numpy.testing.assert_allclose(_apply(tu, x), numpy.asarray(y),
                                  rtol=1e-5, atol=1e-5)
    err = _input(x.shape, seed=9)
    from veles_tpu_torch.znicz import activation
    tgd = getattr(activation, "Backward" + act)(tu.workflow, **kw)
    tgd.link_forward(tu)
    got, grads = tgd.backward({}, torch.tensor(x), torch.tensor(_apply(tu, x)),
                              torch.tensor(err))
    assert grads == {}
    # graph mode's explicit derivatives are the JAX units' (strict RELU's
    # is 0 at the tie, where the fused step's autograd takes 0.5)
    jgd = getattr(jmod, "Backward" + act)(ju.workflow, **kw)
    want = numpy.asarray(jgd.backward({}, jnp.asarray(x), y,
                                      jnp.asarray(err))[0])
    if act == "StrictRELU":
        assert got.numpy()[0, 0, 0, 0] == 0.0
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["All2AllSigmoid", "All2AllRELU",
                                  "All2AllStrictRELU"])
def test_new_all2all_members_match_jax(name):
    x = _input((6, 10))
    ju = _jax_unit(name, x, output_sample_shape=7)
    tu = _port_unit(name, x, "all2all", output_sample_shape=7)
    for k, v in tu.host_params.items():
        assert v.tobytes() == numpy.asarray(ju.host_params[k]).tobytes(), k
    jparams = {k: jnp.asarray(v) for k, v in ju.host_params.items()}
    numpy.testing.assert_allclose(
        _apply(tu, x), numpy.asarray(ju.apply(jparams, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
