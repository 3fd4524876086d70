"""The structural units of the port (``veles_tpu_torch.znicz.misc_units``)
against the JAX package's, on the CPU.

Each unit is built in both packages from the same seeds on the same
numpy input (uniform [-1, 1) NHWC, weights from
``RandomGenerator().seed(13)``, as tests/test_conv_stack.py's
``make_unit``):

- the forwards of ``Cutter``, ``ChannelSplitter``, ``ChannelMerger``,
  ``ZeroFiller`` and ``Depooling`` against the JAX units' ``apply``,
  exactly (they move values, they do not compute);
- ``Deconv`` at (k 5, s 1, p 2), (k 4, s 2, p 1) (where the JAX unit's
  declared shape is not the shape it computes), asymmetric and negative
  quad paddings, with and without bias: initial weights byte-equal; the
  forward within 1e-5 of the JAX ``apply``, its shape the JAX unit's
  data shape;
- ``GDCutter`` and ``GDDeconv`` (``err_input`` and the gradients over
  the batch) against the JAX units' ``backward``, and
  ``GenericVJPBackward`` over ``Depooling``, ``ChannelSplitter``,
  ``ChannelMerger`` and ``ZeroFiller`` against the JAX one, within
  1e-5;
- ``ZeroFiller.make_mask`` equal to the JAX unit's, and its graph-mode
  ``run()`` masking a conv's weights on the conv's device;
- the ports of tests/test_conv_stack.py's
  ``test_cutter_and_depooling_shapes`` and
  ``test_deconv_inverts_conv_shape``; the latter holds the output's data
  shape equal to the JAX unit's data shape (the JAX test compares the
  declared shape with itself).
"""

import importlib

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

SHAPE = (4, 12, 12, 3)
ATOL = 1e-5

#: (class, kwargs, input shape) of the paramless units
PARAMLESS_CASES = [
    ("Cutter", {"top": 1, "left": 2, "crop_h": 8, "crop_w": 6}, SHAPE),
    ("ChannelSplitter", {"groups": 3}, (4, 12, 12, 6)),
    ("ChannelMerger", {}, (3, 4, 12, 12, 2)),
    ("ZeroFiller", {"grouping": 2}, SHAPE),
    ("Depooling", {"kx": 3, "ky": 2}, SHAPE),
]

DECONV_CASES = [
    {"n_kernels": 1, "kx": 5, "ky": 5, "padding": 2},
    {"n_kernels": 5, "kx": 4, "ky": 4, "sliding": (2, 2), "padding": 1},
    {"n_kernels": 5, "kx": 3, "ky": 4, "sliding": (2, 1),
     "padding": (0, 3, 2, 1), "include_bias": True},
    {"n_kernels": 4, "kx": 3, "ky": 3, "padding": (-1, 1, 0, 2),
     "include_bias": True},
    {"n_kernels": 2, "kx": 3, "ky": 3, "sliding": (3, 2), "padding": 2,
     "include_bias": True},
]


def _input(shape=SHAPE, seed=1):
    return numpy.random.RandomState(seed).uniform(-1, 1, shape).astype(
        numpy.float32)


def _unit(pkg, name, x, seed=13, **kwargs):
    """``name`` of ``pkg``'s misc_units on input ``x``, initialized on the
    CPU (the JAX device backend on jax's CPU)."""
    mods = {n: importlib.import_module("%s.%s" % (pkg, n)) for n in (
        "backends", "memory", "prng", "workflow", "znicz.misc_units")}
    cls = getattr(mods["znicz.misc_units"], name)
    u = cls(mods["workflow"].Workflow(name="w"),
            prng=mods["prng"].RandomGenerator().seed(seed), **kwargs)
    u.input = mods["memory"].Array(x.copy())
    u.initialize(device=mods["backends"].Device(backend="cpu"))
    return u


def _jax_apply(ju, x):
    params = {k: jnp.asarray(v) for k, v in ju.host_params.items()}
    return numpy.asarray(ju.apply(params, jnp.asarray(x)))


def _apply(u, x):
    with torch.no_grad():
        return u.apply(u.params, torch.tensor(x)).numpy()


@pytest.mark.parametrize("name,kwargs,shape", PARAMLESS_CASES)
def test_paramless_forwards_equal_jax(name, kwargs, shape):
    x = _input(shape)
    ju = _unit("veles_tpu", name, x, **kwargs)
    tu = _unit("veles_tpu_torch", name, x, **kwargs)
    want = _jax_apply(ju, x)
    got = _apply(tu, x)
    assert got.shape == want.shape == tu.output_shape_for(shape) == \
        tuple(ju.output_shape_for(shape))
    assert tu.params == {} and tu.include_bias is False
    numpy.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", DECONV_CASES)
def test_deconv_matches_jax(kwargs):
    x = _input()
    ju = _unit("veles_tpu", "Deconv", x, **kwargs)
    tu = _unit("veles_tpu_torch", "Deconv", x, **kwargs)
    assert sorted(tu.host_params) == sorted(ju.host_params) == (
        ["bias", "weights"] if kwargs.get("include_bias") else ["weights"])
    for k, v in tu.host_params.items():
        assert v.tobytes() == numpy.asarray(ju.host_params[k]).tobytes(), k
    want = _jax_apply(ju, x)
    assert tu.output_shape_for(x.shape) == want.shape
    assert tuple(tu.output.shape) == want.shape
    got = _apply(tu, x)
    assert got.shape == want.shape
    numpy.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


def test_gd_cutter_matches_jax():
    from veles_tpu.znicz.misc_units import GDCutter as JaxGDCutter
    from veles_tpu_torch.znicz.misc_units import GDCutter
    kwargs = PARAMLESS_CASES[0][1]
    x = _input()
    ju = _unit("veles_tpu", "Cutter", x, **kwargs)
    tu = _unit("veles_tpu_torch", "Cutter", x, **kwargs)
    err = _input(tu.output_shape_for(x.shape), seed=2)
    jgd = JaxGDCutter(ju.workflow).link_forward(ju)
    tgd = GDCutter(tu.workflow).link_forward(tu)
    assert tgd.learning_rate == jgd.learning_rate == 0.0
    want, jgrads = jgd.backward({}, jnp.asarray(x), None, jnp.asarray(err))
    got, grads = tgd.backward({}, torch.tensor(x), None, torch.tensor(err))
    assert grads == jgrads == {}
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(want))


@pytest.mark.parametrize("kwargs", DECONV_CASES[1:3])
def test_gd_deconv_matches_jax(kwargs):
    from veles_tpu.znicz.misc_units import GDDeconv as JaxGDDeconv
    from veles_tpu_torch.znicz.misc_units import GDDeconv
    x = _input()
    ju = _unit("veles_tpu", "Deconv", x, **kwargs)
    tu = _unit("veles_tpu_torch", "Deconv", x, **kwargs)
    err = _input(tu.output_shape_for(x.shape), seed=2)
    jgd = JaxGDDeconv(ju.workflow).link_forward(ju)
    tgd = GDDeconv(tu.workflow).link_forward(tu)
    params = {k: jnp.asarray(v) for k, v in ju.host_params.items()}
    want, jgrads = jgd.backward(params, jnp.asarray(x), None,
                                jnp.asarray(err), n_valid=3)
    got, grads = tgd.backward(tu.params, torch.tensor(x), None,
                              torch.tensor(err), n_valid=3)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=ATOL, atol=ATOL)
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(jgrads[k]),
                                      rtol=ATOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,kwargs,shape", PARAMLESS_CASES[1:])
def test_generic_backward_matches_jax(name, kwargs, shape):
    from veles_tpu.znicz.nn_units import GenericVJPBackward as JaxGeneric
    from veles_tpu_torch.znicz.nn_units import GenericVJPBackward
    x = _input(shape)
    ju = _unit("veles_tpu", name, x, **kwargs)
    tu = _unit("veles_tpu_torch", name, x, **kwargs)
    err = _input(tu.output_shape_for(shape), seed=2)
    want, jgrads = JaxGeneric(ju.workflow).link_forward(ju).backward(
        {}, jnp.asarray(x), None, jnp.asarray(err))
    got, grads = GenericVJPBackward(tu.workflow).link_forward(tu).backward(
        {}, torch.tensor(x), None, torch.tensor(err))
    assert grads == jgrads == {}
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  rtol=ATOL, atol=ATOL)


def test_zero_filler_mask_equals_jax_and_run_masks_a_conv():
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.conv import Conv
    x = _input(SHAPE[:3] + (4,))
    ju = _unit("veles_tpu", "ZeroFiller", x, grouping=2)
    tu = _unit("veles_tpu_torch", "ZeroFiller", x, grouping=2)
    for shape in ((3, 3, 4, 6), (5, 5, 6, 9)):
        mask = tu.make_mask(shape)
        numpy.testing.assert_array_equal(mask, ju.make_mask(shape))
        assert 0 < mask.sum() < mask.size
    conv = Conv(Workflow(name="w"), prng=RandomGenerator().seed(13),
                n_kernels=6, kx=3, ky=3)
    conv.input = Array(x.copy())
    conv.initialize(device=Device(backend="cpu"))
    before = conv.weights.map_read().copy()
    tu.target_unit = conv
    tu.run()
    numpy.testing.assert_array_equal(tu.output.map_read(), x)
    after = conv.weights.map_read()
    numpy.testing.assert_array_equal(after, before * tu.make_mask(
        before.shape))
    assert conv.weights.devmem.device == torch.device("cpu")


def test_cutter_and_depooling_shapes():
    """tests/test_conv_stack.py::test_cutter_and_depooling_shapes on the
    port's units (graph-mode ``run``)."""
    x = _input()
    c = _unit("veles_tpu_torch", "Cutter", x, top=1, left=2, crop_h=8,
              crop_w=6)
    c.run()
    assert c.output.shape == (4, 8, 6, 3)
    assert numpy.allclose(c.output.map_read(), x[:, 1:9, 2:8, :])
    d = _unit("veles_tpu_torch", "Depooling", x, kx=2, ky=2)
    d.run()
    assert d.output.shape == (4, 24, 24, 3)


def test_deconv_inverts_conv_shape():
    """tests/test_conv_stack.py::test_deconv_inverts_conv_shape on the
    port's unit: after ``run`` the output's data has the shape
    ``output_shape_for`` gives, and that is the JAX unit's data shape
    (22, where the JAX unit declares 24)."""
    kwargs = {"n_kernels": 5, "kx": 4, "ky": 4, "sliding": (2, 2),
              "padding": 1}
    x = _input()
    u = _unit("veles_tpu_torch", "Deconv", x, **kwargs)
    u.run()
    assert u.output.shape == u.output_shape_for(x.shape) == (4, 22, 22, 5)
    ju = _unit("veles_tpu", "Deconv", x, **kwargs)
    assert tuple(ju.output_shape_for(x.shape)) == (4, 24, 24, 5)
    ju.run()
    assert u.output.map_read().shape == ju.output.map_read().shape
    numpy.testing.assert_allclose(u.output.map_read(),
                                  numpy.asarray(ju.output.map_read()),
                                  rtol=ATOL, atol=ATOL)


def test_jax_deconv_declares_another_shape_than_it_computes():
    """The deviation in the reference the port does not follow:
    ``Deconv.output_shape_for`` (the JAX unit) agrees with its ``apply``
    only where ``pt + pb = k - 1``; the port's follows ``apply``."""
    x = jnp.asarray(_input())
    for kwargs, agree in (({"kx": 5, "ky": 5, "padding": 2}, True),
                          ({"kx": 4, "ky": 4, "sliding": (2, 2),
                            "padding": 1}, False)):
        ju = _unit("veles_tpu", "Deconv", numpy.asarray(x), n_kernels=2,
                   **kwargs)
        computed = jax.eval_shape(lambda v: ju.apply(
            {"weights": jnp.asarray(ju.host_params["weights"])}, v), x)
        declared = tuple(ju.output_shape_for(x.shape))
        assert (tuple(computed.shape) == declared) == agree
        tu = _unit("veles_tpu_torch", "Deconv", numpy.asarray(x),
                   n_kernels=2, **kwargs)
        assert tu.output_shape_for(x.shape) == tuple(computed.shape)
