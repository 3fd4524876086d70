"""The LRN module of the port against the JAX package, on the CPU.

- The plain versions of K5 and K6 (``lrn_reference``,
  ``lrn_backward_reference``) against the JAX kernel pair
  ``pallas_lrn`` (Pallas interpret mode) and its ``jax.vjp`` (the
  analytic backward), the JAX unit's ``apply_numpy`` and the port's
  band form ``lrn_mxu``: n in {2, 4, 5} (even n has the asymmetric
  window), C in {7, 16, 96}, with the parameters of
  tests/test_conv_stack.py:217-262 (alpha 1e-4 for n = 5, 0.5 for even
  n) and a beta other than 0.75 (the band form's general power).
  Tolerances: values 1e-5, gradients 1e-4 (the JAX test's).  Also rows
  of 1030 and 5000 channels and windows 3, 5 and 7 at alpha 0.5.
- ``lrn`` and ``lrn_backward`` take the plain versions for CPU tensors
  and count no launch; ``lrn_pair``'s backward is K6's plain version
  (the same bits); a tensor on another device raises.
- ``F.local_response_norm`` (chip_smoke's library yardstick) computes
  the same function, the asymmetric window of even n included.
- The unit: ``use_pallas`` True runs the pair, unset the band form on
  the CPU; its forward and vjp match the JAX unit's within 1e-5 / 1e-4.
"""

import numpy
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from veles_tpu_torch.znicz import lrn as tl

CASES = [(n, c, alpha, beta, k)
         for n, alpha in ((5, 1e-4), (2, 0.5), (4, 0.5))
         for c in (7, 16, 96)
         for beta, k in ((0.75, 2.0), (0.6, 1.5))]


def _xg(c, seed=3, shape=(2, 5, 3)):
    rng = numpy.random.RandomState(seed)
    x = rng.randn(*shape, c).astype(numpy.float32)
    g = rng.randn(*shape, c).astype(numpy.float32)
    return x, g


def _jax_unit(**kw):
    from veles_tpu.workflow import Workflow
    from veles_tpu.znicz.lrn import LRNormalizerForward
    return LRNormalizerForward(Workflow(None), **kw)


@pytest.mark.parametrize("n,c,alpha,beta,k", CASES)
def test_plain_pair_matches_pallas_lrn_and_its_vjp(n, c, alpha, beta, k):
    from veles_tpu.znicz.lrn import pallas_lrn
    x, g = _xg(c, seed=n * 100 + c)
    want, pull = jax.vjp(lambda v: pallas_lrn(v, n, alpha, beta, k),
                         jnp.asarray(x))
    (want_dx,) = pull(jnp.asarray(g))
    xt, gt = torch.tensor(x), torch.tensor(g)
    y = tl.lrn_reference(xt, n, alpha, beta, k).numpy()
    dx = tl.lrn_backward_reference(xt, gt, n, alpha, beta, k).numpy()
    numpy.testing.assert_allclose(y, numpy.asarray(want), rtol=1e-5,
                                  atol=1e-5)
    numpy.testing.assert_allclose(dx, numpy.asarray(want_dx), rtol=1e-4,
                                  atol=1e-4)
    unit = _jax_unit(n=n, alpha=alpha, beta=beta, k=k)
    numpy.testing.assert_allclose(y, unit.apply_numpy({}, x), rtol=1e-5,
                                  atol=1e-5)
    numpy.testing.assert_allclose(tl.lrn_mxu(xt, n, alpha, beta, k).numpy(),
                                  y, rtol=1e-5, atol=1e-5)
    # the band form's autograd gives the transposed window too
    xl = xt.clone().requires_grad_(True)
    (band_dx,) = torch.autograd.grad(tl.lrn_mxu(xl, n, alpha, beta, k), xl,
                                     gt)
    numpy.testing.assert_allclose(band_dx.numpy(), dx, rtol=1e-4,
                                  atol=1e-4)


@pytest.mark.parametrize("n,c", [(5, 1030), (7, 1030), (3, 5000)])
def test_plain_pair_matches_pallas_lrn_on_wide_rows(n, c):
    """Rows past 1024 channels (the card's kernels cut them into chunks)
    and a window past 5 (a run-time n there): the plain pair against the
    JAX kernel pair, which takes any C in interpret mode."""
    from veles_tpu.znicz.lrn import pallas_lrn
    x, g = _xg(c, seed=n + c, shape=(3,))
    want, pull = jax.vjp(lambda v: pallas_lrn(v, n, 0.5, 0.75, 2.0),
                         jnp.asarray(x))
    (want_dx,) = pull(jnp.asarray(g))
    xt, gt = torch.tensor(x), torch.tensor(g)
    numpy.testing.assert_allclose(tl.lrn_reference(xt, n, 0.5).numpy(),
                                  numpy.asarray(want), rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(
        tl.lrn_backward_reference(xt, gt, n, 0.5).numpy(),
        numpy.asarray(want_dx), rtol=1e-4, atol=1e-4)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    x, g = _xg(16)
    xt, gt = torch.tensor(x), torch.tensor(g)
    launches = tl.lrn.launches, tl.lrn_backward.launches
    assert torch.equal(tl.lrn(xt, 4, 0.5), tl.lrn_reference(xt, 4, 0.5))
    assert torch.equal(tl.lrn_backward(xt, gt, 4, 0.5),
                       tl.lrn_backward_reference(xt, gt, 4, 0.5))
    xl = xt.clone().requires_grad_(True)
    y = tl.lrn_pair(xl, 4, 0.5)
    assert torch.equal(y.detach(), tl.lrn_reference(xt, 4, 0.5))
    (dx,) = torch.autograd.grad(y, xl, gt)
    assert torch.equal(dx, tl.lrn_backward_reference(xt, gt, 4, 0.5))
    assert (tl.lrn.launches, tl.lrn_backward.launches) == launches
    meta = torch.empty((2, 16), device="meta")
    with pytest.raises(ValueError):
        tl.lrn(meta)
    with pytest.raises(ValueError):
        tl.lrn_backward(meta, meta)
    with pytest.raises(ValueError):
        tl.lrn(xt, 0)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_local_response_norm_is_the_same_function(n):
    x, _ = _xg(20, seed=n)
    xt = torch.tensor(x) * 3.0
    want = tl.lrn_reference(xt, n, 0.3, 0.75, 1.5)
    got = F.local_response_norm(xt.permute(0, 3, 1, 2), n, 0.3, 0.75, 1.5)
    numpy.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                  want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("n", [4, 5])
def test_unit_matches_jax(use_pallas, n):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.workflow import Workflow
    x, g = _xg(16, seed=7, shape=(3, 4, 4))
    kw = {"n": n, "alpha": 0.5 if n == 4 else 1e-4}
    unit = tl.LRNormalizerForward(Workflow(name="w"), use_pallas=use_pallas,
                                  **kw)
    unit.input = Array(x.copy())
    unit.initialize(device=Device(backend="cpu"))
    assert unit._resolved_use_pallas() is bool(use_pallas)
    assert unit.params == {} and unit.output.shape == x.shape
    ju = _jax_unit(use_pallas=False, **kw)
    want, pull = jax.vjp(lambda v: ju.apply({}, v), jnp.asarray(x))
    gd = tl.LRNormalizerBackward(unit.workflow)
    gd.link_forward(unit)
    dx, grads = gd.backward({}, torch.tensor(x), None, torch.tensor(g))
    assert grads == {}
    unit.run()
    numpy.testing.assert_allclose(unit.output.map_read(),
                                  numpy.asarray(want), rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(dx.numpy(),
                                  numpy.asarray(pull(jnp.asarray(g))[0]),
                                  rtol=1e-4, atol=1e-4)
