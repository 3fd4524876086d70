"""Flash attention (K7-K9) of the port against the JAX package, on the CPU.

The same numpy inputs (``standard_normal * 0.5``, as the JAX package's
tests/test_flash_attention.py makes them) go through the JAX kernels,
run in Pallas interpret mode as that file runs them, and through the
port, whose wrappers take their plain versions for CPU tensors:

- ``flash_fwd_reference`` (out and lse) against ``_flash_fwd_bh``;
- ``flash_dq_reference`` / ``flash_dkv_reference`` against
  ``_flash_bwd_bh``, both given the JAX forward's lse and the same delta;
- the grads of the port's ``flash_attention`` (its autograd Function)
  against ``jax.grad`` of the JAX ``flash_attention``;

without a mask, causal, with windows 1, 5, 64, 100 and 256, at the
geometry where both JAX backward passes are banded (T=256, window 40,
32-row blocks) and at T=7, where the JAX package takes its oracle and
the port its plain versions, the same function.  Tolerances are the
JAX tests' own: 2e-5 forward, 5e-4 grads.  The port's
``attention_reference`` with ``window`` is held against the JAX one.
Head dims 192 and 256, past the CUDA kernels' limit of 128, run on the
CPU as in the JAX package (forward and grads); only a CUDA call raises.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.parallel.ring import attention_reference as jax_reference
from veles_tpu.znicz import flash_attention as jfa
from veles_tpu_torch.parallel.ring import attention_reference
from veles_tpu_torch.znicz import flash_attention as fa

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _mk(b, t, h, d, seed=0, n=3):
    rng = numpy.random.RandomState(seed)
    return tuple((rng.standard_normal((b, t, h, d)) * 0.5).astype(
        numpy.float32) for _ in range(n))


def _bh(x):
    """[B, T, H, D] numpy -> [B * H, T, D]."""
    b, t, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _tensors(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(got, want, tol, what=""):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("causal,window,blocks", [
    (False, None, (128, 64)), (True, None, (128, 64)),
    (True, 1, (64, 64)), (True, 5, (64, 64)), (True, 64, (64, 64)),
    (True, 100, (64, 64)), (True, 256, (64, 64))])
def test_forward_matches_jax_kernel(causal, window, blocks):
    q, k, v = _mk(2, 256, 2, 16, seed=4)
    scale = 1.0 / numpy.sqrt(16.0)
    want_out, want_lse = jfa._flash_fwd_bh(
        jnp.asarray(_bh(q)), jnp.asarray(_bh(k)), jnp.asarray(_bh(v)),
        scale, causal, *blocks, window=window)
    launches = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(*_tensors(q, k, v), causal=causal,
                                      window=window)
    assert fa.flash_attention_fwd.launches == launches   # plain on the CPU
    _close(_bh(out.numpy()), want_out, FWD_TOL, "out")
    _close(lse.numpy(), want_lse, FWD_TOL, "lse")


@pytest.mark.parametrize("causal,window,t,blocks", [
    (False, None, 128, (64, 64)), (True, None, 128, (64, 64)),
    (True, 5, 128, (64, 32)), (True, 64, 128, (64, 32)),
    (True, 100, 128, (64, 32)),
    (True, 40, 256, (32, 32))])       # both backward passes banded
def test_backward_passes_match_jax_kernels(causal, window, t, blocks):
    q, k, v, do = _mk(1, t, 2, 8, seed=5, n=4)
    scale = 1.0 / numpy.sqrt(8.0)
    jq, jk, jv, jdo = (jnp.asarray(_bh(x)) for x in (q, k, v, do))
    out, lse = jfa._flash_fwd_bh(jq, jk, jv, scale, causal, *blocks,
                                 window=window)
    delta = numpy.sum(numpy.asarray(jdo) * numpy.asarray(out), axis=-1)
    want = jfa._flash_bwd_bh(jq, jk, jv, out, lse, jdo, scale, causal,
                             *blocks, delta=jnp.asarray(delta),
                             window=window)
    tq, tk, tv, tdo = _tensors(q, k, v, do)
    tlse, tdelta = _tensors(numpy.asarray(lse), delta)
    kw = dict(causal=causal, window=window)
    dq = fa.flash_attention_dq(tq, tk, tv, tdo, tlse, tdelta, **kw)
    dk, dv = fa.flash_attention_dkv(tq, tk, tv, tdo, tlse, tdelta, **kw)
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        _close(_bh(got.numpy()), w, GRAD_TOL, name)


@pytest.mark.parametrize("causal,window,shape,blocks", [
    (False, None, (1, 128, 2, 8), (64, 64)),
    (True, None, (1, 128, 2, 8), (64, 64)),
    (True, 5, (1, 128, 2, 8), (64, 32)),
    (True, 100, (1, 128, 2, 8), (64, 32)),
    (True, 40, (1, 256, 2, 8), (32, 32)),
    (True, None, (1, 7, 1, 8), (4, 4))])   # untileable: the JAX oracle
def test_grads_match_jax_grad(causal, window, shape, blocks):
    q, k, v = _mk(*shape, seed=1)

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, None, *blocks, window)
        return jnp.sum(jnp.sin(out) * out)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [x.requires_grad_() for x in _tensors(q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad((torch.sin(out) * out).sum(), leaves)
    for g, w, name in zip(got, want, "qkv"):
        _close(g.numpy(), w, GRAD_TOL, "d" + name)


def test_forward_at_untileable_t_matches_jax():
    """T=7: the JAX package falls back to its oracle; the port's plain
    version (and, on the card, the kernel) is the same function."""
    q, k, v = _mk(1, 7, 1, 8, seed=2)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), True, None,
                               4, 4)
    out = fa.flash_attention(*_tensors(q, k, v), causal=True)
    _close(out.numpy(), want, FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [192, 256])
def test_head_dims_past_the_card_limit_match_jax(d, causal):
    """Head dims past ``MAX_HEAD_DIM`` (the CUDA kernels' own limit) on
    the CPU: the forward and the grads through the autograd Function
    against the JAX kernels in interpret mode and ``jax.grad``."""
    assert d > fa.MAX_HEAD_DIM
    q, k, v = _mk(1, 128, 2, d, seed=d)

    def jax_out(q, k, v):
        return jfa.flash_attention(q, k, v, causal, None, 64, 64, None)

    def jax_loss(q, k, v):
        out = jax_out(q, k, v)
        return jnp.sum(jnp.sin(out) * out)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = jax_out(jq, jk, jv)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.requires_grad_() for x in _tensors(q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    _close(out.detach().numpy(), want_out, FWD_TOL, "out")
    got = torch.autograd.grad((torch.sin(out) * out).sum(), leaves)
    for g, w, name in zip(got, want, "qkv"):
        _close(g.numpy(), w, GRAD_TOL, "d" + name)


@pytest.mark.parametrize("window", [None, 1, 5, 64, 100])
def test_attention_reference_matches_jax(window):
    q, k, v = _mk(2, 64, 2, 8, seed=6)
    want = jax_reference(*map(jnp.asarray, (q, k, v)), causal=True,
                         window=window)
    got = attention_reference(*_tensors(q, k, v), causal=True,
                              window=window)
    _close(got.numpy(), want, 1e-5)


def test_strided_views_give_the_contiguous_result():
    """The unit hands q/k/v over as strided views of its packed QKV
    projection; the function does not depend on the layout."""
    rng = numpy.random.RandomState(7)
    qkv = torch.tensor(rng.standard_normal((2, 40, 3 * 16)) * 0.5,
                       dtype=torch.float32)
    views = [x.reshape(2, 40, 2, 8) for x in qkv.split(16, dim=-1)]
    dense = [x.contiguous() for x in views]
    for kw in ({}, {"causal": True, "window": 9}):
        assert torch.equal(fa.flash_attention(*views, **kw),
                           fa.flash_attention(*dense, **kw))


def test_value_errors():
    q, k, v = _tensors(*_mk(1, 16, 1, 8))
    for fn in (fa.flash_attention, fa.flash_attention_fwd,
               fa.flash_fwd_reference, attention_reference):
        with pytest.raises(ValueError, match="causal"):
            fn(q, k, v, causal=False, window=8)
        for w in (0, -3):
            with pytest.raises(ValueError, match=">= 1"):
                fn(q, k, v, causal=True, window=w)
    z = torch.zeros((1, 4, 1, 0))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_fwd(q, k[:, :8], v)
    lse = torch.zeros((1, 16))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_dq(q, k, v, q, lse, lse, window=3)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_dkv(q, k, v, q, lse, lse, window=3)


def test_cpu_calls_launch_nothing():
    q, k, v = (x.requires_grad_() for x in _tensors(*_mk(1, 32, 2, 8)))
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before
    assert q.grad is not None and k.grad is not None and v.grad is not None
