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
Head dims 192 and 256 (the kernels' 256 instantiation on the card) run
on the CPU as in the JAX package (forward and grads).

The card's K7, K8 and K9 form every product in 3xTF32 on the tensor
cores and join each streamed tile's sum in f32: a plain-torch emulation
of those sums (TF32 rounding on the bit pattern, the kernels' tiles,
K7's online softmax a key tile at a time) is held against the JAX
kernels within their tolerances (forward 2e-5, grads 5e-4) and against
the plain versions: the forward within 2e-6, the grads within 1e-5 of
max(1, max|plain|).
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
    """Head dims past the kernels' former limit of 128, up to
    ``MAX_HEAD_DIM`` (the 256 instantiation on the card), on the CPU:
    the forward and the grads through the autograd Function against the
    JAX kernels in interpret mode and ``jax.grad``."""
    assert 128 < d <= fa.MAX_HEAD_DIM
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


# -- 3xTF32, as K8 and K9 form their sums on the card -------------------------

#: the kernels' streamed tiles by head-dim tile (csrc/flash_attention.cu,
#: DqPlan / DkvPlan / FwdPlan): the keys K8 sums a tile, the queries K9
#: does, the keys K7 does
_KEY_TILE = {32: 64, 64: 32, 128: 32, 256: 16}
_QUERY_TILE = {32: 64, 64: 32, 128: 32, 256: 16}
_FWD_KEY_TILE = {32: 64, 64: 32, 128: 32, 256: 32}


def _tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero, on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """``a @ b`` in 3xTF32: each operand split as ``hi + lo`` (``hi =
    tf32(x)``, ``lo = tf32(x - hi)``), ``a_lo b_hi + a_hi b_lo`` first,
    then ``a_hi b_hi`` (products of TF32 values are exact in f32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _joined(a, b, tile):
    """``a @ b`` summed a tile of the contraction at a time, from its
    first index on: each tile's 3xTF32 sum joins the f32 total."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], tile):
        acc = acc + _mm3(a[..., k0:k0 + tile], b[..., k0:k0 + tile, :])
    return acc


def _d_tile(d):
    """The head-dim tile (kernel instantiation) that takes head dim d."""
    return min(x for x in (32, 64, 128, 256) if x >= d)


def _emulated_forward(q, k, v, causal, window):
    """out [B * H, T, D] and lse [B * H, T] as the card's K7 sums them:
    q scaled first, S a key tile at a time in 3xTF32, the online softmax
    with the JAX kernel's guards, and each tile's P.V in 3xTF32 joined to
    the f32 total as ``acc * alpha + tile``."""
    bh, t, d = q.shape
    scale = numpy.float32(1.0 / numpy.sqrt(d))
    tile = _FWD_KEY_TILE[_d_tile(d)]
    qs = q * torch.tensor(scale)
    mask = fa._mask(t, causal, window, q.device)
    m = torch.full((bh, t, 1), float("-inf"))
    l_ = torch.zeros((bh, t, 1))
    acc = torch.zeros((bh, t, d))
    for c0 in range(0, t, tile):
        s = _mm3(qs, k[:, c0:c0 + tile].transpose(1, 2))
        if mask is not None:
            s = s.masked_fill(mask[:, c0:c0 + tile], float("-inf"))
        new_m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
        p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - safe_m))
        l_ = l_ * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _mm3(p, v[:, c0:c0 + tile])
        m = new_m
    safe_l = torch.where(l_ == 0, 1.0, l_)
    lse = torch.where(torch.isneginf(m), 0.0, m) + torch.log(safe_l)
    return acc / safe_l, lse[..., 0]


#: the cases of the 3xTF32 emulations: T below, at and past a tile, head
#: dims below a tile, at one and at the 256 instantiation, every mask
_TF32X3_CASES = [
    (1, 7, 16, False, None), (2, 7, 256, True, None),
    (1, 64, 64, False, None), (2, 64, 16, True, 40),
    (1, 64, 256, True, None), (2, 200, 64, True, None),
    (1, 200, 16, True, 40), (1, 200, 256, True, 40),
    (2, 200, 64, False, None)]
_JAX_BLOCKS = {7: (7, 7), 64: (32, 32), 200: (40, 40)}


@pytest.mark.parametrize("b,t,d,causal,window", _TF32X3_CASES)
def test_tf32x3_forward_matches_jax_kernel(b, t, d, causal, window):
    """The emulated K7 sums against the JAX package's ``_fwd_kernel`` in
    interpret mode (``FWD_TOL``) and against the port's plain version
    within 2e-6, on out and lse."""
    q, k, v = _mk(b, t, 2, d, seed=t + d + 1)
    scale = 1.0 / numpy.sqrt(d)
    want = jfa._flash_fwd_bh(*(jnp.asarray(_bh(x)) for x in (q, k, v)),
                             scale, causal, *_JAX_BLOCKS[t], window=window)
    got = _emulated_forward(*_tensors(*map(_bh, (q, k, v))), causal, window)
    ref_out, ref_lse = fa.flash_fwd_reference(*_tensors(q, k, v),
                                              causal=causal, window=window)
    ref = (torch.tensor(_bh(ref_out.numpy())), ref_lse)
    for g, w, r, name in zip(got, want, ref, ("out", "lse")):
        _close(g.numpy(), w, FWD_TOL, name)
        assert float((g - r).abs().max()) <= 2e-6, name


def _emulated_backward(q, k, v, do, lse, delta, causal, window):
    """dq, dk, dv ([B * H, T, D]) as the card's K8 / K9 sum them."""
    d = q.shape[-1]
    scale = 1.0 / numpy.sqrt(d)
    d_tile = _d_tile(d)
    s = _mm3(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    mask = fa._mask(q.shape[1], causal, window, q.device)
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    ds = p * (_mm3(do, v.transpose(1, 2)) - delta[..., None])
    dq = _joined(ds, k, _KEY_TILE[d_tile]) * scale
    dk = _joined(ds.transpose(1, 2), q, _QUERY_TILE[d_tile]) * scale
    dv = _joined(p.transpose(1, 2), do, _QUERY_TILE[d_tile])
    return dq, dk, dv


@pytest.mark.parametrize("b,t,d,causal,window", _TF32X3_CASES)
def test_tf32x3_backward_matches_jax_kernels(b, t, d, causal, window):
    """The emulated K8 / K9 sums against the JAX package's ``_dq_kernel``
    and ``_dkv_kernel`` in interpret mode (``GRAD_TOL``), and against
    the port's plain versions within 1e-5 of max(1, max|plain|)."""
    q, k, v, do = _mk(b, t, 2, d, seed=t + d, n=4)
    blocks = _JAX_BLOCKS[t]
    scale = 1.0 / numpy.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(_bh(x)) for x in (q, k, v, do))
    out, lse = jfa._flash_fwd_bh(jq, jk, jv, scale, causal, *blocks,
                                 window=window)
    delta = numpy.sum(numpy.asarray(jdo) * numpy.asarray(out), axis=-1)
    want = jfa._flash_bwd_bh(jq, jk, jv, out, lse, jdo, scale, causal,
                             *blocks, delta=jnp.asarray(delta),
                             window=window)
    tlse, tdelta = _tensors(numpy.asarray(lse), delta)
    got = _emulated_backward(*_tensors(*map(_bh, (q, k, v, do))), tlse,
                             tdelta, causal, window)
    tq, tk, tv, tdo = _tensors(q, k, v, do)
    kw = dict(causal=causal, window=window)
    plain = (fa.flash_dq_reference(tq, tk, tv, tdo, tlse, tdelta, **kw),) \
        + fa.flash_dkv_reference(tq, tk, tv, tdo, tlse, tdelta, **kw)
    for g, w, ref, name in zip(got, want, plain, ("dq", "dk", "dv")):
        _close(g.numpy(), w, GRAD_TOL, name)
        ref = torch.tensor(_bh(ref.numpy()))
        assert float((g - ref).abs().max()) <= \
            1e-5 * max(1.0, float(ref.abs().max())), name
