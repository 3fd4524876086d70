"""Ragged paged attention: the PyTorch port against the JAX package.

The same numpy inputs (from numpy seeds) go through the JAX functions —
the Pallas kernel in interpret mode, as ``tests/test_paged_attention.py``
runs it on the CPU, and its dense reference — and through the port's
``paged_attention``, which on CPU tensors takes its plain version.

Tolerance: ``atol=1e-6, rtol=1e-5`` against both JAX functions, not
bitwise: the JAX kernel itself is not bitwise equal to its reference on
this tree, and the two frameworks sum in other orders.  ``quantize_pool``
must give identical int8 bytes (both round half to even).  The cases
mirror ``tests/test_paged_attention.py``: ragged lengths including 0,
block straddles, single tokens, the trash block poisoned, physical
placement; plus int8 pools and the prefill and verify wrappers.

The CUDA kernel itself runs only on the card; here ``_emulate`` repeats
its arithmetic in plain torch (the plan's split ranges, the online
softmax tile by tile, the merge in split order) and is held to the same
tolerance against the JAX package, past the 227 KB score row the first
CUDA version refused and at a head dim past 256.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.znicz import paged_attention as jpa
from veles_tpu_torch.znicz import paged_attention as tpa

B, H, D = 4, 2, 8
BLOCK, NB, NPOOL = 4, 6, 32
T_MAX = BLOCK * NB
TOL = dict(atol=1e-6, rtol=1e-5)


def _setup(seed=0):
    rng = numpy.random.RandomState(seed)
    q = rng.standard_normal((B, H, D)).astype(numpy.float32)
    kp = rng.standard_normal((NPOOL, BLOCK, H, D)).astype(numpy.float32)
    vp = rng.standard_normal((NPOOL, BLOCK, H, D)).astype(numpy.float32)
    table = numpy.arange(1, B * NB + 1, dtype=numpy.int32).reshape(B, NB)
    return q, kp, vp, table


def _port(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(numpy.ascontiguousarray(a))
               for a in arrays), **kw)
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _jax_kernel():
    """The Pallas kernel, interpret mode on the CPU, jitted once per
    shape so the parametrized cases share one compile."""
    return jax.jit(jpa.paged_attention)


def _jax(fn, *arrays, **kw):
    return numpy.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


@pytest.mark.parametrize("lengths", [
    (1, 2, 3, 5),                          # sub-block raggedness
    (BLOCK, 2 * BLOCK, 3 * BLOCK, T_MAX),  # exact block boundaries
    (BLOCK - 1, BLOCK + 1, T_MAX - 1, 1),  # boundary straddles
    (0, 1, T_MAX, 7),                      # empty padding row mixed in
])
def test_ragged_matches_jax_kernel_and_reference(lengths):
    q, kp, vp, table = _setup(seed=3)
    lv = numpy.asarray(lengths, numpy.int32)
    out = _port(tpa.paged_attention, q, kp, vp, table, lv)
    kernel = _jax(_jax_kernel(), q, kp, vp, table, lv)
    ref = _jax(jpa.paged_attention_reference, q, kp, vp, table, lv)
    numpy.testing.assert_allclose(out, kernel, **TOL)
    numpy.testing.assert_allclose(out, ref, **TOL)
    for b, n in enumerate(lengths):
        if n == 0:                         # padding rows are exact zeros
            assert numpy.array_equal(out[b], numpy.zeros_like(out[b]))


def test_single_block_and_single_token():
    rng = numpy.random.RandomState(13)
    q = rng.standard_normal((2, H, D)).astype(numpy.float32)
    kp = rng.standard_normal((4, BLOCK, H, D)).astype(numpy.float32)
    vp = rng.standard_normal((4, BLOCK, H, D)).astype(numpy.float32)
    table = numpy.asarray([[1], [2]], numpy.int32)
    lengths = numpy.asarray([1, BLOCK], numpy.int32)
    out = _port(tpa.paged_attention, q, kp, vp, table, lengths)
    ref = _jax(jpa.paged_attention_reference, q, kp, vp, table, lengths)
    numpy.testing.assert_allclose(out, ref, **TOL)
    # length 1: attention over one token is exactly that token's V
    numpy.testing.assert_allclose(out[0], vp[1, 0], atol=1e-6)


def test_trash_block_contents_never_leak():
    q, kp, vp, table = _setup(seed=9)
    lengths = numpy.asarray((3, 7, 12, 5), numpy.int32)
    out1 = _port(tpa.paged_attention, q, kp, vp, table, lengths)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e9, -1e9             # poison the trash block
    out2 = _port(tpa.paged_attention, q, kp2, vp2, table, lengths)
    assert numpy.array_equal(out1, out2)
    ref = _jax(jpa.paged_attention_reference, q, kp2, vp2, table, lengths)
    numpy.testing.assert_allclose(out2, ref, **TOL)


def test_physical_placement_is_invisible():
    rng = numpy.random.RandomState(11)
    q, kp, vp, table = _setup(seed=7)
    lengths = numpy.asarray((5, 9, T_MAX, 2), numpy.int32)
    base = _port(tpa.paged_attention, q, kp, vp, table, lengths)
    perm = numpy.concatenate([[0], 1 + rng.permutation(NPOOL - 1)])
    inv = numpy.argsort(perm)
    moved = _port(tpa.paged_attention, q, kp[inv], vp[inv],
                  perm[table].astype(numpy.int32), lengths)
    assert numpy.array_equal(base, moved)


def test_quantize_pool_bytes_identical_to_jax():
    rng = numpy.random.RandomState(5)
    pool = (rng.standard_normal((6, BLOCK, H, D)) * 3).astype(numpy.float32)
    pool[2, :, 1] = 0.0                    # an all-zero (block, head) slice
    q_t, s_t = tpa.quantize_pool(torch.from_numpy(pool))
    q_j, s_j = jpa.quantize_pool(jnp.asarray(pool))
    assert numpy.array_equal(q_t.numpy(), numpy.asarray(q_j))
    assert numpy.array_equal(s_t.numpy(), numpy.asarray(s_j))
    deq = tpa.dequantize_pool(q_t, s_t).numpy()
    assert numpy.array_equal(deq, numpy.asarray(jpa.dequantize_pool(q_j,
                                                                    s_j)))


def test_int8_pools_match_jax_kernel_and_reference():
    q, kp, vp, table = _setup(seed=21)
    kq, ks = (numpy.array(a) for a in jpa.quantize_pool(jnp.asarray(kp)))
    vq, vs = (numpy.array(a) for a in jpa.quantize_pool(jnp.asarray(vp)))
    lengths = numpy.asarray((0, 5, T_MAX, BLOCK + 1), numpy.int32)
    args = (q, kq, vq, table, lengths)
    out = _port(tpa.paged_attention, *args,
                k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    kernel = _jax(_jax_kernel(), *args, k_scales=jnp.asarray(ks),
                  v_scales=jnp.asarray(vs))
    ref = _jax(jpa.paged_attention_reference, *args,
               k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    numpy.testing.assert_allclose(out, kernel, **TOL)
    numpy.testing.assert_allclose(out, ref, **TOL)


def test_prefill_and_verify_wrappers_match_jax():
    q, kp, vp, table = _setup(seed=17)
    chunk = numpy.random.RandomState(2).standard_normal(
        (5, H, D)).astype(numpy.float32)
    row = table[2]
    for start, length in ((0, 3), (4, 9), (8, 11)):
        out = tpa.paged_prefill_attention(
            torch.from_numpy(chunk), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(row), start,
            length).numpy()
        ref = numpy.asarray(jpa.paged_prefill_attention_reference(
            jnp.asarray(chunk), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(row), start, length))
        numpy.testing.assert_allclose(out, ref, **TOL)
    span = numpy.random.RandomState(3).standard_normal(
        (B, 3, H, D)).astype(numpy.float32)
    lengths = numpy.asarray((0, 2, 9, T_MAX - 3), numpy.int32)
    out = _port(tpa.paged_verify_attention, span, kp, vp, table, lengths)
    ref = _jax(jpa.paged_verify_attention_reference, span, kp, vp, table,
               lengths)
    numpy.testing.assert_allclose(out, ref, **TOL)
    assert numpy.array_equal(out[0], numpy.zeros_like(out[0]))


def test_required_blocks():
    for n in (1, 4, 5, 16, 17):
        assert tpa.required_blocks(n, 4) == jpa.required_blocks(n, 4)


def test_argument_checks_follow_the_jax_package():
    q, kp, vp, table = _setup()
    t = {n: torch.from_numpy(a) for n, a in
         (("q", q), ("kp", kp), ("vp", vp), ("table", table))}
    lengths = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError):        # head layout mismatch
        tpa.paged_attention(t["q"], t["kp"][:, :, :1], t["vp"][:, :, :1],
                            t["table"], lengths)
    with pytest.raises(ValueError):        # pool shapes differ
        tpa.paged_attention(t["q"], t["kp"], t["vp"][:4], t["table"],
                            lengths)
    kq, ks = tpa.quantize_pool(t["kp"])
    with pytest.raises(ValueError):        # int8 pools without scales
        tpa.paged_attention(t["q"], kq, kq, t["table"], lengths)
    with pytest.raises(ValueError):        # scales with f32 pools
        tpa.paged_attention(t["q"], t["kp"], t["vp"], t["table"], lengths,
                            k_scales=ks, v_scales=ks)
    with pytest.raises(ValueError):        # mixed pool dtypes
        tpa.paged_attention(t["q"], kq, t["vp"], t["table"], lengths,
                            k_scales=ks, v_scales=ks)
    with pytest.raises(ValueError):        # scales of the wrong shape
        tpa.paged_attention(t["q"], kq, kq, t["table"], lengths,
                            k_scales=ks[:3], v_scales=ks)


# -- the kernel's arithmetic, emulated ----------------------------------------

def _emulate(q, kp, vp, table, lengths, plan, k_scales=None,
             v_scales=None):
    """K1/K2's arithmetic in plain torch: each (row, head) split into
    ``plan.split`` ranges of ``plan.blocks_per_split`` blocks; in each, an
    online softmax over tiles of ``plan.tile`` tokens (running max m, sum
    l and accumulator rescaled tile by tile; a tile with no valid token
    is never visited); then split 1 normalizes, and more splits merge in
    split order: sum_s acc_s * exp(m_s - M) / sum_s l_s * exp(m_s - M)."""
    b, h, d = q.shape
    bs, nb = kp.shape[1], table.shape[1]
    per = plan.blocks_per_split * bs
    k, v = (p[table.long()].to(torch.float32) for p in (kp, vp))
    if k_scales is not None:     # float(int8) * scale[physical block, head]
        k = k * k_scales[table.long()][:, :, None, :, None]
        v = v * v_scales[table.long()][:, :, None, :, None]
    pad = plan.split * per - nb * bs
    k, v = (torch.nn.functional.pad(
        x.reshape(b, nb * bs, h, d).permute(0, 2, 1, 3), (0, 0, 0, pad))
        .reshape(b, h, plan.split, per, d) for x in (k, v))
    qs = q.to(torch.float32) * (1.0 / math.sqrt(d))
    length = lengths.long().clamp(0, nb * bs)
    count = (length[:, None] - torch.arange(plan.split)[None, :] * per
             ).clamp(0, per)[:, None, :]                 # [B, 1, S]
    m = torch.full((b, h, plan.split), float("-inf"))
    l = torch.zeros((b, h, plan.split))
    acc = torch.zeros((b, h, plan.split, d))
    for t0 in range(0, per, plan.tile):
        sl = slice(t0, min(t0 + plan.tile, per))
        pos = torch.arange(sl.start, sl.stop)
        valid = pos[None, None, None, :] < count[..., None]
        seen = count > t0                                # tile visited
        sc = (k[:, :, :, sl] * qs[:, :, None, None]).sum(-1)
        sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
        m_new = torch.where(seen, torch.maximum(m, sc.amax(-1)), m)
        alpha = torch.where(seen, torch.exp(m - m_new), torch.ones_like(m))
        p = torch.where(valid, torch.exp(sc - m_new[..., None]),
                        torch.zeros_like(sc))
        acc = acc * alpha[..., None] + (p[..., None] * v[:, :, :, sl]).sum(3)
        l = l * alpha + p.sum(-1)
        m = m_new
    if plan.split == 1:
        return acc[:, :, 0] / torch.where(l == 0, torch.ones_like(l),
                                          l)[:, :, 0, None]
    big = m.amax(-1, keepdim=True)
    w = torch.where(torch.isneginf(m), torch.zeros_like(m),
                    torch.exp(m - torch.where(torch.isneginf(big),
                                              torch.zeros_like(big), big)))
    num = acc[:, :, 0] * w[:, :, 0, None]
    den = l[:, :, 0] * w[:, :, 0]
    for s_ in range(1, plan.split):                      # split order
        num = num + acc[:, :, s_] * w[:, :, s_, None]
        den = den + l[:, :, s_] * w[:, :, s_]
    return num / torch.where(den == 0, torch.ones_like(den), den)[..., None]


#: plans beside the planned one: splits of 2 and 3 blocks, tiles that
#: straddle blocks (3, 5 tokens) and cut them (1, 2)
FORCED = [tpa.PagedPlan(3, 2, 3), tpa.PagedPlan(2, 3, 5),
          tpa.PagedPlan(6, 1, 1), tpa.PagedPlan(1, NB, 2)]


def _planned(b, h, d, quant=False):
    return tpa.paged_attention_plan(b, h, d, BLOCK, NB, 132, quantized=quant)


@functools.lru_cache(maxsize=None)
def _jax_pair(lengths, seed, quant):
    """(inputs, kernel out, reference out) of the JAX package, once a
    case: the Pallas kernel in interpret mode and the dense reference."""
    q, kp, vp, table = _setup(seed=seed)
    lv = numpy.asarray(lengths, numpy.int32)
    kw, jkw = {}, {}
    if quant:
        kp, ks = (numpy.array(a) for a in jpa.quantize_pool(jnp.asarray(kp)))
        vp, vs = (numpy.array(a) for a in jpa.quantize_pool(jnp.asarray(vp)))
        kw = {"k_scales": ks, "v_scales": vs}
        jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    args = (q, kp, vp, table, lv)
    return (args, kw, _jax(_jax_kernel(), *args, **jkw),
            _jax(jpa.paged_attention_reference, *args, **jkw))


def _emulated(args, kw, plan):
    t = [torch.from_numpy(numpy.ascontiguousarray(a)) for a in args]
    tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    return _emulate(*t, plan, **tkw).numpy()


@pytest.mark.parametrize("plan", [None] + FORCED, ids=lambda p: str(
    tuple(p)) if p else "planned")
@pytest.mark.parametrize("lengths", [
    (1, 2, 3, 5),
    (BLOCK, 2 * BLOCK, 3 * BLOCK, T_MAX),
    (BLOCK - 1, BLOCK + 1, T_MAX - 1, 1),
    (0, 1, T_MAX, 7),
])
def test_kernel_arithmetic_matches_jax(lengths, plan):
    """The emulated kernel (planned: one split, one tile; forced: split
    ranges and tiles that cut and straddle blocks) against the Pallas
    kernel in interpret mode and the dense reference."""
    args, kw, kernel, ref = _jax_pair(lengths, 3, False)
    out = _emulated(args, kw, plan or _planned(B, H, D))
    numpy.testing.assert_allclose(out, kernel, **TOL)
    numpy.testing.assert_allclose(out, ref, **TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert numpy.array_equal(out[b], numpy.zeros_like(out[b]))


@pytest.mark.parametrize("plan", [None] + FORCED, ids=lambda p: str(
    tuple(p)) if p else "planned")
def test_kernel_arithmetic_int8_matches_jax(plan):
    args, kw, kernel, ref = _jax_pair((0, 5, T_MAX, BLOCK + 1), 21, True)
    out = _emulated(args, kw, plan or _planned(B, H, D, quant=True))
    numpy.testing.assert_allclose(out, kernel, **TOL)
    numpy.testing.assert_allclose(out, ref, **TOL)


def _long_case(b, h, d, bs, nb, lengths, seed, quant):
    rng = numpy.random.RandomState(seed)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, h, d)).astype(numpy.float32)
    kp = rng.standard_normal((n_pool, bs, h, d)).astype(numpy.float32)
    vp = rng.standard_normal((n_pool, bs, h, d)).astype(numpy.float32)
    table = (1 + rng.permutation(n_pool - 1)).reshape(b, nb).astype(
        numpy.int32)
    kw = {}
    if quant:
        kp, ks = (numpy.array(a) for a in jpa.quantize_pool(jnp.asarray(kp)))
        vp, vs = (numpy.array(a) for a in jpa.quantize_pool(jnp.asarray(vp)))
        kw = {"k_scales": ks, "v_scales": vs}
    args = (q, kp, vp, table, numpy.asarray(lengths, numpy.int32))
    ref = _jax(jpa.paged_attention_reference, *args,
               **{n: jnp.asarray(a) for n, a in kw.items()})
    return args, kw, ref


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_arithmetic_past_the_old_score_row_limit(quant):
    """65536 tokens in a row at H=1, D=8, bs=64, nb=1024: the dense score
    row a dense-softmax kernel keeps in shared memory (256 KB) is past the
    card's 227 KB; the plan splits the row into 256 ranges."""
    b, h, d, bs, nb = 2, 1, 8, 64, 1024
    plan = tpa.paged_attention_plan(b, h, d, bs, nb, 132, quantized=quant)
    assert plan.split > 1 and nb * bs * 4 > 232448
    args, kw, ref = _long_case(b, h, d, bs, nb, [nb * bs, 30001], 31, quant)
    numpy.testing.assert_allclose(_emulated(args, kw, plan), ref, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_arithmetic_at_head_dim_320(quant):
    args, kw, ref = _long_case(3, 2, 320, BLOCK, NB, [0, 5, T_MAX], 32,
                               quant)
    for plan in (_planned(3, 2, 320, quant), tpa.PagedPlan(3, 2, 3)):
        numpy.testing.assert_allclose(_emulated(args, kw, plan), ref,
                                      **TOL)


def test_plan_is_a_function_of_static_shapes():
    """The plan takes shapes and the SM count, never lengths: one launch
    at the main path's table (16 blocks of 16), a split past it; the
    splits cover the table and none is empty of blocks."""
    main = (16, 4, 16, 16, 16)
    assert tpa.paged_attention_plan(*main, 132).split == 1
    assert tpa.paged_attention_plan(*main, 132, quantized=True).split == 1
    for quant in (False, True):
        for shape in ((2, 8, 128, 16, 4096), (32, 8, 128, 16, 128),
                      (2, 2, 8, 1, 60000)):
            plan = tpa.paged_attention_plan(*shape, 132, quantized=quant)
            nb = shape[-1]
            assert plan.split > 1
            assert plan.split * plan.blocks_per_split >= nb
            assert (plan.split - 1) * plan.blocks_per_split < nb
            assert plan == tpa.paged_attention_plan(*shape, 132,
                                                    quantized=quant)
