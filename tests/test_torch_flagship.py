"""The flagship decode face: the PyTorch port against the JAX package.

Both packages initialize from the same numpy seeds, so they hold
identical weights; the port then runs prefill + decode_step (on CPU
tensors, the kernels' plain versions) and the JAX package runs its own
prefill + decode_step (jitted; the Pallas kernels in interpret mode) and
its cache-free greedy oracle.  The prompts are those of
``tests/test_decode_serving.py`` (``RandomState(1)``, vocab 32).

Tolerances: greedy tokens equal; f32 pools and logits
``allclose(atol=1e-5, rtol=1e-5)``; int8 pools: scales
``allclose(atol=1e-6)`` and int8 bytes within 1 of each other (a last-ulp
difference upstream can flip one rounding), tokens equal.  Block 0 is
the trash block: padding positions scatter there in an unspecified
order, so it is left out of every pool comparison.
"""

import functools

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.convert import params_from_jax, params_to_jax
from veles_tpu_torch.znicz.samples import flagship as tf

GEO = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32,
           seed=0)
BS, BUCKET, NB, N_NEW = 4, 8, 4, 6
ROWS = 4
TOL = dict(atol=1e-5, rtol=1e-5)


def _prompts():
    rng = numpy.random.RandomState(1)        # test_decode_serving's mix
    out = []
    for _ in range(ROWS):
        prompt = rng.randint(0, 32, rng.randint(1, 9)).tolist()
        rng.randint(1, 9)                     # its max_new_tokens draw
        out.append(prompt)
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(weight_dtype="f32"):
    return jf.FlagshipDecodeModel(**GEO, weight_dtype=weight_dtype)


def _port_model(weight_dtype="f32", kv_dtype="f32"):
    return tf.FlagshipDecodeModel(**GEO, weight_dtype=weight_dtype,
                                  kv_dtype=kv_dtype, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_forward(heads=2, k=1):
    """The body of JAX's ``generate_reference`` — the dense causal block
    stack, then greedy logits at every position — jitted once over a
    fixed padded length.  Causal attention and the per-token no-drop
    MoE make position i independent of the padding after it."""
    @jax.jit
    def fwd(params, tokens):
        stacked = jf._stacked(params)
        h = params["emb"][tokens][None]
        for i in range(stacked["qkv"].shape[0]):
            h, _, _ = jf._prefill_block(
                jax.tree.map(lambda p: p[i], stacked), h, heads, k)
        return jnp.argmax(h[0] @ params["emb"].T, axis=-1)
    return fwd


def _jax_oracle(params, prompt, n, pad=24):
    tokens = list(prompt)
    for _ in range(n):
        arr = numpy.zeros(pad, numpy.int32)
        arr[:len(tokens)] = tokens
        tokens.append(int(_jax_forward()(params, jnp.asarray(arr))
                          [len(tokens) - 1]))
    return tokens[len(prompt):]


def _raw(t):
    """float8 tensors compare as their bytes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _table():
    return numpy.arange(1, ROWS * NB + 1, dtype=numpy.int32).reshape(ROWS,
                                                                     NB)


def _jax_rollout(params, prompts, kv_dtype="f32"):
    """JAX prefill of every prompt, then N_NEW - 1 batched decode steps.
    -> (tokens per row, k_pools, v_pools, per-step logits)."""
    pre = jax.jit(functools.partial(jf.prefill, heads=2, block_size=BS,
                                    k=1, kv_dtype=kv_dtype))
    dec = jax.jit(functools.partial(jf.decode_step, heads=2, block_size=BS,
                                    k=1, kv_dtype=kv_dtype,
                                    with_logits=True))
    shape = (ROWS * NB + 1, BS, 2, 8)
    kp = tuple(jf._make_kv_pool(shape, kv_dtype) for _ in range(2))
    vp = tuple(jf._make_kv_pool(shape, kv_dtype) for _ in range(2))
    table = _table()
    out, lengths = [], numpy.zeros(ROWS, numpy.int32)
    for r, prompt in enumerate(prompts):
        toks = numpy.zeros(BUCKET, numpy.int32)
        toks[:len(prompt)] = prompt
        first, kp, vp = pre(params, jnp.asarray(toks), len(prompt), kp, vp,
                            jnp.asarray(table[r]))
        out.append([int(first)])
        lengths[r] = len(prompt)
    logits = []
    for _ in range(N_NEW - 1):
        nxt, kp, vp, lg = dec(params, kp, vp, jnp.asarray(table),
                              jnp.asarray(lengths),
                              jnp.asarray([o[-1] for o in out], jnp.int32))
        logits.append(numpy.asarray(lg))
        for r in range(ROWS):
            out[r].append(int(nxt[r]))
        lengths += 1
    return out, kp, vp, logits


def _port_rollout(params, prompts, kv_dtype="f32"):
    """The port's prefill + decode_step over the same schedule."""
    shape = (ROWS * NB + 1, BS, 2, 8)
    kp = tuple(tf._make_kv_pool(shape, kv_dtype, "cpu") for _ in range(2))
    vp = tuple(tf._make_kv_pool(shape, kv_dtype, "cpu") for _ in range(2))
    table = torch.from_numpy(_table())
    out, lengths = [], torch.zeros(ROWS, dtype=torch.int32)
    for r, prompt in enumerate(prompts):
        toks = torch.zeros(BUCKET, dtype=torch.int32)
        toks[:len(prompt)] = torch.tensor(prompt)
        first, kp, vp = tf.prefill(params, toks, len(prompt), kp, vp,
                                   table[r], heads=2, block_size=BS, k=1,
                                   kv_dtype=kv_dtype)
        out.append([int(first)])
        lengths[r] = len(prompt)
    logits = []
    for _ in range(N_NEW - 1):
        nxt, kp, vp, lg = tf.decode_step(
            params, kp, vp, table, lengths,
            torch.tensor([o[-1] for o in out], dtype=torch.int32),
            heads=2, block_size=BS, k=1, kv_dtype=kv_dtype,
            with_logits=True)
        logits.append(lg.numpy())
        for r in range(ROWS):
            out[r].append(int(nxt[r]))
        lengths += 1
    return out, kp, vp, logits


@pytest.fixture(scope="module")
def f32_rollouts():
    jparams = _jax_model().params
    tparams = _port_model().params
    return (_jax_rollout(jparams, _prompts()),
            _port_rollout(tparams, _prompts()))


def test_init_decode_params_equal_to_jax():
    jparams = jf.init_decode_params(**GEO)
    tparams = tf.init_decode_params(**GEO, device="cpu")
    assert sorted(jparams) == sorted(tparams)
    for name, leaf in jparams.items():
        assert tparams[name].dtype == torch.float32
        assert numpy.array_equal(numpy.asarray(leaf), tparams[name].numpy())


@pytest.mark.parametrize("weight_dtype", ["f32", "int8", "fp8"])
def test_params_from_jax_round_trips(weight_dtype):
    jparams = _jax_model(weight_dtype).params
    host = {n: numpy.asarray(p) for n, p in jparams.items()}
    tparams = params_from_jax(host, device="cpu")
    ours = _port_model(weight_dtype).params
    assert sorted(tparams) == sorted(ours)
    for name, t in tparams.items():        # identical weights, bytes too
        assert t.dtype == ours[name].dtype
        assert torch.equal(_raw(t), _raw(ours[name]))
    back = params_to_jax(tparams, fp8_dtype=jnp.float8_e4m3fn)
    for name, arr in host.items():
        assert back[name].dtype == arr.dtype
        assert numpy.array_equal(back[name].view(numpy.uint8),
                                 arr.view(numpy.uint8))


def test_greedy_tokens_match_jax(f32_rollouts):
    (j_tokens, _, _, _), (t_tokens, _, _, _) = f32_rollouts
    jparams = _jax_model().params
    tparams = _port_model().params
    prompts = _prompts()
    assert t_tokens == j_tokens                    # JAX decode_step
    for prompt, toks in zip(prompts, t_tokens):
        assert toks == _jax_oracle(jparams, prompt, N_NEW)
        assert toks == tf.generate_reference(tparams, prompt, N_NEW)
    # and JAX's generate_reference itself, on the shortest prompt
    short = min(prompts, key=len)
    assert (t_tokens[prompts.index(short)][:2]
            == jf.generate_reference(jparams, short, 2))


def test_f32_pools_and_logits_allclose(f32_rollouts):
    (_, jk, jv, jlog), (_, tk, tv, tlog) = f32_rollouts
    for jpool, tpool in zip(jk + jv, tk + tv):
        numpy.testing.assert_allclose(tpool.numpy()[1:],
                                      numpy.asarray(jpool)[1:], **TOL)
    for a, b in zip(tlog, jlog):
        numpy.testing.assert_allclose(a, b, **TOL)


def test_int8_kv_matches_jax():
    jparams = _jax_model().params
    tparams = _port_model().params
    j_tokens, jk, jv, _ = _jax_rollout(jparams, _prompts(), "int8")
    t_tokens, tk, tv, _ = _port_rollout(tparams, _prompts(), "int8")
    assert t_tokens == j_tokens
    for jpool, tpool in zip(jk + jv, tk + tv):
        numpy.testing.assert_allclose(tpool["s"].numpy()[1:],
                                      numpy.asarray(jpool["s"])[1:],
                                      atol=1e-6)
        diff = (tpool["q"].numpy()[1:].astype(numpy.int32)
                - numpy.asarray(jpool["q"])[1:].astype(numpy.int32))
        assert numpy.abs(diff).max() <= 1


@pytest.mark.parametrize("weight_dtype", ["int8", "fp8"])
def test_weight_quantized_tokens_match_jax(weight_dtype):
    jparams = _jax_model(weight_dtype).params
    model = _port_model(weight_dtype)
    prompts = _prompts()[:2]
    for prompt in prompts:
        got = tf.generate_reference(model.params, prompt, 4)
        assert got == _jax_oracle(jparams, prompt, 4)
    # the paged path of the port emits the same tokens
    kp, vp = model.make_pools(ROWS * NB + 1, BS)
    pre, dec = model.prefill_fn(BS), model.decode_fn(BS)
    table = _table()
    for r, prompt in enumerate(prompts):
        toks = numpy.zeros(BUCKET, numpy.int32)
        toks[:len(prompt)] = prompt
        first, kp, vp = pre(toks, len(prompt), kp, vp, table[r])
        tokens, length = [int(first)], len(prompt)
        rows = numpy.zeros((1, NB), numpy.int32)
        rows[0] = table[r]
        for _ in range(3):
            nxt, kp, vp = dec(kp, vp, rows, [length], [tokens[-1]])
            tokens.append(int(nxt[0]))
            length += 1
        assert tokens == _jax_oracle(jparams, prompt, 4)


def test_verify_step_and_prefill_chunk_match_jax(f32_rollouts):
    jparams = _jax_model().params
    tparams = _port_model().params
    prompts = _prompts()
    (_, jk, jv, _), (t_tokens, tk, tv, _) = f32_rollouts
    tk = tuple(p.clone() for p in tk)
    tv = tuple(p.clone() for p in tv)
    lengths = numpy.asarray([len(p) + N_NEW - 1 for p in prompts],
                            numpy.int32)
    fed = numpy.asarray([[t[-1], 3, 5] for t in t_tokens], numpy.int32)
    j_out, jk, jv = jax.jit(functools.partial(
        jf.verify_step, heads=2, block_size=BS, k=1))(
        jparams, jk, jv, jnp.asarray(_table()), jnp.asarray(lengths),
        jnp.asarray(fed))
    t_out, tk, tv = tf.verify_step(
        tparams, tk, tv, torch.from_numpy(_table()),
        torch.from_numpy(lengths), torch.from_numpy(fed), heads=2,
        block_size=BS, k=1)
    assert numpy.array_equal(t_out.numpy(), numpy.asarray(j_out))
    for jpool, tpool in zip(jk + jv, tk + tv):
        numpy.testing.assert_allclose(tpool.numpy()[1:],
                                      numpy.asarray(jpool)[1:], **TOL)
    # chunked prefill of the longest prompt, chunk by chunk
    prompt = max(prompts, key=len)
    shape = (ROWS * NB + 1, BS, 2, 8)
    jkp = tuple(jf._make_kv_pool(shape, "f32") for _ in range(2))
    jvp = tuple(jf._make_kv_pool(shape, "f32") for _ in range(2))
    tkp = tuple(tf._make_kv_pool(shape, "f32", "cpu") for _ in range(2))
    tvp = tuple(tf._make_kv_pool(shape, "f32", "cpu") for _ in range(2))
    chunk = jax.jit(functools.partial(jf.prefill_chunk, heads=2,
                                      block_size=BS, k=1))
    row = _table()[0]
    for start in range(0, len(prompt), 3):
        toks = numpy.zeros(3, numpy.int32)
        piece = prompt[start:start + 3]
        toks[:len(piece)] = piece
        j_tok, jkp, jvp = chunk(jparams, jnp.asarray(toks), start,
                                len(prompt), jkp, jvp, jnp.asarray(row))
        t_tok, tkp, tvp = tf.prefill_chunk(
            tparams, torch.from_numpy(toks), start, len(prompt), tkp, tvp,
            torch.from_numpy(row), heads=2, block_size=BS, k=1)
    assert int(t_tok) == int(j_tok) == t_tokens[prompts.index(prompt)][0]
    for jpool, tpool in zip(jkp + jvp, tkp + tvp):
        numpy.testing.assert_allclose(tpool.numpy()[1:],
                                      numpy.asarray(jpool)[1:], **TOL)


def test_drafter_matches_jax_and_verify_fn_runs_verify_step():
    """The unigram drafter's table is the JAX model's greedy next token
    after every single-token prompt (what JAX's ``_unigram_table``
    computes); the model's verify closure is verify_step (compared with
    JAX's above)."""
    tm = _port_model()
    table = tm._unigram_table().numpy()
    jparams = _jax_model().params
    assert table.tolist() == [_jax_oracle(jparams, [t], 1)[0]
                              for t in range(GEO["vocab"])]
    tokens = numpy.asarray([3, 7, 0, 31], numpy.int32)
    drafts = tm.draft_fn(BS, 2)(None, None, None, None, tokens)
    assert numpy.array_equal(drafts.numpy()[:, 0], table[tokens])
    assert numpy.array_equal(drafts.numpy()[:, 1], table[table[tokens]])
    lengths = numpy.asarray([0, 1, 5, 9], numpy.int32)
    fed = numpy.concatenate([tokens[:, None], drafts.numpy()], axis=1)
    runs = []
    for _ in range(2):
        k_pools, v_pools = tm.make_pools(ROWS * NB + 1, BS)
        runs.append((k_pools, v_pools))
    got = tm.verify_fn(BS, 2)(*runs[0], _table(), lengths, fed)[0]
    want = tf.verify_step(tm.params, *runs[1], torch.from_numpy(_table()),
                          torch.from_numpy(lengths), torch.from_numpy(fed),
                          heads=2, block_size=BS, k=1)[0]
    assert torch.equal(got, want)


def _append_kv_loop(pool, blk, off, vals):
    """The int8 append as it was first written, one position at a time in
    row-major order: the oracle of the batched passes."""
    q, s = pool["q"], pool["s"]
    blocks = blk.reshape(-1).tolist()
    offsets = off.reshape(-1).tolist()
    vals = vals.to(torch.float32).reshape((len(blocks),) + q.shape[2:])
    amax = vals.abs().amax(dim=-1) / 127.0
    for t, (b, o) in enumerate(zip(blocks, offsets)):
        s_old = s[b] if o else torch.zeros_like(s[b])
        s_new = torch.maximum(s_old, amax[t])
        s_safe = torch.where(s_new > 0, s_new, torch.ones_like(s_new))
        ratio = torch.where(s_old > 0, s_old / s_safe,
                            torch.zeros_like(s_old))
        block = torch.clamp(torch.round(
            q[b].to(torch.float32) * ratio[None, :, None]), -127, 127)
        block[o] = torch.clamp(torch.round(vals[t] / s_safe[:, None]),
                               -127, 127)
        q[b] = block.to(torch.int8)
        s[b] = s_new
    return pool


def _append_case(kind):
    """(blk, off) of one call: a decode step (one position per row, a
    padding row in the trash block), a prefill spanning several blocks
    with padding past the prompt, a verify span that writes twice to
    one block, and rows padded into the trash block."""
    if kind == "decode":
        blk = torch.tensor([[3], [0], [5], [2]])
        off = torch.tensor([[2], [0], [0], [3]])
    elif kind == "prefill":
        pos = torch.arange(11)
        row = torch.tensor([4, 6, 1])
        blk = torch.where(pos < 9, row[pos // BS], torch.zeros_like(pos))
        off = pos % BS
    elif kind == "verify":
        pos = torch.tensor([[2, 3, 4], [0, 1, 2]])
        table = torch.tensor([[1, 2], [5, 6]])
        blk = table[torch.arange(2)[:, None], pos // BS]
        off = pos % BS
    else:   # "padded": rows past their capacity scatter into the trash
        pos = torch.tensor([[6, 7, 8, 9], [1, 2, 3, 4]])
        table = torch.tensor([[3, 4], [7, 0]])
        blk = torch.where(pos < 8, table[torch.arange(2)[:, None],
                                         (pos // BS).clamp(max=1)],
                          torch.zeros_like(pos))
        off = pos % BS
    return blk, off


@pytest.mark.parametrize("kind", ["decode", "prefill", "verify", "padded"])
def test_batched_int8_append_equals_the_position_loop(kind):
    """Two appends in a row (the second finds the first's scales) on a
    pool with earlier content: every block but the trash block equals
    the position-by-position loop bit for bit."""
    rng = numpy.random.RandomState(7)
    shape = (9, BS, 2, 8)
    start = {"q": torch.from_numpy(rng.randint(-127, 128, shape)
                                   .astype(numpy.int8)),
             "s": torch.from_numpy(rng.uniform(0, 0.05, (9, 2))
                                   .astype(numpy.float32))}
    blk, off = _append_case(kind)
    got = {k: v.clone() for k, v in start.items()}
    want = {k: v.clone() for k, v in start.items()}
    for scale in (1.0, 3.0):
        vals = torch.from_numpy(
            (rng.standard_normal(tuple(blk.shape) + (2, 8)) * scale)
            .astype(numpy.float32))
        tf._append_kv(got, blk, off, vals, "int8")
        _append_kv_loop(want, blk, off, vals)
    assert torch.equal(got["q"][1:], want["q"][1:])
    assert torch.equal(got["s"][1:], want["s"][1:])
    assert not torch.equal(got["q"][1:], start["q"][1:])
