"""Prefix caching and chunked prefill of the port's scheduler, held against
the JAX package.

Mirrors ``tests/test_prefix_kv.py`` (its migration, checkpoint and
warm-restart tests wait for their modules) with the port's
``DecodeScheduler``, ``KVBlockPool`` and ``ToyDecodeModel`` on
``device="cpu"`` (the kernels' plain versions), and the same
numpy-seeded inputs through the JAX package:

- ``key_chain`` commits to the whole prefix and gives the JAX keys;
- the pool keeps free + private + shared + cached an exact partition
  under random churn, refuses misuse and evicts its cache LRU-first,
  with a dump equal to the JAX pool's after every operation;
- the toy's step functions equal the JAX toy's bit for bit;
- chunked prefill emits the oracle's tokens (toy: ``generate_reference``
  of both packages; flagship f32: the JAX package's cache-free forward;
  flagship int8: the JAX ``DecodeScheduler`` under the same options) and
  interleaves a short request's first token with a long prefill;
- with every option off the scheduler is the core scheduler: the JAX
  core scheduler's tokens and pool bytes; ``"auto"`` for an option
  (refused until ROADMAP queue A item 3 ported the tuner) resolves as
  the JAX scheduler resolves it, tokens the oracle's;
- prefix reuse, multi-turn resubmission and churn over a tight pool
  keep every sequence's tokens bitwise;
- ``GET /api/<model>/kv`` serves a dump that ``tools/kv_inspect.py``
  verifies, integrity list empty.

Tolerances: toy tokens bitwise equal; flagship greedy tokens equal; f32
pools and ``logits_fn`` within 1e-5; int8 pool bytes within 1 of the JAX
package's (a last-ulp difference upstream can flip one rounding), and
bitwise equal between a chunked and a one-call append in the port.
"""

import functools
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.serving import DecodeScheduler as JaxScheduler
from veles_tpu.serving import KVBlockPool as JaxPool
from veles_tpu.serving import ToyDecodeModel as JaxToy
from veles_tpu.serving.kvcache import key_chain as jax_key_chain
from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.serving import (DecodeScheduler, InferenceServer,
                                     KVBlockPool, ToyDecodeModel,
                                     key_chain, required_blocks)
from veles_tpu_torch.znicz.samples import flagship as tf

GEOM = dict(max_batch=3, block_size=4, max_prompt_len=16,
            max_new_tokens=8)
PREFIX = dict(prefix_caching=True, prefill_chunk_tokens=4)
FLAG = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32)
FLAG_GEOM = dict(max_batch=3, block_size=4, max_prompt_len=12,
                 max_new_tokens=6)


@pytest.fixture(scope="module")
def toy():
    return ToyDecodeModel(vocab=31, device="cpu")


def _oracle(prompt, n, vocab=31):
    """The toy's host oracle, the same in both packages."""
    want = ToyDecodeModel(vocab=vocab, device="cpu").generate_reference(
        prompt, n)
    assert want == JaxToy(vocab=vocab).generate_reference(prompt, n)
    return want


@functools.lru_cache(maxsize=None)
def _jax_forward(seed):
    """The JAX package's dense causal block stack with greedy logits at
    every position (the body of its cache-free ``generate_reference``),
    jitted once over a padded length."""
    params = jf.init_decode_params(**FLAG, seed=seed)

    @jax.jit
    def fwd(tokens):
        stacked = jf._stacked(params)
        h = params["emb"][tokens][None]
        for i in range(stacked["qkv"].shape[0]):
            h, _, _ = jf._prefill_block(
                jax.tree.map(lambda p: p[i], stacked), h, 2, 1)
        return jnp.argmax(h[0] @ params["emb"].T, axis=-1)
    return fwd


def _jax_oracle(prompt, n, seed=0):
    tokens = list(prompt)
    for _ in range(n):
        arr = numpy.zeros(24, numpy.int32)
        arr[:len(tokens)] = tokens
        tokens.append(int(_jax_forward(seed)(jnp.asarray(arr))
                          [len(tokens) - 1]))
    return tokens[len(prompt):]


def _run(sched, requests, serial=False):
    """Tokens of ``requests`` ((prompt, n) pairs), submitted at once or
    one after another; the scheduler is closed afterwards."""
    try:
        if serial:
            return [sched.generate(p, n, timeout=120)["tokens"]
                    for p, n in requests]
        futures = [sched.submit(p, n) for p, n in requests]
        return [f.result(120)["tokens"] for f in futures]
    finally:
        sched.close(drain=True)


def _jax_scheduler_tokens(model, requests, serial=False, **kwargs):
    return _run(JaxScheduler(model, name="jax", cache=False, **kwargs),
                requests, serial)


# -- key chain ----------------------------------------------------------------

def test_key_chain_commits_to_whole_prefix():
    ks = key_chain([1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
    assert len(ks) == 2                       # trailing partial unkeyed
    assert ks == key_chain([1, 2, 3, 4, 5, 6, 7, 8], 4)
    # equal second block, different first -> BOTH keys differ (rolling)
    other = key_chain([9, 2, 3, 4, 5, 6, 7, 8], 4)
    assert other[0] != ks[0] and other[1] != ks[1]
    assert key_chain([1, 2, 3], 4) == []
    for tokens, kv in (([1, 2, 3, 4, 5, 6, 7, 8, 9], "f32"),
                       ([9, 2, 3, 4, 5, 6, 7, 8], "int8")):
        assert key_chain(tokens, 4, kv) == jax_key_chain(tokens, 4, kv)
    assert key_chain([1, 2, 3, 4], 4, "int8") != key_chain([1, 2, 3, 4], 4)


# -- the pool -----------------------------------------------------------------

def test_pool_prefix_churn_invariants_and_jax_equality():
    """Random admit/publish/release/retire churn over a tight pool, the
    same operations on the port's pool and the JAX package's: the four
    domains stay an exact partition, referenced blocks cannot be freed,
    the two dumps are equal after every operation, and a full drain
    leaves no live block (cached prefix content may stay resident)."""
    rng = numpy.random.RandomState(11)
    bs = 4
    pools = [KVBlockPool(num_blocks=17, block_size=bs, prefix_caching=True),
             JaxPool(num_blocks=17, block_size=bs, prefix_caching=True)]
    universe = [rng.randint(0, 50, rng.randint(4, 15)).tolist()
                for _ in range(5)]
    live = []                                 # (prompt, shared, private)
    for step in range(400):
        if live and rng.rand() < 0.45:        # retire one session
            prompt, shared, private = live.pop(rng.randint(len(live)))
            blocks = shared + private
            for pool in pools:
                for i, key in enumerate(key_chain(prompt, bs)):
                    if i < len(blocks) and not pool.is_shared(blocks[i]):
                        pool.publish(blocks[i], key)
                owned = [b for b in blocks if pool.is_shared(b)]
                pool.release(owned)
                pool.free([b for b in blocks if b not in owned])
        else:                                 # admit a session
            prompt = universe[rng.randint(len(universe))]
            keys = key_chain(prompt, bs)[:(len(prompt) - 1) // bs]
            shared = [pool.acquire_prefix(keys) for pool in pools]
            assert shared[0] == shared[1]
            shared = shared[0]
            need = required_blocks(len(prompt), bs) - len(shared)
            private = [pool.alloc(need) if need else [] for pool in pools]
            assert private[0] == private[1]
            private = private[0]
            if need and private is None:
                if shared:
                    for pool in pools:
                        pool.release(shared)
                continue
            live.append((prompt, shared, private))
            if shared:                        # referenced -> unfreeable
                with pytest.raises(ValueError, match="referenced"):
                    pools[0].free([shared[0]])
        assert pools[0].check_integrity() == [], step
        assert pools[0].dump() == pools[1].dump(), step
    for prompt, shared, private in live:      # drain everything
        pools[0].release(shared)
        pools[0].free(private)
    pool = pools[0]
    assert pool.live_blocks == 0
    assert pool.free_blocks + pool.cached_blocks == pool.capacity
    assert pool.check_integrity() == []
    stats = pool.stats()
    assert stats["prefix_hits"] > 0 and stats["dedup_blocks"] > 0


def _misuse(pool_cls):
    pool = pool_cls(num_blocks=6, block_size=4, prefix_caching=True)
    off = pool_cls(num_blocks=6, block_size=4)
    with pytest.raises(RuntimeError):
        off.acquire_prefix([b"x"])            # machinery gated off
    (b,) = pool.alloc(1)
    assert pool.publish(b, b"k1")
    (b2,) = pool.alloc(1)
    assert not pool.publish(b2, b"k1")        # first writer wins
    assert not pool.is_shared(b2)             # stays a private copy
    with pytest.raises(ValueError):
        pool.publish(b, b"k2")                # already shared
    with pytest.raises(ValueError):
        pool.free([b])                        # referenced
    pool.release([b])
    with pytest.raises(ValueError):
        pool.free([b])                        # cached: only eviction
    with pytest.raises(ValueError):
        pool.release([b2])                    # never shared
    assert pool.key_of(b) == b"k1" and pool.refcount(b) == 0
    assert pool.resident_keys() == [b"k1"]
    return pool


def _lru(pool_cls):
    pool = pool_cls(num_blocks=5, block_size=4, prefix_caching=True)
    blocks = pool.alloc(4)
    for i, b in enumerate(blocks):
        pool.publish(b, b"key%d" % i)
    pool.release(blocks)                      # all 4 parked in LRU
    assert pool.cached_blocks == 4 and pool.free_blocks == 0
    assert pool.alloc(2) is not None          # evicts the 2 oldest
    assert pool.evicted_blocks == 2
    assert pool.acquire_prefix([b"key0"]) == []       # oldest gone
    assert len(pool.acquire_prefix([b"key3"])) == 1   # newest survives
    pool.note_draft_rollback(3)
    pool.note_draft_rollback(0)
    return pool


@pytest.mark.parametrize("scenario", [_misuse, _lru],
                         ids=["misuse", "lru_eviction"])
def test_pool_misuse_and_eviction_as_jax(scenario):
    port, ref = scenario(KVBlockPool), scenario(JaxPool)
    assert port.check_integrity() == []
    assert port.dump() == ref.dump()
    assert port.stats() == ref.stats()


# -- the toy ------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_toy_functions_equal_the_jax_toy(kv_dtype):
    """Prefill, decode, draft, verify and a prefill chunk of the port's
    toy against the JAX toy's on the same inputs: tokens and pool
    contents (the trash block left out) equal bit for bit."""
    bs = 4
    ports = ToyDecodeModel(vocab=31, draft_agreement=0.6, device="cpu")
    jaxs = JaxToy(vocab=31, draft_agreement=0.6)
    pk, pv = ports.make_pools(13, bs, kv_dtype=kv_dtype)
    jk, jv = jaxs.make_pools(13, bs, kv_dtype=kv_dtype)
    rng = numpy.random.RandomState(0)
    table = numpy.arange(1, 13, dtype=numpy.int32).reshape(3, 4)
    lengths = numpy.zeros(3, numpy.int32)
    fed = numpy.zeros(3, numpy.int32)

    def same(port_out, jax_out):
        assert numpy.array_equal(numpy.asarray(port_out),
                                 numpy.asarray(jax_out))

    for r in range(3):
        prompt = rng.randint(0, 31, 8).astype(numpy.int32)
        length = int(rng.randint(1, 9))
        a, pk, pv = ports.prefill_fn(bs, kv_dtype)(prompt, length, pk, pv,
                                                   table[r])
        b, jk, jv = jaxs.prefill_fn(bs, kv_dtype)(
            jnp.asarray(prompt), length, jk, jv, jnp.asarray(table[r]))
        same(a, b)
        lengths[r], fed[r] = length, int(a)
    for _ in range(3):
        a, pk, pv = ports.decode_fn(bs, kv_dtype)(pk, pv, table, lengths,
                                                  fed)
        b, jk, jv = jaxs.decode_fn(bs, kv_dtype)(
            jk, jv, jnp.asarray(table), jnp.asarray(lengths),
            jnp.asarray(fed))
        same(a, b)
        lengths, fed = lengths + 1, numpy.asarray(b, numpy.int32)
    drafts = ports.draft_fn(bs, 3, kv_dtype)(pk, pv, table, lengths, fed)
    same(drafts, jaxs.draft_fn(bs, 3, kv_dtype)(
        jk, jv, jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(fed)))
    span = numpy.concatenate([fed[:, None], drafts.numpy()], 1)
    a, pk, pv = ports.verify_fn(bs, 3, kv_dtype)(pk, pv, table, lengths,
                                                 span)
    b, jk, jv = jaxs.verify_fn(bs, 3, kv_dtype)(
        jk, jv, jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(span))
    same(a, b)
    chunk = numpy.array([5, 6, 7, 8], numpy.int32)
    a, pk, pv = ports.prefill_chunk_fn(bs, kv_dtype)(chunk, 4, 7, pk, pv,
                                                     table[0])
    b, jk, jv = jaxs.prefill_chunk_fn(bs, kv_dtype)(
        jnp.asarray(chunk), 4, 7, jk, jv, jnp.asarray(table[0]))
    same(a, b)
    for p, j in ((pk[0], jk[0]), (pv[0], jv[0])):
        if kv_dtype == "int8":
            p, j = p["q"], j["q"]
        same(p[1:], numpy.asarray(j)[1:])


# -- chunked prefill ----------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_chunked_prefill_matches_oracle_toy(toy, kv_dtype):
    s = DecodeScheduler(toy, name="chunktoy", **GEOM, device="cpu",
                        prefill_chunk_tokens=4, kv_dtype=kv_dtype)
    assert s.stats()["prefill_chunk_tokens"] == 4
    rng = numpy.random.RandomState(2)
    requests = [(rng.randint(0, 31, rng.randint(1, 17)).tolist(),
                 int(rng.randint(1, 9))) for _ in range(12)]
    got = _run(s, requests)
    assert got == [_oracle(p, n) for p, n in requests]
    stats = s.stats()
    assert stats["free_blocks"] == stats["num_blocks"] - 1
    assert s.metrics.chunks > 0


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_chunked_prefill_matches_oracle_flagship(kv_dtype):
    """f32: the JAX package's cache-free oracle.  int8: chunks read the
    quantized K/V of the chunks before them, so the oracle is the JAX
    scheduler under the same options."""
    rng = numpy.random.RandomState(3)
    requests = [(rng.randint(0, 32, rng.randint(1, 13)).tolist(), 6)
                for _ in range(6)]
    model = tf.FlagshipDecodeModel(**FLAG, seed=0, device="cpu")
    got = _run(DecodeScheduler(model, name="chunkflag", **FLAG_GEOM,
                               prefill_chunk_tokens=4, kv_dtype=kv_dtype,
                               device="cpu"), requests)
    if kv_dtype == "f32":
        want = [_jax_oracle(p, n) for p, n in requests]
    else:
        want = _jax_scheduler_tokens(
            jf.FlagshipDecodeModel(**FLAG, seed=0), requests, **FLAG_GEOM,
            prefill_chunk_tokens=4, kv_dtype=kv_dtype)
    assert got == want


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefill_chunk_fn_and_logits_fn_match_jax(kv_dtype):
    """A 10-token prompt through ``prefill_chunk_fn`` in chunks of 4,
    then one ``logits_fn`` step, in both packages: tokens equal, f32
    pools and the logits within 1e-5, int8 bytes within 1."""
    bs, nb = 4, 4
    prompt = numpy.random.RandomState(5).randint(0, 32, 10)
    models = (tf.FlagshipDecodeModel(**FLAG, seed=1, device="cpu"),
              jf.FlagshipDecodeModel(**FLAG, seed=1))
    row = numpy.arange(1, nb + 1, dtype=numpy.int32)
    out = []
    for model, wrap in zip(models, (lambda x: x, jnp.asarray)):
        kp, vp = model.make_pools(nb + 1, bs, kv_dtype=kv_dtype)
        chunk = model.prefill_chunk_fn(bs, kv_dtype=kv_dtype)
        for start in range(0, 10, 4):
            toks = numpy.zeros(4, numpy.int32)
            toks[:min(4, 10 - start)] = prompt[start:start + 4]
            first, kp, vp = chunk(wrap(toks), start, 10, kp, vp, wrap(row))
        step = model.logits_fn(bs, kv_dtype=kv_dtype)
        nxt, kp, vp, logits = step(
            kp, vp, wrap(row[None]), wrap(numpy.array([10], numpy.int32)),
            wrap(numpy.array([int(first)], numpy.int32)))
        out.append((int(first), int(nxt[0]), numpy.asarray(logits),
                    kp, vp))
    (pf, pn, pl, pk, pv), (jfirst, jn, jl, jk, jv) = out
    assert (pf, pn) == (jfirst, jn)
    numpy.testing.assert_allclose(pl, jl, atol=1e-5, rtol=1e-5)
    for p, j in zip(pk + pv, jk + jv):
        if kv_dtype == "int8":
            diff = numpy.abs(p["q"].numpy()[1:].astype(numpy.int32)
                             - numpy.asarray(j["q"])[1:].astype(numpy.int32))
            assert diff.max() <= 1
            numpy.testing.assert_allclose(p["s"].numpy()[1:],
                                          numpy.asarray(j["s"])[1:],
                                          atol=1e-6)
        else:
            numpy.testing.assert_allclose(p.numpy()[1:],
                                          numpy.asarray(j)[1:],
                                          atol=1e-5, rtol=1e-5)


def test_chunked_int8_appends_equal_one_call():
    """The int8 append of a prefill written chunk by chunk (the chunked
    path's calls) gives the bytes of one call over the whole prompt."""
    rng = numpy.random.RandomState(8)
    shape = (9, 4, 2, 8)
    start = {"q": torch.from_numpy(rng.randint(-127, 128, shape)
                                   .astype(numpy.int8)),
             "s": torch.from_numpy(rng.uniform(0, 0.05, (9, 2))
                                   .astype(numpy.float32))}
    pos = torch.arange(22)
    row = torch.tensor([3, 7, 1, 5, 8, 2])
    blk = torch.where(pos < 19, row[pos // 4], torch.zeros_like(pos))
    off = pos % 4
    vals = torch.from_numpy(rng.standard_normal((22, 2, 8))
                            .astype(numpy.float32))
    whole = {k: v.clone() for k, v in start.items()}
    tf._append_kv(whole, blk, off, vals, "int8")
    for size in (4, 5, 1):
        chunked = {k: v.clone() for k, v in start.items()}
        for i in range(0, 22, size):
            tf._append_kv(chunked, blk[i:i + size], off[i:i + size],
                          vals[i:i + size], "int8")
        assert torch.equal(chunked["q"][1:], whole["q"][1:]), size
        assert torch.equal(chunked["s"][1:], whole["s"][1:]), size


def test_chunking_interleaves_short_request_ttft():
    """A short request submitted right after a long prompt gets its
    first token without waiting out the whole long prefill when chunking
    is on (the stand-in's per-prompt-token host delay pins the prefill
    cost, so the order is deterministic, not a race)."""
    model = ToyDecodeModel(vocab=31, prefill_delay=0.004, device="cpu")
    long_prompt = list(range(1, 31)) + [1, 2]         # 32 tokens
    short_prompt = [3, 1, 4]

    def ttft(chunk):
        s = DecodeScheduler(model, name="hol%s" % (chunk or 0),
                            max_batch=2, block_size=4, max_prompt_len=32,
                            max_new_tokens=4, prefill_chunk_tokens=chunk,
                            device="cpu")
        try:
            f_long = s.submit(long_prompt, 4)
            f_short = s.submit(short_prompt, 4)
            out = f_short.result(60)
            assert out["tokens"] == _oracle(short_prompt, 4)
            assert f_long.result(60)["tokens"] == _oracle(long_prompt, 4)
            return out["ttft_s"]
        finally:
            s.close(drain=True)

    mono, chunked = ttft(None), ttft(4)
    # monolithic: the short TTFT holds the whole 32-token prefill
    # (>= 128 ms of pinned delay); chunked: only a few 4-token chunks
    assert chunked < mono * 0.6, (mono, chunked)


# -- every option off == the core scheduler -----------------------------------

class _Recorder:
    """A decode adapter that records which factories the scheduler
    asks for."""

    def __init__(self, inner):
        self._inner = inner
        self.asked = set()

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name.endswith("_fn") or name == "make_pools":
            self.asked.add(name)
        return attr


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_knobs_off_equal_the_core_scheduler(kv_dtype):
    """A default scheduler and one with every option explicitly off run
    the core paths only (the ladder prefill and the per-token step),
    show no option keys, and give the JAX core scheduler's tokens and
    pool bytes for the same serial traffic."""
    rng = numpy.random.RandomState(4)
    requests = [(rng.randint(0, 31, rng.randint(1, 17)).tolist(),
                 int(rng.randint(1, 9))) for _ in range(6)]
    pools = []
    for kwargs in ({}, dict(prefix_caching=False,
                            prefill_chunk_tokens=None, spec_depth=None,
                            kvtier=None)):
        model = _Recorder(ToyDecodeModel(vocab=31, device="cpu"))
        s = DecodeScheduler(model, name="defaults", **GEOM, device="cpu",
                            kv_dtype=kv_dtype, **kwargs)
        stats = s.stats()
        assert stats["prefix_caching"] is False
        assert stats["prefill_chunk_tokens"] is None
        for key in ("prefix_hits", "dedup_blocks", "spec_depth",
                    "draft_tokens", "acceptance_rate"):
            assert key not in stats
        assert "speculation" not in s.kv_dump()
        assert _run(s, requests, serial=True) == \
            [_oracle(p, n) for p, n in requests]
        assert model.asked == {"make_pools", "prefill_fn", "decode_fn"}
        pools.append(s._k_pools[0])
    jax_s = JaxScheduler(JaxToy(vocab=31), name="jaxcore", cache=False,
                         kv_dtype=kv_dtype, **GEOM)
    assert _run(jax_s, requests, serial=True) == \
        [_oracle(p, n) for p, n in requests]
    jax_pool = jax_s._k_pools[0]
    for pool in pools:
        if kv_dtype == "int8":
            pool, want = pool["q"], numpy.asarray(jax_pool["q"])
        else:
            want = numpy.asarray(jax_pool)
        assert numpy.array_equal(pool.numpy()[1:], want[1:])


@pytest.mark.parametrize("option,value,item", [
    ("prefill_chunk_tokens", "auto", "queue A item 3"),
    ("spec_depth", "auto", "queue A item 3"),
    ("kv_dtype", "auto", "queue A item 3"),
])
def test_unported_options_raise_naming_their_item(toy, option, value,
                                                  item):
    """``value`` for ``option`` raised naming ``item`` until that item
    ported the autotuner: now, with the tuner off, it resolves to the
    site's default exactly as the JAX scheduler resolves it, and the
    scheduler serves the oracle's tokens."""
    from veles_tpu_torch.autotune import dispatch
    assert dispatch.resolve_config() is None        # the tuner is off
    kw = dict(GEOM, **{option: value})
    s = DecodeScheduler(toy, name="auto", device="cpu", **kw)
    jax_s = JaxScheduler(JaxToy(vocab=31), name="jaxauto", cache=False,
                         warmup=False, **kw)
    try:
        got, want = s.stats(), jax_s.stats()
        for key in ("prefill_chunk_tokens", "kv_dtype", "spec_depth",
                    "chunk_source", "spec_source", "kv_dtype_source",
                    "max_batch", "block_size"):
            assert got.get(key) == want.get(key), key
        source = {"prefill_chunk_tokens": "chunk_source",
                  "spec_depth": "spec_source",
                  "kv_dtype": "kv_dtype_source"}[option]
        assert got[source] == "default"
        requests = [([3, 1, 4, 1, 5], 4), ([2, 7, 1, 8, 2, 8, 1], 3)]
        assert _run(s, requests, serial=True) == \
            [_oracle(p, n) for p, n in requests]
    finally:
        s.close()
        jax_s.close(drain=False)


def test_option_misuse_raises(toy):
    with pytest.raises(ValueError, match="prefix_caching"):
        DecodeScheduler(toy, name="badknobs", **GEOM, device="cpu",
                        prefix_caching=True)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        DecodeScheduler(toy, name="badchunk", **GEOM, device="cpu",
                        prefill_chunk_tokens=-1)

    class NoChunk:
        vocab = 31
        device = torch.device("cpu")
        make_pools = toy.make_pools
        prefill_fn = toy.prefill_fn
        decode_fn = toy.decode_fn

    with pytest.raises(ValueError, match="prefill_chunk_fn"):
        DecodeScheduler(NoChunk(), name="nochunk", **GEOM, device="cpu",
                        prefill_chunk_tokens=4)


# -- prefix reuse -------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefix_reuse_tokens_bitwise_toy(toy, kv_dtype):
    """Followers sharing a system prompt attach to the seed's resident
    blocks; every sequence still matches its solo run bitwise: the toy
    READS the shared blocks through the page table, so one clobbered
    token would change the output."""
    s = DecodeScheduler(toy, name="reusetoy", **GEOM, **PREFIX,
                        kv_dtype=kv_dtype, device="cpu")
    try:
        system = [7, 3, 7, 3, 5, 1, 5, 1]             # two full blocks
        seed = system + [9]
        assert s.generate(seed, 8, timeout=60)["tokens"] == \
            _oracle(seed, 8)
        followers = [system + [10 + i, 11 + i] for i in range(6)]
        futures = [s.submit(p, 8) for p in followers]
        for p, f in zip(followers, futures):
            assert f.result(60)["tokens"] == _oracle(p, 8)
        stats = s.stats()
        assert stats["prefix_hits"] >= len(followers)
        assert stats["dedup_blocks"] >= 2 * len(followers)
        assert s.metrics.prefix_hits == stats["prefix_hits"]
        dump = s.kv_dump()
        assert dump["integrity"] == []
        assert dump["dedup_ratio"] >= 0.4
    finally:
        s.close(drain=True)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefix_reuse_tokens_bitwise_flagship(kv_dtype):
    """The real transformer: followers reuse the seed's float (or int8)
    blocks and emit the JAX package's tokens (f32: its cache-free
    oracle; int8: its scheduler under the same options and traffic)."""
    system = [5, 9, 2, 7, 1, 4, 6, 8]                 # two full blocks
    prompts = [system + [10 + i] for i in range(3)]
    requests = [(p, 4) for p in prompts]
    geom = dict(FLAG_GEOM, max_new_tokens=4, prefix_caching=True,
                prefill_chunk_tokens=4, kv_dtype=kv_dtype)

    def serve(sched):
        first = sched.generate(prompts[0], 4, timeout=120)["tokens"]
        stats_before = sched.stats()
        rest = _run(sched, requests[1:])
        return [first] + rest, stats_before, sched.stats()

    model = tf.FlagshipDecodeModel(**FLAG, seed=3, device="cpu")
    got, _, stats = serve(DecodeScheduler(model, name="reuseflag",
                                          device="cpu", **geom))
    assert stats["prefix_hits"] >= 2 and stats["dedup_blocks"] >= 4
    if kv_dtype == "f32":
        want = [_jax_oracle(p, 4, seed=3) for p in prompts]
    else:
        want = serve(JaxScheduler(jf.FlagshipDecodeModel(**FLAG, seed=3),
                                  name="jaxreuse", cache=False, **geom))[0]
    assert got == want


def test_multi_turn_resubmission_reuses_history(toy):
    """At retire the full history (prompt + generated) is published: a
    follow-up turn that resubmits the conversation reuses it."""
    s = DecodeScheduler(toy, name="multiturn", **GEOM, **PREFIX,
                        device="cpu")
    try:
        turn1 = [1, 2, 3, 4, 5]
        out1 = s.generate(turn1, 7, timeout=60)
        assert out1["tokens"] == _oracle(turn1, 7)
        before = s.stats()["dedup_blocks"]
        turn2 = turn1 + out1["tokens"] + [6]
        out2 = s.generate(turn2, 3, timeout=60)
        assert out2["tokens"] == _oracle(turn2, 3)
        assert s.stats()["dedup_blocks"] > before
    finally:
        s.close(drain=True)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefix_churn_never_corrupts_survivors(toy, kv_dtype):
    """Random shared-prefix traffic over a TIGHT pool (eviction, revival
    and divergence all the time): every sequence equals its solo run,
    and the pool partition survives."""
    s = DecodeScheduler(toy, name="prefchurn", max_batch=3, block_size=4,
                        max_prompt_len=12, max_new_tokens=8, num_blocks=14,
                        **PREFIX, kv_dtype=kv_dtype, device="cpu")
    try:
        rng = numpy.random.RandomState(5)
        systems = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3, 2]]
        requests = []
        for _ in range(20):
            base = systems[rng.randint(2)] if rng.rand() < 0.7 else []
            tail = rng.randint(0, 31, rng.randint(1, 5)).tolist()
            requests.append((base + tail, int(rng.randint(1, 9))))
        futures = []
        for i, (p, n) in enumerate(requests):
            futures.append(s.submit(p, n))
            if i % 4 == 0:
                time.sleep(0.004)
        for (p, n), f in zip(requests, futures):
            assert f.result(60)["tokens"] == _oracle(p, n)
        assert s.kv_dump()["integrity"] == []
        stats = s.stats()
        assert stats["active_sequences"] == 0
        assert stats["prefix_hits"] > 0
    finally:
        s.close(drain=True)


# -- HTTP dump route + kv_inspect ---------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_kv_dump_route_and_inspect(kv_dtype):
    from tools import kv_inspect
    model = ToyDecodeModel(vocab=31, device="cpu",
                           decode_defaults=dict(GEOM, **PREFIX,
                                                kv_dtype=kv_dtype))
    srv = InferenceServer({"toy": model}, device="cpu")
    try:
        base = "http://127.0.0.1:%d" % srv.port
        prompt = [1, 2, 3, 4, 5, 6]
        req = urllib.request.Request(
            base + "/api/toy/generate",
            json.dumps({"prompt": prompt, "max_new_tokens": 4}).encode(),
            {"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert out["tokens"] == _oracle(prompt, 4)
        assert kv_inspect.decode_models(base) == ["toy"]
        models = json.loads(urllib.request.urlopen(
            base + "/models", timeout=30).read())
        assert models["toy"]["prefix_caching"] is True
        assert models["toy"]["prefill_chunk_tokens"] == 4
        dump = kv_inspect.fetch_dump(base, "toy")
        assert kv_inspect.verify_dump(dump) == []
        assert dump["model"] == "toy" and dump["kv_dtype"] == kv_dtype
        assert dump["prefix_caching"] is True
        assert dump["prefill_chunk_tokens"] == 4
        assert dump["published_blocks"] > 0
        if kv_dtype == "int8":
            assert dump["quant"]["scales"]["min"] == 1.0
        text = kv_inspect.describe(dump)
        assert "integrity: ok" in text and "prefix caching on" in text
        with pytest.raises(urllib.error.HTTPError) as e:
            kv_inspect.fetch_dump(base, "nope")
        assert e.value.code == 404
    finally:
        srv.stop()
