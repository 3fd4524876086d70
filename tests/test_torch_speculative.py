"""Speculative decoding in the port's scheduler, held against the JAX
package.

Mirrors ``tests/test_speculative.py`` (its migration, checkpoint and
warm-restart tests wait for their modules; the verify entry's kernel
test is ``tests/test_torch_paged_attention.py``'s) with the port's
``DecodeScheduler`` and ``ToyDecodeModel`` on ``device="cpu"``:

- with ``spec_depth`` off the scheduler is the plain per-token one: no
  drafter or verify pass is built, no speculation keys in ``stats()``
  or the KV dump, and the tokens are the speculative scheduler's;
- speculation needs the model's ``draft_fn``/``verify_fn``;
- every emitted sequence equals the plain-decode oracle at every depth
  and every drafter agreement (greedy acceptance: the longest matching
  draft prefix plus the target's own next token): the toy against
  ``generate_reference`` of both packages, the flagship against the JAX
  package, speculation alone and with prefix caching and chunks (f32:
  its cache-free forward; int8: its ``DecodeScheduler`` under the same
  options, since rejected drafts leave their mark on an int8 block's
  scale);
- rejected positions roll back: the pool partition survives
  speculation with prefix-caching churn, and published history never
  holds rejected content (every follower's tokens stay bitwise);
- speculation composes with prefix reuse;
- the metrics show draft/accept/reject counts and the windowed
  acceptance rate (also in ``GET /metrics``); a plain scheduler shows
  no acceptance series.

Tolerances: toy tokens bitwise equal; flagship greedy tokens equal;
int8 pool bytes of a verify span's append bitwise equal to the same
positions appended row by row.
"""

import functools
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.serving import DecodeScheduler as JaxScheduler
from veles_tpu.serving import ToyDecodeModel as JaxToy
from veles_tpu.serving.toydecode import from_spec as jax_from_spec
from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.serving import (DecodeScheduler, InferenceServer,
                                     ToyDecodeModel)
from veles_tpu_torch.serving.toydecode import from_spec
from veles_tpu_torch.znicz.samples import flagship as tf

GEOM = dict(max_batch=3, block_size=4, max_prompt_len=16,
            max_new_tokens=8)
FLAG = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32,
            seed=0)
FLAG_GEOM = dict(max_batch=3, block_size=4, max_prompt_len=8,
                 max_new_tokens=6)


@pytest.fixture(scope="module")
def toy():
    return ToyDecodeModel(vocab=31, draft_agreement=0.75, device="cpu")


@functools.lru_cache(maxsize=None)
def _oracle(prompt, n, vocab=31):
    """The toy's host oracle, the same in both packages."""
    want = ToyDecodeModel(vocab=vocab, device="cpu").generate_reference(
        prompt, n)
    assert want == JaxToy(vocab=vocab).generate_reference(prompt, n)
    return want


def oracle(prompt, n):
    return _oracle(tuple(prompt), n)


def _requests(rng, n, vocab=31, max_prompt=16, max_new=8):
    return [(rng.randint(0, vocab, rng.randint(1, max_prompt + 1))
             .tolist(), int(rng.randint(1, max_new + 1)))
            for _ in range(n)]


def _run(sched, requests):
    try:
        futures = [sched.submit(p, n) for p, n in requests]
        return [f.result(120)["tokens"] for f in futures]
    finally:
        sched.close(drain=True)


@functools.lru_cache(maxsize=None)
def _jax_forward():
    params = jf.init_decode_params(**FLAG)

    @jax.jit
    def fwd(tokens):
        stacked = jf._stacked(params)
        h = params["emb"][tokens][None]
        for i in range(stacked["qkv"].shape[0]):
            h, _, _ = jf._prefill_block(
                jax.tree.map(lambda p: p[i], stacked), h, 2, 1)
        return jnp.argmax(h[0] @ params["emb"].T, axis=-1)
    return fwd


def _jax_oracle(prompt, n):
    """The JAX package's cache-free greedy tokens (its dense causal block
    stack, jitted once over a padded length)."""
    tokens = list(prompt)
    for _ in range(n):
        arr = numpy.zeros(16, numpy.int32)
        arr[:len(tokens)] = tokens
        tokens.append(int(_jax_forward()(jnp.asarray(arr))
                          [len(tokens) - 1]))
    return tokens[len(prompt):]


# -- off == the plain scheduler -----------------------------------------------

def test_spec_off_equals_prior_behavior(toy):
    s = DecodeScheduler(toy, name="specoff", **GEOM, device="cpu")
    try:
        stats = s.stats()
        for key in ("spec_depth", "draft_tokens", "accepted_tokens",
                    "rejected_tokens", "acceptance_rate",
                    "rolled_back_tokens"):
            assert key not in stats
        assert s._draft is None and s._verify is None
        assert "speculation" not in s.kv_dump()
    finally:
        s.close(drain=True)
    with pytest.raises(ValueError, match="spec_depth"):
        DecodeScheduler(toy, name="specbad", **GEOM, spec_depth=0,
                        device="cpu")


def test_spec_requires_model_support(toy):
    class NoDraft:
        """A decode adapter without the drafter closure pair."""

        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            if name in ("draft_fn", "verify_fn"):
                raise AttributeError(name)
            return getattr(self._inner, name)

    with pytest.raises(ValueError, match="draft_fn"):
        DecodeScheduler(NoDraft(toy), name="nodraft", **GEOM, spec_depth=2,
                        device="cpu")


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_spec_on_off_byte_equivalence(toy, kv_dtype):
    """The same request mix through a plain and a speculative scheduler
    gives identical token streams; only the speculative one grows the
    stats surface."""
    requests = _requests(numpy.random.RandomState(4), 10)
    outs = {}
    for depth in (None, 3):
        s = DecodeScheduler(toy, name="eqv%s" % (depth or 0), **GEOM,
                            spec_depth=depth, kv_dtype=kv_dtype,
                            device="cpu")
        outs[depth] = _run(s, requests)
        stats = s.stats()
        if depth:
            assert stats["spec_depth"] == depth
            assert stats["draft_tokens"] > 0
        else:
            assert "spec_depth" not in stats
    assert outs[None] == outs[3]
    assert outs[3] == [oracle(p, n) for p, n in requests]


# -- the oracle at every depth and agreement ----------------------------------

@pytest.mark.parametrize("depth", (1, 2, 4))
@pytest.mark.parametrize("agreement", (1.0, 0.6, 0.0))
def test_spec_matches_oracle_toy(depth, agreement):
    """Greedy acceptance is EXACT whatever the drafter's quality:
    agreement 1.0 accepts everything, 0.0 rejects every draft (pure
    verify-correction decode); the emitted stream never moves."""
    model = ToyDecodeModel(vocab=31, draft_agreement=agreement,
                           device="cpu")
    requests = _requests(numpy.random.RandomState(depth), 8)
    s = DecodeScheduler(model, name="ora%d_%d" % (depth, agreement * 10),
                        **GEOM, spec_depth=depth, device="cpu")
    assert _run(s, requests) == [oracle(p, n) for p, n in requests]
    stats = s.stats()
    if agreement == 1.0:
        assert stats["rejected_tokens"] == 0
    if agreement == 0.0 and depth > 1:
        assert stats["acceptance_rate"] == 0.0


@pytest.mark.parametrize("prefix", [False, True],
                         ids=["spec", "spec+prefix+chunks"])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_spec_matches_oracle_flagship(kv_dtype, prefix):
    """The real transformer: the unigram drafter's proposals run the
    verify path (multi-token paged attention, MoE, argmax), alone or
    with prefix caching and chunks of 4 over prompts that share a
    prefix.  f32 emits the JAX package's cache-free tokens; int8 the
    JAX scheduler's under the same options and traffic."""
    rng = numpy.random.RandomState(2)
    system = rng.randint(0, 32, 4).tolist() if prefix else []
    requests = [(system + rng.randint(0, 32, rng.randint(1, 5)).tolist(),
                 6) for _ in range(6)]
    options = dict(FLAG_GEOM, spec_depth=2, kv_dtype=kv_dtype)
    if prefix:
        options.update(prefix_caching=True, prefill_chunk_tokens=4)

    def serve(sched):
        # the first request alone, so the rest find its blocks resident
        first = sched.generate(*requests[0], timeout=120)["tokens"]
        return [first] + _run(sched, requests[1:])

    model = tf.FlagshipDecodeModel(**FLAG, device="cpu")
    sched = DecodeScheduler(model, name="oraflag", device="cpu", **options)
    got = serve(sched)
    if prefix:
        assert sched.stats()["prefix_hits"] > 0
    if kv_dtype == "f32":
        want = [_jax_oracle(p, n) for p, n in requests]
    else:
        want = serve(JaxScheduler(jf.FlagshipDecodeModel(**FLAG),
                                  name="jaxspec", cache=False, **options))
    assert got == want


def test_verify_int8_append_equals_row_by_row():
    """A verify span [B, S] appended in one call gives the bytes of each
    row's span appended on its own (the rows own their blocks)."""
    rng = numpy.random.RandomState(9)
    shape = (13, 4, 2, 8)
    start = {"q": torch.from_numpy(rng.randint(-127, 128, shape)
                                   .astype(numpy.int8)),
             "s": torch.from_numpy(rng.uniform(0, 0.05, (13, 2))
                                   .astype(numpy.float32))}
    table = torch.arange(1, 13).reshape(4, 3)
    lengths = torch.tensor([2, 9, 0, 5])
    pos = lengths[:, None] + torch.arange(5)[None, :]
    blk = torch.where(pos < 12, table[torch.arange(4)[:, None],
                                      (pos // 4).clamp(max=2)],
                      torch.zeros_like(pos))
    off = pos % 4
    vals = torch.from_numpy(rng.standard_normal((4, 5, 2, 8))
                            .astype(numpy.float32))
    span = {k: v.clone() for k, v in start.items()}
    tf._append_kv(span, blk, off, vals, "int8")
    rows = {k: v.clone() for k, v in start.items()}
    for r in range(4):
        tf._append_kv(rows, blk[r], off[r], vals[r], "int8")
    assert torch.equal(span["q"][1:], rows["q"][1:])
    assert torch.equal(span["s"][1:], rows["s"][1:])


# -- rollback and composition with prefix caching -----------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_spec_rollback_pool_invariants_under_churn(kv_dtype):
    """A heavy-rejection drafter over a prefix-caching pool: each verify
    pass writes k+1 positions and most roll back; the pool partition
    survives, published blocks cover only TRUE history (every
    follower's tokens stay bitwise), and the rollback tallies show in
    the dump."""
    model = ToyDecodeModel(vocab=31, draft_agreement=0.2, device="cpu")
    s = DecodeScheduler(model, name="rollback", max_batch=3, block_size=4,
                        max_prompt_len=12, max_new_tokens=8, num_blocks=14,
                        prefix_caching=True, prefill_chunk_tokens=4,
                        spec_depth=3, kv_dtype=kv_dtype, device="cpu")
    try:
        rng = numpy.random.RandomState(6)
        systems = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3, 2]]
        requests = []
        for _ in range(18):
            base = systems[rng.randint(2)] if rng.rand() < 0.7 else []
            tail = rng.randint(0, 31, rng.randint(1, 5)).tolist()
            requests.append((base + tail, int(rng.randint(1, 9))))
        futures = []
        for i, (p, n) in enumerate(requests):
            futures.append(s.submit(p, n))
            if i % 4 == 0:
                time.sleep(0.004)
        for (p, n), f in zip(requests, futures):
            assert f.result(60)["tokens"] == oracle(p, n)
        dump = s.kv_dump()
        assert dump["integrity"] == []
        spec = dump["speculation"]
        assert spec["spec_depth"] == 3
        assert spec["rejected_tokens"] > 0
        assert spec["draft_rollbacks"] > 0
        assert spec["rolled_back_tokens"] >= spec["draft_rollbacks"]
        stats = s.stats()
        assert stats["active_sequences"] == 0
        assert stats["prefix_hits"] > 0
    finally:
        s.close(drain=True)


def test_spec_composes_with_prefix_reuse(toy):
    """Followers sharing a system prompt attach to resident blocks
    while speculating: the dedupe fires and the tokens stay bitwise."""
    s = DecodeScheduler(toy, name="specreuse", **GEOM, prefix_caching=True,
                        prefill_chunk_tokens=4, spec_depth=2, device="cpu")
    try:
        system = [7, 3, 7, 3, 5, 1, 5, 1]             # two full blocks
        seed = system + [9]
        assert s.generate(seed, 8, timeout=60)["tokens"] == oracle(seed, 8)
        followers = [system + [10 + i, 11 + i] for i in range(6)]
        futures = [s.submit(p, 8) for p in followers]
        for p, f in zip(followers, futures):
            assert f.result(60)["tokens"] == oracle(p, 8)
        stats = s.stats()
        assert stats["prefix_hits"] >= len(followers)
        assert stats["dedup_blocks"] >= 2 * len(followers)
        assert stats["accepted_tokens"] > 0
        assert s.kv_dump()["integrity"] == []
    finally:
        s.close(drain=True)


# -- the metrics surface ------------------------------------------------------

def test_spec_metrics_series(toy):
    """The counters and the windowed acceptance rate, through the
    scheduler's metrics and over ``GET /metrics``."""
    model = ToyDecodeModel(vocab=31, draft_agreement=0.75, device="cpu",
                           decode_defaults=dict(GEOM, spec_depth=2))
    srv = InferenceServer({"specmet": model}, device="cpu")
    try:
        s = srv.registry.get("specmet").scheduler
        requests = _requests(numpy.random.RandomState(9), 6)
        for p, n in requests:
            assert s.generate(p, n, timeout=60)["tokens"] == oracle(p, n)
        m = s.metrics
        assert m.draft_tokens > 0 and m.verify_steps > 0
        assert m.accepted_tokens + m.rejected_tokens == m.draft_tokens
        rate = m.acceptance_rate()
        assert rate is not None and 0.0 <= rate <= 1.0
        assert m.snapshot()["acceptance_rate"] == round(rate, 4)
        # emitted tokens == the tokens counter: one a step a row plus the
        # extra accepted ones
        assert m.tokens == sum(len(oracle(p, n)) for p, n in requests)
        with urllib.request.urlopen(srv.url + "/metrics",
                                    timeout=30) as resp:
            served = json.loads(resp.read())["specmet"]
        assert served["acceptance_rate"] == round(rate, 4)
        assert served["spec_depth"] == 2
        assert served["draft_tokens"] == m.draft_tokens
        with urllib.request.urlopen(srv.url + "/models",
                                    timeout=30) as resp:
            assert json.loads(resp.read())["specmet"]["spec_depth"] == 2
    finally:
        srv.stop()


def test_plain_metrics_have_no_acceptance(toy):
    s = DecodeScheduler(toy, name="plainmet", **GEOM, device="cpu")
    try:
        s.generate([1, 2, 3], 4, timeout=60)
        assert s.metrics.acceptance_rate() is None
        assert "acceptance_rate" not in s.metrics.snapshot()
        assert s.metrics.draft_tokens == 0
    finally:
        s.close(drain=True)


# -- the spec form ------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "toydecode:vocab=31,agree=0.6,spec=3,max_batch=4,block=4",
    "toydecode:delay=0.01,pdelay=0.002,ddelay=0.001,chunk=4,prefix=1,"
    "kv_dtype=int8,max_prompt=16,max_new=32",
    "toydecode:spec=auto",
    "toydecode:tier_host=4096,tier_disk=0",
])
def test_from_spec_parses_as_the_jax_package(spec):
    """The port's spec form gives the JAX package's knobs and scheduler
    geometry; ``spec=auto`` reaches the scheduler, which resolves it
    through the ``serving.spec_depth`` site (the tuner off: depth 2, as
    the JAX scheduler), and the tier keys reach it as ``kvtier``, which
    (as in the JAX package) needs prefix caching."""
    port, ref = from_spec(spec, device="cpu"), jax_from_spec(spec)
    assert port.decode_defaults == ref.decode_defaults
    for knob in ("vocab", "step_host_delay", "prefill_host_delay",
                 "draft_host_delay", "draft_agreement"):
        assert getattr(port, knob) == getattr(ref, knob)
    if "auto" in spec:
        sched = DecodeScheduler(port, name="auto", device="cpu",
                                **port.decode_defaults)
        try:
            stats = sched.stats()
            assert (stats["spec_depth"], stats["spec_source"]) == \
                (2, "default")
        finally:
            sched.close()
    if "tier" in spec:
        with pytest.raises(ValueError, match="kvtier requires "
                           "prefix_caching"):
            DecodeScheduler(port, name="noprefix", device="cpu",
                            **port.decode_defaults)
        sched = DecodeScheduler(port, name="tiered", device="cpu",
                                prefix_caching=True,
                                prefill_chunk_tokens=4,
                                **port.decode_defaults)
        try:
            assert sched.stats()["kvtier"]["host_blocks"] == 0
            assert sched._kvtier.host.capacity_bytes == 4096
        finally:
            sched.close()
    with pytest.raises(ValueError, match="unknown toydecode spec key"):
        from_spec(spec + ",bogus=1", device="cpu")
