"""Decode serving of the PyTorch port: scheduler, KV paging, HTTP, drain.

Mirrors the default-path tests of ``tests/test_decode_serving.py`` with
the port's ``DecodeScheduler`` and ``InferenceServer`` on
``device="cpu"`` (the kernels' plain versions).  Every generated token
is held against the JAX package: the same seeded weights through JAX's
dense causal block stack, the body of its cache-free
``generate_reference``, jitted once over a padded length.

- concurrent ragged mixes emit exactly the oracle's tokens;
- admit/retire churn on a tight pool never corrupts a survivor;
- ``KVBlockPool`` keeps its free/live partition under random schedules;
- ``key_chain`` gives the JAX package's keys;
- drain finishes every submitted sequence and sheds new ones with 429;
- a full queue sheds with 429 + ``Retry-After``;
- ``POST /api/<name>/generate`` round-trips and answers 400/404 on bad
  requests, with ``X-Trace-Id`` on every answer.
"""

import functools
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy
import pytest

from veles_tpu.serving.kvcache import key_chain as jax_key_chain
from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.observability.registry import REGISTRY
from veles_tpu_torch.serving import (DecodeMetrics, DecodeScheduler,
                                     InferenceServer, KVBlockPool,
                                     SchedulerClosed, SchedulerOverflow,
                                     key_chain)
from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel

GEO = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32,
           seed=0)
SERVE = dict(max_batch=4, block_size=4, max_prompt_len=8,
             max_new_tokens=8, device="cpu")


@pytest.fixture(scope="module")
def model():
    return FlagshipDecodeModel(**GEO, device="cpu")


@pytest.fixture(scope="module")
def oracle():
    """Memoized greedy tokens of the JAX package's model with the same
    seed: its dense causal block stack jitted once over a padded length
    (causal attention and the no-drop MoE make position i independent
    of the padding after it)."""
    params = jf.init_decode_params(**GEO)

    @jax.jit
    def fwd(tokens):
        stacked = jf._stacked(params)
        h = params["emb"][tokens][None]
        for i in range(stacked["qkv"].shape[0]):
            h, _, _ = jf._prefill_block(
                jax.tree.map(lambda p: p[i], stacked), h, 2, 1)
        return jnp.argmax(h[0] @ params["emb"].T, axis=-1)

    @functools.lru_cache(maxsize=None)
    def run(prompt, n):
        tokens = list(prompt)
        for _ in range(n):
            arr = numpy.zeros(16, numpy.int32)
            arr[:len(tokens)] = tokens
            tokens.append(int(fwd(jnp.asarray(arr))[len(tokens) - 1]))
        return tokens[len(prompt):]
    return lambda prompt, n: run(tuple(prompt), n)


@pytest.fixture(scope="module")
def scheduler(model):
    s = DecodeScheduler(model, name="torch-dectest", **SERVE)
    yield s
    s.close(drain=True)


def _mixed_requests(rng, n):
    return [(rng.randint(0, 32, rng.randint(1, 9)).tolist(),
             int(rng.randint(1, 9))) for _ in range(n)]


def _post(port, payload, route="/api/flag/generate"):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, route),
        json.dumps(payload).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def test_generate_matches_jax_oracle(scheduler, oracle):
    rng = numpy.random.RandomState(1)
    requests = _mixed_requests(rng, 10)
    futures = [scheduler.submit(p, n) for p, n in requests]
    for (prompt, n), future in zip(requests, futures):
        result = future.result(60)
        assert result["tokens"] == oracle(prompt, n)
        assert result["prompt_tokens"] == len(prompt)
        assert result["ttft_s"] > 0
    stats = scheduler.stats()
    assert stats["compiles"] == stats["cache_hits"] == 0
    assert stats["device"] == "cpu"


def test_all_blocks_reclaimed(scheduler):
    rng = numpy.random.RandomState(3)
    futures = [scheduler.submit(p, n) for p, n in _mixed_requests(rng, 8)]
    for f in futures:
        f.result(60)
    deadline = time.time() + 5
    while scheduler.active_sequences and time.time() < deadline:
        time.sleep(0.01)
    stats = scheduler.stats()
    assert stats["free_blocks"] == stats["num_blocks"] - 1
    assert stats["active_sequences"] == 0


def test_admit_retire_never_corrupts_survivors(model, oracle):
    s = DecodeScheduler(model, name="torch-churn", max_batch=3,
                        block_size=4, max_prompt_len=8, max_new_tokens=8,
                        num_blocks=10, device="cpu")   # heavy recycling
    try:
        rng = numpy.random.RandomState(4)
        requests = _mixed_requests(rng, 24)
        futures = []
        for i, (prompt, n) in enumerate(requests):
            futures.append(s.submit(prompt, n))
            if i % 3 == 0:      # stagger arrivals to vary batch mixes
                time.sleep(0.005)
        for (prompt, n), future in zip(requests, futures):
            assert future.result(60)["tokens"] == oracle(prompt, n)
    finally:
        s.close(drain=True)


def test_int8_kv_scheduler_matches_the_paged_int8_model(model, oracle):
    """kv_dtype passes through to the model: int8 pools, and the answers
    stay those of the same model rolled out by hand."""
    s = DecodeScheduler(model, name="torch-int8", kv_dtype="int8", **SERVE)
    try:
        assert s.stats()["kv_dtype"] == "int8"
        result = s.generate([3, 1, 4, 1], 5, timeout=60)
        assert len(result["tokens"]) == 5
        kp, vp = model.make_pools(9, 4, kv_dtype="int8")
        pre = model.prefill_fn(4, kv_dtype="int8")
        dec = model.decode_fn(4, kv_dtype="int8")
        tokens = numpy.zeros(4, numpy.int32)
        tokens[:] = [3, 1, 4, 1]
        first, kp, vp = pre(tokens, 4, kp, vp, [1, 2, 3, 0])
        want = [int(first)]
        for i in range(4):
            nxt, kp, vp = dec(kp, vp, [[1, 2, 3, 0]], [4 + i], [want[-1]])
            want.append(int(nxt[0]))
        assert result["tokens"] == want
    finally:
        s.close()
    with pytest.raises(ValueError):
        DecodeScheduler(model, kv_dtype="int4", **SERVE)


def test_kv_block_pool_invariants():
    rng = numpy.random.RandomState(5)
    pool = KVBlockPool(num_blocks=17, block_size=4)
    live = {}
    for step in range(300):
        if live and rng.rand() < 0.45:
            key = rng.choice(list(live))
            pool.free(live.pop(key))
        else:
            blocks = pool.alloc(int(rng.randint(1, 5)))
            if blocks is None:
                assert pool.free_blocks < 4
                continue
            assert 0 not in blocks          # trash never handed out
            flat = [b for bs in live.values() for b in bs]
            assert not set(blocks) & set(flat)   # no double ownership
            live[step] = blocks
        assert pool.free_blocks + pool.live_blocks == pool.capacity
        assert not pool.check_integrity()
    with pytest.raises(ValueError):
        pool.free([0])
    taken = pool.alloc(1)
    pool.free(taken)
    with pytest.raises(ValueError):
        pool.free(taken)                    # double free


@pytest.mark.parametrize("n,block_size,kv_dtype", [
    (0, 4, "f32"), (7, 4, "f32"), (16, 4, "int8"), (33, 8, "f32")])
def test_key_chain_equals_jax(n, block_size, kv_dtype):
    tokens = numpy.random.RandomState(n).randint(0, 1000, n).tolist()
    keys = key_chain(tokens, block_size, kv_dtype)
    assert len(keys) == n // block_size
    assert keys == jax_key_chain(tokens, block_size, kv_dtype)


def test_graceful_drain_finishes_inflight_sheds_new(model):
    threads_before = {t.name for t in threading.enumerate()}
    srv = InferenceServer({"flag": model}, queue_limit=64, **SERVE)
    sched = srv.registry.get("flag").scheduler
    port = srv.port
    futures = [sched.submit([1 + i % 8] * 4, 8) for i in range(12)]
    stopper = threading.Thread(target=srv.stop, kwargs={"drain": True})
    stopper.start()
    deadline = time.time() + 5
    while not srv.draining and time.time() < deadline:
        time.sleep(0.001)
    code, headers = None, {}
    try:
        _post(port, {"prompt": [1, 2], "max_new_tokens": 2})
        code = 200
    except urllib.error.HTTPError as e:
        code, headers = e.code, dict(e.headers)
    except OSError:
        code = "conn"   # drain won the race and closed the listener
    if code != "conn":
        assert code == 429
        assert headers.get("Retry-After")
    stopper.join(30)
    assert not stopper.is_alive()
    for f in futures:                       # admitted AND queued finish
        assert len(f.result(10)["tokens"]) == 8
    with pytest.raises(SchedulerClosed):
        sched.submit([1, 2], 2)
    stats = sched.stats()
    assert stats["free_blocks"] == stats["num_blocks"] - 1
    deadline = time.time() + 5
    while time.time() < deadline:
        leaked = {t.name for t in threading.enumerate()} - threads_before
        leaked = {n for n in leaked
                  if n.startswith(("veles-decode", "veles-tpu-torch"))}
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, "leaked threads: %r" % leaked


def test_overflow_sheds_429_with_retry_after(model):
    srv = InferenceServer({"flag": model}, queue_limit=2, **SERVE)
    try:
        sched = srv.registry.get("flag").scheduler
        futures = []
        with pytest.raises(SchedulerOverflow):
            for _ in range(20):
                futures.append(sched.submit([1, 2, 3], 8))
        code, body = None, None
        for _ in range(10):     # keep the queue full while probing
            try:
                futures.append(sched.submit([1, 2, 3], 8))
            except SchedulerOverflow:
                pass
            try:
                _post(srv.port, {"prompt": [1], "max_new_tokens": 8})
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    code = e.code
                    assert int(e.headers.get("Retry-After")) >= 1
                    body = json.loads(e.read())
                    break
        for f in futures:
            f.result(60)
        assert code == 429 and "error" in body
        assert sched.metrics.rejected >= 1
    finally:
        srv.stop()


def test_http_generate_roundtrip_and_errors(model, oracle):
    srv = InferenceServer({"flag": model}, **SERVE)
    try:
        out, headers = _post(srv.port, {"prompt": [3, 1, 4, 1],
                                        "max_new_tokens": 5})
        assert out["tokens"] == oracle([3, 1, 4, 1], 5)
        assert out["model"] == "flag" and out["ttft_s"] > 0
        assert headers.get("X-Trace-Id")
        out, headers = _post(srv.port, {"prompt": [2, 6]}, "/api/generate")
        assert len(out["tokens"]) == SERVE["max_new_tokens"]

        def err(payload, route="/api/flag/generate"):
            try:
                _post(srv.port, payload, route)
            except urllib.error.HTTPError as e:
                assert e.headers.get("X-Trace-Id") or e.code == 404
                return e.code, json.loads(e.read())
            raise AssertionError("expected an HTTP error")

        assert err({"input": [1]})[0] == 400          # wrong schema
        assert err({"prompt": "xyz"})[0] == 400       # non-tokens
        assert err({"prompt": [1] * 99})[0] == 400    # prompt too long
        assert err({"prompt": [1], "max_new_tokens": 999})[0] == 400
        code, body = err({"prompt": [1]}, "/api/nope/generate")
        assert code == 404 and "models" in body
        # the classifier route: a generate body is not its contract
        assert err({"prompt": [1]}, "/api/flag")[0] == 400
        for path in ("/healthz", "/readyz", "/metrics", "/models"):
            with urllib.request.urlopen(srv.url + path, timeout=30) as r:
                assert r.status == 200
                body = json.loads(r.read())
        assert body["flag"]["device"] == "cpu"
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())["flag"]
        assert metrics["steps"] > 0 and metrics["tokens"] > 0
    finally:
        srv.stop()


def test_metrics_declaration_idempotent():
    d1 = DecodeMetrics("torch-dual")
    d1.record_step(2, 4, 0.001)
    snap_before = d1.snapshot()
    d2 = DecodeMetrics("torch-dual")      # same name again: reuse
    assert d2.snapshot()["steps"] == 0     # baseline-scoped
    assert snap_before["steps"] == 1
    d2.record_step(1, 4, 0.002)
    assert d1.snapshot()["steps"] == 2     # same global series
    text = REGISTRY.render_prometheus()
    assert text.count("# TYPE veles_serving_decode_steps_total") == 1


def test_validation_errors(scheduler):
    for prompt, n in (([], 2), ([1] * 99, 2), ([1, 2], 0), ([1, 2], 999),
                      ([[1], [2]], 2), ([1.5, 2.25], 2), ([1, 77], 2)):
        with pytest.raises(ValueError):
            scheduler.submit(prompt, n)
