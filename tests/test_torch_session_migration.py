"""Live session migration of the port's scheduler and server, held
against the JAX package.

Mirrors the in-process tests of ``tests/test_session_migration.py`` (its
fleet tests wait for the port's router and supervisor, ROADMAP queue A
item 2), the migration tests of ``tests/test_quantized.py``,
``tests/test_prefix_kv.py`` and ``tests/test_speculative.py``, with the
port's ``DecodeScheduler`` and ``InferenceServer`` on ``device="cpu"``:

- sessions exported mid-generation import into a peer and finish with
  the oracle's tokens (the flagship: the JAX package's dense forward;
  the toy: ``generate_reference`` of both packages), through the JSON
  wire; queued requests travel prompt-only; deduped and mid-speculation
  sessions move too;
- export parks the client's future until ``release_migrated``; a failed
  import leaves the session re-importable at the source, which keeps
  its future; an int8 session refuses f32 pools by name;
- a session spills to a checkpoint and readmits with the same tokens;
- a session exported by the JAX scheduler finishes in the port with the
  JAX oracle's tokens, and the other way round (toy and flagship);
- over HTTP: ``POST /admin/sessions/{export,import,release}`` moves a
  burst from one server to another, every client is answered 307 at the
  source and its follow-up with ``session_id`` completes on the target,
  nothing answered twice or lost; ``GET /admin/sessions`` lists them;
  410 for an unknown session; 404 without ``enable_admin``;
- deadlines shed before a row is taken.

Tolerances: tokens equal.
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

from veles_tpu.serving import DecodeScheduler as JaxScheduler
from veles_tpu.serving import ToyDecodeModel as JaxToy
from veles_tpu.serving.sessions import pack_states as jax_pack_states
from veles_tpu.serving.sessions import unpack_states as jax_unpack_states
from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.serving import (DeadlineExpired, DecodeScheduler,
                                     InferenceServer, ToyDecodeModel,
                                     pack_states, unpack_states)
from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel

GEO = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32, seed=0)
GEOM = dict(max_batch=4, block_size=4, max_prompt_len=8, max_new_tokens=8)
PREFIX_GEOM = dict(max_batch=3, block_size=4, max_prompt_len=16,
                   max_new_tokens=8, prefix_caching=True,
                   prefill_chunk_tokens=4)


@pytest.fixture(scope="module")
def model():
    m = FlagshipDecodeModel(**GEO, device="cpu")
    # pin per-step wall time so exports catch sessions mid-generation
    m.step_host_delay = 0.02
    return m


@functools.lru_cache(maxsize=None)
def _jax_forward():
    params = jf.init_decode_params(**GEO)

    @jax.jit
    def fwd(tokens):
        stacked = jf._stacked(params)
        h = params["emb"][tokens][None]
        for i in range(stacked["qkv"].shape[0]):
            h, _, _ = jf._prefill_block(
                jax.tree.map(lambda p: p[i], stacked), h, 2, 1)
        return jnp.argmax(h[0] @ params["emb"].T, axis=-1)
    return fwd


@functools.lru_cache(maxsize=None)
def _oracle(prompt, n):
    tokens = list(prompt)
    for _ in range(n):
        arr = numpy.zeros(24, numpy.int32)
        arr[:len(tokens)] = tokens
        tokens.append(int(_jax_forward()(jnp.asarray(arr))
                          [len(tokens) - 1]))
    return tokens[len(prompt):]


def oracle(prompt, n):
    """The JAX package's cache-free greedy tokens of the same weights."""
    return _oracle(tuple(prompt), n)


def toy_oracle(prompt, n, vocab=31):
    want = ToyDecodeModel(vocab=vocab, device="cpu").generate_reference(
        prompt, n)
    assert want == JaxToy(vocab=vocab).generate_reference(prompt, n)
    return want


def _sched(model, name, **kw):
    return DecodeScheduler(model, name=name, device="cpu", **kw)


@pytest.fixture()
def pair(model):
    """A source/target scheduler pair over the same weights."""
    a = _sched(model, "miga", **GEOM)
    b = _sched(model, "migb", **GEOM)
    yield a, b
    a.close(drain=True)
    b.close(drain=True)


def _wait_decoding(sched, sids, timeout=60):
    """Block until each of ``sids`` has a decode row (or has finished),
    read in one job on the worker, so the export that follows cuts
    mid-generation whatever the machine's load.  Works on either
    package's scheduler."""
    def rows():
        return ({s.req.sid for s in sched._sessions.values()},
                set(sched._finished))
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        live, done = sched._run_job(rows)
        if live and all(sid in live or sid in done for sid in sids):
            return
        time.sleep(0.002)
    raise AssertionError("sessions %s never started decoding" % sids)


def _finish(target, sid, timeout=60):
    kind, val = target.attach(sid)
    return val if kind == "finished" else val.result(timeout)


def _wire(states, pack=pack_states, unpack=unpack_states):
    """Through the JSON wire, as between real replicas."""
    return unpack(json.loads(json.dumps(pack(states))))


# -- in-process migration -----------------------------------------------------

def test_live_migration_bitwise(pair):
    """Sessions exported mid-generation and imported on a peer finish
    with exactly the tokens an uninterrupted run emits."""
    a, b = pair
    rng = numpy.random.RandomState(7)
    requests = [(rng.randint(0, 32, rng.randint(1, 9)).tolist(), 8)
                for _ in range(4)]
    futures = [a.submit(p, n, session_id="s%d" % i)
               for i, (p, n) in enumerate(requests)]
    _wait_decoding(a, ["s%d" % i for i in range(4)])
    states = a.export_sessions()
    assert states, "export caught no live sessions"
    assert any(s.get("kv_k") is not None for s in states)
    exported = {s["session_id"] for s in states}
    # the source answers NOTHING until the import is confirmed
    assert all(not f.done() for i, f in enumerate(futures)
               if "s%d" % i in exported)
    done, errors = b.import_sessions(_wire(states))
    assert errors == [] and set(done) == exported
    released = a.release_migrated(done, target="127.0.0.1:1234")
    assert set(released) == exported
    for i, ((prompt, n), future) in enumerate(zip(requests, futures)):
        sid = "s%d" % i
        if sid not in exported:        # finished before the export
            assert future.result(60)["tokens"] == oracle(prompt, n)
            continue
        marker = future.result(10)
        assert marker["migrated"] and marker["target"] == "127.0.0.1:1234"
        result = _finish(b, sid)
        assert result["tokens"] == oracle(prompt, n), sid
        assert result["session_id"] == sid
    assert a.stats()["migrating_sessions"] == 0
    assert a.stats()["active_sequences"] == 0
    assert a.metrics.migrated_out == len(exported)
    assert b.metrics.migrated_in == sum(
        s.get("kv_k") is not None for s in states)


def test_failed_import_restores_source(pair):
    """A target that rejects a session (duplicate id here) leaves it
    re-importable at the source: the parked future is reused and the
    client still gets the full answer."""
    a, b = pair
    fut = a.submit([1, 2, 3], 8, session_id="dup")
    b.submit([9, 9], 8, session_id="dup")          # occupies the sid
    _wait_decoding(a, ["dup"])
    states = a.export_sessions(["dup"])
    assert len(states) == 1
    done, errors = b.import_sessions(states)
    assert done == [] and len(errors) == 1 and errors[0][0] == "dup"
    # restore: re-import at the source; the parked future is reused
    rdone, rerrors = a.import_sessions(states)
    assert rdone == ["dup"] and rerrors == []
    assert fut.result(60)["tokens"] == oracle([1, 2, 3], 8)


def test_pending_requests_migrate_as_prompt_only(pair):
    """Queued-but-unprefilled requests ride along as prompt-only
    states: the peer prefills them from scratch, same tokens."""
    a, b = pair
    # fill the batch so the 5th request stays queued
    futures = [a.submit([i + 1], 8) for i in range(GEOM["max_batch"])]
    queued = a.submit([7, 7, 7], 4, session_id="queued")
    states = a.export_sessions()
    assert "queued" in {s["session_id"] for s in states}
    assert next(s for s in states
                if s["session_id"] == "queued").get("kv_k") is None
    done, errors = b.import_sessions(_wire(states))
    assert errors == []
    a.release_migrated(done, target="peer:1")
    assert queued.result(10)["migrated"]
    assert _finish(b, "queued")["tokens"] == oracle([7, 7, 7], 4)
    for f in futures:
        r = f.result(60)
        assert r.get("migrated") or len(r["tokens"]) == 8


def test_spill_and_readmit_roundtrip(tmp_path, model):
    """A session spills to a host checkpoint (freeing its row and
    blocks) and readmits later with identical continuation."""
    import os
    s = _sched(model, "spill", **GEOM)
    try:
        fut = s.submit([3, 1, 4, 1, 5], 8, session_id="cold")
        _wait_decoding(s, ["cold"])
        path = s.spill_session("cold", str(tmp_path))
        marker = fut.result(10)
        assert marker["spilled"] and marker["path"] == path
        assert s.stats()["active_sequences"] == 0
        assert s.readmit_session(path) == "cold"
        assert _finish(s, "cold")["tokens"] == oracle([3, 1, 4, 1, 5], 8)
        # delete=True cleared the checkpoint after the readmit
        assert not os.path.exists(path)
    finally:
        s.close(drain=True)


def test_toydecode_matches_its_oracle():
    """The stand-in's decode through the paged cache equals its host
    oracle (and the JAX toy's)."""
    m = ToyDecodeModel(vocab=53, device="cpu")
    s = _sched(m, "toysched", **GEOM)
    try:
        rng = numpy.random.RandomState(3)
        for _ in range(5):
            prompt = rng.randint(0, 53, rng.randint(1, 9)).tolist()
            n = int(rng.randint(1, 9))
            assert s.submit(prompt, n).result(60)["tokens"] == \
                toy_oracle(prompt, n, vocab=53)
    finally:
        s.close(drain=True)


# -- deadlines ----------------------------------------------------------------

def test_decode_expired_submit_never_enqueues(model):
    s = _sched(model, "dl1", **GEOM)
    try:
        with pytest.raises(DeadlineExpired):
            s.submit([1, 2], 4, deadline=time.monotonic() - 0.001)
        assert s.stats()["queue_depth"] == 0
        assert s.metrics.snapshot()["expired"] == 1
    finally:
        s.close(drain=True)


def test_decode_queued_request_sheds_without_batch_row(model):
    """A request whose deadline passes IN the queue is failed at admit
    time: it never takes a batch row or KV blocks."""
    s = _sched(model, "dl2", **GEOM)
    try:
        long = [s.submit([i + 1], 8) for i in range(GEOM["max_batch"])]
        doomed = s.submit([5, 5], 8, deadline=time.monotonic() + 0.03)
        with pytest.raises(DeadlineExpired):
            doomed.result(30)
        assert s.metrics.snapshot()["expired"] == 1
        for i, f in enumerate(long):
            assert f.result(60)["tokens"] == oracle([i + 1], 8)
    finally:
        s.close(drain=True)


# -- dtypes, deduped prefixes, speculation ------------------------------------

def test_migration_refuses_dtype_mismatch_then_resumes_exact():
    slow = ToyDecodeModel(vocab=64, step_delay=0.05, device="cpu")
    kw = dict(max_batch=2, block_size=4, max_prompt_len=8,
              max_new_tokens=16)
    src = _sched(slow, "qmsrc", kv_dtype="int8", **kw)
    tgt32 = _sched(ToyDecodeModel(vocab=64, device="cpu"), "qmt32", **kw)
    tgt8 = _sched(slow, "qmt8", kv_dtype="int8", **kw)
    try:
        src.submit([9, 8, 7], 12, session_id="q")
        _wait_decoding(src, ["q"])
        states = src.export_sessions()
        assert states and states[0]["kv_dtype"] == "int8"
        done, errors = tgt32.import_sessions(states)
        assert errors and "kv_dtype mismatch" in errors[0][1], \
            (done, errors)
        done, errors = tgt8.import_sessions(states)
        assert done and not errors, (done, errors)
        src.release_migrated(done, target="qmt8")
        assert _finish(tgt8, done[0])["tokens"] == toy_oracle(
            [9, 8, 7], 12, vocab=64)
    finally:
        for s in (src, tgt32, tgt8):
            s.close(drain=True)


def test_deduped_sessions_migrate_bitwise():
    """Mid-generation sessions whose prompts share resident prefix
    blocks export through the wire and finish on the peer with exactly
    the uninterrupted tokens; the source pool drains."""
    model = ToyDecodeModel(vocab=31, step_delay=0.02, device="cpu")
    a = _sched(model, "dedupa", **PREFIX_GEOM)
    b = _sched(model, "dedupb", **PREFIX_GEOM)
    try:
        system = [2, 4, 6, 8, 1, 3, 5, 7]
        seed = system + [9]
        assert a.generate(seed, 8, timeout=60)["tokens"] == \
            toy_oracle(seed, 8)
        prompts = {"m%d" % i: system + [20 + i] for i in range(3)}
        futures = {sid: a.submit(p, 8, session_id=sid)
                   for sid, p in prompts.items()}
        _wait_decoding(a, list(prompts))
        states = a.export_sessions()
        assert states
        exported = {st["session_id"] for st in states}
        done, errors = b.import_sessions(_wire(states))
        assert errors == [] and set(done) == exported
        a.release_migrated(done, target="peer:1")
        for sid, p in prompts.items():
            if sid in exported:
                assert futures[sid].result(10)["migrated"]
                result = _finish(b, sid)
            else:
                result = futures[sid].result(60)
            assert result["tokens"] == toy_oracle(p, 8), sid
        for s in (a, b):
            assert s.kv_dump()["integrity"] == [], s.name
        stats = a.stats()
        assert stats["active_sequences"] == 0
        # the source drained: every block is free or cached, none live
        assert stats["free_blocks"] + stats["cached_blocks"] == \
            stats["num_blocks"] - 1
    finally:
        a.close(drain=True)
        b.close(drain=True)


def test_tiered_export_travels_by_hash(tmp_path):
    """With the tier stack on, a session's published lead blocks travel
    as chain keys (``kv_hash``), and a peer whose tiers hold them
    resolves them; a peer that holds none refuses the session by name
    and the source takes it back."""
    model = ToyDecodeModel(vocab=31, step_delay=0.02, device="cpu")
    kw = dict(PREFIX_GEOM, kvtier={"disk_dir": str(tmp_path / "shared")})
    a = _sched(model, "hasha", **kw)
    b = _sched(model, "hashb", **kw)               # same disk directory
    c = _sched(model, "hashc", **PREFIX_GEOM)      # no tiers, no prefix
    try:
        prompt = [2, 4, 6, 8, 1, 3, 5, 7, 11]
        fut = a.submit(prompt, 8, session_id="h")
        _wait_decoding(a, ["h"])
        states = a.export_sessions()
        assert len(states[0]["kv_hash"]) == 2       # the 2 prompt blocks
        assert len(states[0]["kv_k"][0]) == 3       # the private tail
        done, errors = c.import_sessions(_wire(states))
        assert done == [] and "cannot resolve hashed prefix" in errors[0][1]
        # b's tier is the same directory: a's chains reach it once a has
        # demoted them, so demote by hand (the pool's eviction hook)
        for key in [bytes.fromhex(h) for h in states[0]["kv_hash"]]:
            a._run_job(lambda key=key: a._demote_block(
                a._pool._by_key[key], key))
        done, errors = b.import_sessions(_wire(states))
        assert errors == [] and done == ["h"]
        a.release_migrated(done, target="hashb")
        assert fut.result(10)["migrated"]
        assert _finish(b, "h")["tokens"] == toy_oracle(prompt, 8)
        assert b.stats()["kvtier"]["disk_readmits"] == 2
    finally:
        for s in (a, b, c):
            s.close(drain=True)


def test_mid_speculation_migration_bitwise():
    """Sessions exported between speculative iterations resume on a
    peer (speculating at another depth) with exactly the uninterrupted
    stream: the exported length covers only emitted history."""
    model = ToyDecodeModel(vocab=31, step_delay=0.05,
                           draft_agreement=0.6, device="cpu")
    geom = dict(max_batch=3, block_size=4, max_prompt_len=16,
                max_new_tokens=8)
    a = _sched(model, "miga", **geom, spec_depth=2)
    b = _sched(model, "migb", **geom, spec_depth=3)
    try:
        prompts = {"m%d" % i: [2, 4, 6, 8, 1, 3, 5, 7, 20 + i]
                   for i in range(3)}
        futures = {sid: a.submit(p, 8, session_id=sid)
                   for sid, p in prompts.items()}
        _wait_decoding(a, list(prompts))
        states = a.export_sessions()
        assert states
        exported = {st["session_id"] for st in states}
        done, errors = b.import_sessions(_wire(states))
        assert errors == [] and set(done) == exported
        a.release_migrated(done, target="peer:1")
        for sid, p in prompts.items():
            if sid in exported:
                assert futures[sid].result(10)["migrated"]
                result = _finish(b, sid)
            else:
                result = futures[sid].result(60)
            assert result["tokens"] == toy_oracle(p, 8), sid
        for s in (a, b):
            assert s.kv_dump()["integrity"] == [], s.name
    finally:
        a.close(drain=True)
        b.close(drain=True)


# -- across packages ----------------------------------------------------------

def _cross(src, dst, prompts, want, src_wire, dst_wire):
    """Export ``prompts`` mid-generation from ``src``, send them through
    ``src_wire``'s pack as JSON and ``dst_wire``'s unpack into ``dst``,
    and check each finishes there with ``want``'s tokens."""
    sids = ["x%d" % i for i in range(len(prompts))]
    futures = [src.submit(p, 8, session_id=sid)
               for p, sid in zip(prompts, sids)]
    _wait_decoding(src, sids)
    states = src.export_sessions()
    assert any(s.get("kv_k") is not None for s in states)
    moved = dst_wire[1](json.loads(json.dumps(src_wire[0](states))))
    done, errors = dst.import_sessions(moved)
    assert errors == [] and len(done) == len(states)
    src.release_migrated(done, target="peer")
    for p, sid, fut in zip(prompts, sids, futures):
        result = (_finish(dst, sid) if sid in done
                  else fut.result(60))
        assert result["tokens"] == want(p, 8), sid


PORT_WIRE = (pack_states, unpack_states)
JAX_WIRE = (jax_pack_states, jax_unpack_states)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("kind", ["toy", "toy-int8", "flagship"])
def test_sessions_cross_packages(kind, direction):
    """A session exported mid-generation by one package's scheduler
    imports into the other's and finishes with the oracle's tokens."""
    kv = {"kv_dtype": "int8"} if kind == "toy-int8" else {}
    if kind == "flagship":
        port_model = FlagshipDecodeModel(**GEO, device="cpu")
        jax_model = jf.FlagshipDecodeModel(**GEO)
        want = oracle
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    else:
        port_model = ToyDecodeModel(vocab=31, device="cpu")
        jax_model = JaxToy(vocab=31)
        want = toy_oracle
        prompts = [[3, 1, 4, 1, 5, 9, 2], [6, 5]]
    port_model.step_host_delay = jax_model.step_host_delay = 0.03
    port = _sched(port_model, "xport", **GEOM, **kv)
    jax_s = JaxScheduler(jax_model, name="xjax", cache=False, **GEOM, **kv)
    try:
        if direction == "jax-to-port":
            _cross(jax_s, port, prompts, want, JAX_WIRE, PORT_WIRE)
        else:
            _cross(port, jax_s, prompts, want, PORT_WIRE, JAX_WIRE)
    finally:
        port.close(drain=True)
        jax_s.close(drain=True)


# -- over HTTP ----------------------------------------------------------------

def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_migration_burst():
    """A burst of 4 on server A moves to server B mid-generation through
    the admin endpoints: each exported client is answered 307 at A (the
    ``X-Veles-Migrated`` redirect) and its follow-up with ``session_id``
    completes on B with the oracle's tokens; a session that finished
    before the export (a loaded machine) is answered 200 at A; no
    session is answered twice or lost."""
    def server(admin=True):
        return InferenceServer(
            {"toy": ToyDecodeModel(vocab=31, step_delay=0.05,
                                   device="cpu")},
            device="cpu", enable_admin=admin, **GEOM)
    a, b, plain = server(), server(), server(admin=False)
    prompts = {"c%d" % i: [(5 * i + j) % 31 for j in range(3 + i)]
               for i in range(4)}
    answers = {}

    def client(sid):
        answers[sid] = _post(a.url + "/api/toy/generate",
                             {"prompt": prompts[sid], "max_new_tokens": 8,
                              "session_id": sid})
    try:
        threads = [threading.Thread(target=client, args=(sid,))
                   for sid in prompts]
        for t in threads:
            t.start()
        sched_a = a.registry.get("toy").scheduler
        end = time.monotonic() + 60
        while len(sched_a.session_ids()["active"]) < len(prompts):
            assert time.monotonic() < end
            time.sleep(0.005)
        _wait_decoding(sched_a, list(prompts))
        status, exp, _ = _post(a.url + "/admin/sessions/export", {})
        exported = sorted(s["session_id"] for s in exp["sessions"])
        assert status == 200 and exported and \
            exp["count"] == len(exported)
        assert all(s["model"] == "toy" and s["kv_k"]
                   for s in exp["sessions"])
        status, imp, _ = _post(b.url + "/admin/sessions/import",
                               {"sessions": exp["sessions"]})
        assert status == 200 and imp["errors"] == []
        assert sorted(imp["imported"]) == exported
        listed = _get(a.url + "/admin/sessions")["sessions"]["toy"]
        assert sorted(listed["migrating"]) == exported
        status, rel, _ = _post(a.url + "/admin/sessions/release",
                               {"session_ids": imp["imported"],
                                "target": b.url})
        assert status == 200 and sorted(rel["released"]) == exported
        for t in threads:
            t.join(60)
        for sid, prompt in prompts.items():
            status, body, headers = answers[sid]
            if sid not in exported:           # finished before the export
                assert status == 200, (sid, body)
                assert body["tokens"] == toy_oracle(prompt, 8), sid
                continue
            assert status == 307 and body["migrated"], (sid, body)
            assert headers["X-Veles-Migrated"] == sid
            assert headers["X-Veles-Session-Target"] == b.url
            status, body, _ = _post(
                b.url + "/api/toy/generate",
                {"prompt": prompt, "max_new_tokens": 8, "session_id": sid},
                {"X-Veles-Attach": "1"})
            assert status == 200, body
            assert body["tokens"] == toy_oracle(prompt, 8), sid
            assert body["session_id"] == sid
        # each answered once: nothing parked at A, nothing live at B, and
        # a second release finds nothing to answer
        assert sched_a.session_ids()["migrating"] == []
        status, rel, _ = _post(a.url + "/admin/sessions/release",
                               {"session_ids": list(prompts)})
        assert rel["released"] == []
        listed = _get(b.url + "/admin/sessions")["sessions"]["toy"]
        assert listed["active"] == [] and \
            sorted(listed["finished"]) == exported
        assert _get(b.url + "/metrics")["toy"]["migrated_in"] == \
            len(exported)
        assert _get(a.url + "/metrics")["toy"]["migrated_out"] == \
            len(exported)
        # unknown sessions: 410 on a follow, a fresh start otherwise
        status, body, _ = _post(
            a.url + "/api/toy/generate",
            {"prompt": [1, 2], "max_new_tokens": 2, "session_id": "nope"},
            {"X-Veles-Attach": "1"})
        assert status == 410 and body["session_id"] == "nope"
        status, body, _ = _post(a.url + "/api/toy/generate",
                                {"prompt": [1, 2], "max_new_tokens": 2,
                                 "session_id": "fresh"})
        assert status == 200 and body["session_id"] == "fresh"
        # importing what nobody can take is a 409
        status, body, _ = _post(
            b.url + "/admin/sessions/import",
            {"sessions": [dict(exp["sessions"][0], model="absent")]})
        assert status == 409 and "no decode model" in body["errors"][0][1]
        # the admin surface is opt-in
        status, _, _ = _post(plain.url + "/admin/sessions/export", {})
        assert status == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(plain.url + "/admin/sessions")
        assert err.value.code == 404
    finally:
        for srv in (a, b, plain):
            srv.stop()
