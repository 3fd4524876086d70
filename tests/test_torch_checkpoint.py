"""The port's tensor checkpoints and ``checkpoint_kv`` / ``restore_kv``,
held against the JAX package.

Mirrors ``tests/test_checkpoint.py`` (the chunk store, tensor extraction
through pickle, ``save_state`` / ``load_state``, the decode KV restore
and the workflow snapshotter's sharded backend: a bitwise continuation,
dedupe across checkpoints, resolve and gc, ``restore``'s routes into
``import_dir``, the quarantine of partials; the sharded
``restore_array`` waits for ROADMAP queue A item 11) and
the checkpoint tests of ``tests/test_quantized.py``,
``tests/test_prefix_kv.py`` and ``tests/test_speculative.py``, with the
port's ``checkpoint`` package and ``DecodeScheduler`` on
``device="cpu"``:

- the chunk store dedupes, verifies and quarantines, and its chunks and
  digests are the JAX package's; ``save_state`` of numpy and torch
  leaves loads bitwise in both packages (a torch tensor is copied at
  extraction: a later write does not reach the checkpoint);
- a scheduler cut mid-generation restores into a fresh one whose
  sequences finish with the uninterrupted tokens (the flagship: the JAX
  package's dense forward), also with shared prefix blocks, int8 pools
  and across a speculation boundary; restored pools equal the saved ones
  bit for bit;
- a checkpoint written by either package's scheduler restores in the
  other's and finishes with the oracle's tokens;
- a dtype mismatch is refused by name, a geometry mismatch with both
  geometries, a busy scheduler outright;
- a workflow checkpoint's tensors cross packages: the JAX reader reads
  every tensor of a port ``SnapshotterToShards`` checkpoint, the port's
  weights and biases among them bit for bit, and the port's reader a
  JAX checkpoint's the same way (the topology pickle names each
  package's own classes and stays with it).

Tolerances: tokens equal, tensors and pools bitwise.
"""

import functools
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.checkpoint import ChunkStore as JaxChunkStore
from veles_tpu.checkpoint import load_state as jax_load_state
from veles_tpu.checkpoint import save_state as jax_save_state
from veles_tpu.serving import DecodeScheduler as JaxScheduler
from veles_tpu.serving import ToyDecodeModel as JaxToy
from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.backends import Device
from veles_tpu_torch.checkpoint import (ChunkStore, CorruptChunkError,
                                        Manifest, SnapshotterToShards,
                                        TensorReader, TensorSink,
                                        extracting, import_dir,
                                        list_checkpoints, load_state,
                                        open_checkpoint,
                                        quarantine_partials,
                                        resolve_checkpoint, restoring,
                                        save_state)
from veles_tpu_torch.checkpoint.tensors import write_tensors
from veles_tpu_torch.memory import Array
from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
from veles_tpu_torch.snapshotter import restore
from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel

from test_torch_snapshot import build

GEO = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32, seed=0)
GEOM = dict(max_batch=4, block_size=4, max_prompt_len=8, max_new_tokens=8)
PREFIX_GEOM = dict(max_batch=3, block_size=4, max_prompt_len=16,
                   max_new_tokens=8, prefix_caching=True,
                   prefill_chunk_tokens=4)


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
def _oracle(prompt, n, pad):
    tokens = list(prompt)
    for _ in range(n):
        arr = numpy.zeros(pad, numpy.int32)
        arr[:len(tokens)] = tokens
        tokens.append(int(_jax_forward()(jnp.asarray(arr))
                          [len(tokens) - 1]))
    return tokens[len(prompt):]


def oracle(prompt, n):
    """The JAX package's cache-free greedy tokens of the same weights."""
    return _oracle(tuple(prompt), n, 80 if n > 8 else 24)


def toy_oracle(prompt, n, vocab=31):
    want = ToyDecodeModel(vocab=vocab, device="cpu").generate_reference(
        prompt, n)
    assert want == JaxToy(vocab=vocab).generate_reference(prompt, n)
    return want


def _sched(model, name, **kw):
    return DecodeScheduler(model, name=name, device="cpu", **kw)


def _wait_decoding(sched, n, timeout=60):
    """Block until ``n`` sessions hold decode rows (read in one job on
    the worker), so the cut that follows lands mid-generation."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if sched._run_job(lambda: len(sched._sessions)) >= n:
            return
        time.sleep(0.002)
    raise AssertionError("%d sessions never started decoding" % n)


def _pool_arrays(sched):
    """Every pool tensor of a scheduler of either package as numpy, in
    the leaf order."""
    if isinstance(sched, DecodeScheduler):
        return [t.numpy().copy() for t in sched._pool_tensors()]
    return [numpy.asarray(leaf) for leaf in jax.tree_util.tree_leaves(
        (sched._k_pools, sched._v_pools))]


# -- chunk store --------------------------------------------------------------

def test_chunk_store_roundtrip_and_dedupe(tmp_path):
    store = ChunkStore(str(tmp_path))
    data = numpy.arange(1000, dtype=numpy.float64)
    digest, written = store.put(data)
    assert written == data.nbytes          # bytes, not first-dim rows
    assert store.has(digest)
    again, written2 = store.put(data.copy())
    assert again == digest and written2 == 0      # content dedupe
    back = numpy.frombuffer(store.get(digest), numpy.float64)
    assert numpy.array_equal(back, data)
    # the JAX package's store names the same bytes the same and reads
    # the port's chunk
    jax_store = JaxChunkStore(str(tmp_path))
    assert jax_store.put(data) == (digest, 0)
    assert jax_store.get(digest) == store.get(digest)


def test_chunk_store_quarantines_corruption(tmp_path):
    store = ChunkStore(str(tmp_path))
    digest, _ = store.put(b"payload")
    with open(store.path_for(digest), "wb") as f:
        f.write(b"tampered")
    with pytest.raises(CorruptChunkError):
        store.get(digest)
    assert not store.has(digest)
    assert os.path.exists(store.path_for(digest) + ".corrupt")


def test_chunk_store_gc(tmp_path):
    store = ChunkStore(str(tmp_path))
    keep, _ = store.put(b"keep me")
    drop, _ = store.put(b"drop me")
    removed, freed = store.gc([keep])
    assert removed == 1 and freed == len(b"drop me")
    assert store.has(keep) and not store.has(drop)


# -- tensor extraction / restore ----------------------------------------------

@pytest.mark.parametrize("where", ["host", "device"])
def test_array_extracts_through_pickle_and_restores(tmp_path, where):
    """An ``Array``'s payload is diverted into the sink by pickle inside
    an extraction context and restored in place; a device-current value
    is copied at extraction, so a later in-place write does not reach
    the checkpoint."""
    value = numpy.random.RandomState(0).standard_normal(
        (64, 32)).astype(numpy.float32)
    arr = Array()
    arr.reset(value.copy())
    if where == "device":
        arr.initialize("cpu")
        arr.devmem = torch.from_numpy(value.copy())
    sink = TensorSink(min_bytes=1)
    with extracting(sink):
        blob = pickle.dumps(arr)
    assert sink.tensors, "payload was not diverted"
    if where == "device":
        arr.devmem.mul_(2)                     # after the extraction
    store = ChunkStore(str(tmp_path))
    entries, stats = write_tensors(store, sink, chunk_bytes=4096)
    assert stats["bytes_total"] == value.nbytes
    assert stats["chunks_written"] == value.nbytes // 4096
    reader = TensorReader(store, Manifest(tensors=entries))
    with restoring(reader):
        back = pickle.loads(blob)
    assert numpy.array_equal(back.mem, value)
    assert back.mem.dtype == numpy.float32


# -- SnapshotterToShards end to end -------------------------------------------

def test_shards_snapshot_restore_bitwise_continuation(tmp_path):
    """A checkpoint mid-training restores and continues to the
    uninterrupted run's weights bit for bit, through the async capture
    (no synchronous fallback)."""
    ref = build(6)
    ref.run()
    ref_w = [numpy.array(f.weights.map_read()) for f in ref.forwards]
    wf = build(3, tmp_path, snap_kwargs={"format": "shards",
                                         "min_tensor_bytes": 1})
    assert isinstance(wf.snapshotter, SnapshotterToShards)
    assert wf.snapshotter._async_enabled()
    wf.run()
    assert wf.snapshotter._last_write_stats_["bytes_total"] > 0
    current = str(tmp_path / "blob_current")
    assert os.path.islink(current)
    resumed = restore(current)
    assert resumed.restored_from_snapshot
    resumed.decision.max_epochs = 6
    resumed.initialize(device=Device(backend="cpu"))
    resumed.run()
    for a, f in zip(ref_w, resumed.forwards):
        b = numpy.array(f.weights.map_read())
        assert a.dtype == b.dtype and numpy.array_equal(a, b)


def test_shards_dedupe_across_checkpoints(tmp_path):
    """Exporting unchanged state again writes no new chunk bytes."""
    wf = build(2, tmp_path, snap_kwargs={"format": "shards",
                                         "min_tensor_bytes": 1,
                                         "chunk_bytes": 4096})
    wf.run()
    snap = wf.snapshotter
    stats = []
    for _ in range(2):
        snap._counter += 1
        snap.export()
        assert snap.flush()
        stats.append(dict(snap._last_write_stats_))
    assert stats[1]["bytes_written"] == 0
    assert stats[1]["chunks_deduped"] > 0
    assert stats[1]["bytes_total"] == stats[0]["bytes_total"]


def test_resolve_and_gc(tmp_path):
    wf = build(2, tmp_path, snap_kwargs={"format": "shards",
                                         "min_tensor_bytes": 1})
    wf.run()
    snap = wf.snapshotter
    ckpts = list_checkpoints(str(tmp_path))
    assert ckpts
    newest = os.path.realpath(ckpts[-1])
    for spec in (str(tmp_path), ckpts[-1],
                 os.path.join(ckpts[-1], "manifest.json")):
        assert resolve_checkpoint(spec) == newest
    removed, _ = snap.gc()
    assert removed == 0
    ckpt, man, reader = open_checkpoint(str(tmp_path))
    snap.gc(keep=[ckpt])
    for ref in man.tensors:
        reader.resolve(ref)               # the newest stays whole


def test_import_dir_via_generic_restore_routes(tmp_path):
    wf = build(2, tmp_path, snap_kwargs={"format": "shards",
                                         "min_tensor_bytes": 1})
    wf.run()
    ckpt = resolve_checkpoint(str(tmp_path))
    for spec in (ckpt, os.path.join(ckpt, "manifest.json"),
                 str(tmp_path / "blob_current")):
        assert restore(spec).restored_from_snapshot
    assert import_dir(ckpt).restored_from_snapshot


def test_quarantine_partials(tmp_path):
    torn = tmp_path / "snap.3.ckpt.tmp"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    parts = tmp_path / "snap.3.ckpt.parts"
    parts.mkdir()
    moved = quarantine_partials(str(tmp_path))
    assert len(moved) == 2
    assert not torn.exists() and not parts.exists()
    assert all(".quarantine" in m for m in moved)


def _tensors(reader, man):
    return [reader.resolve(ref) for ref in sorted(man.tensors)]


def _holds(tensors, value):
    value = numpy.asarray(value)
    return any(t.dtype == value.dtype and t.shape == value.shape and
               numpy.array_equal(t, value) for t in tensors)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_workflow_checkpoint_tensors_cross_packages(tmp_path, writer):
    """A ``SnapshotterToShards`` checkpoint of the blob workflow (every
    tensor chunked): the other package's ``open_checkpoint`` resolves
    each of its tensors, the writer's trained weights and biases among
    them bit for bit, and both readers give the same tensors."""
    from veles_tpu.checkpoint import open_checkpoint as jax_open
    if writer == "port":
        wf = build(2, tmp_path, snap_kwargs={"format": "shards",
                                             "min_tensor_bytes": 1})
    else:
        from test_snapshot_async import build as jax_build
        wf = jax_build(2, tmp_path, snap_kwargs={"format": "shards",
                                                 "min_tensor_bytes": 1})
    wf.run()
    snap = wf.snapshotter
    snap.skip = type(snap.skip)(False)
    snap.run()                          # a shot of the final weights
    assert snap.flush()
    _, man, reader = open_checkpoint(snap.destination)
    _, jman, jreader = jax_open(snap.destination)
    port_t, jax_t = _tensors(reader, man), _tensors(jreader, jman)
    assert len(port_t) == len(jax_t) > 0
    for a, b in zip(port_t, jax_t):
        assert a.dtype == b.dtype and numpy.array_equal(a, b)
    for fwd in wf.forwards:
        for value in (fwd.weights.map_read(), fwd.bias.map_read()):
            assert _holds(port_t, value)


def test_save_load_state_mixed_pytree_across_packages(tmp_path):
    """numpy and torch leaves (a 0-d one too) load bitwise, a same-name
    save replaces, and each package loads the other's checkpoint with
    the same manifest digests."""
    rng = numpy.random.RandomState(1)
    weights = rng.standard_normal((32, 16)).astype(numpy.float32)
    state = {
        "weights": weights,
        "pool": torch.from_numpy(rng.randint(-127, 128, (5, 4, 2, 8))
                                 .astype(numpy.int8)),
        "scale": torch.tensor(0.25),
        "step": 1234,
        "nested": {"ints": numpy.arange(100, dtype=numpy.int64),
                   "name": "hello"},
        "listy": [numpy.ones(7), 3.5],
    }
    path = save_state(str(tmp_path / "port"), "mixed", state,
                      chunk_bytes=256)
    for back in (load_state(path), jax_load_state(path)):
        assert back["step"] == 1234 and back["nested"]["name"] == "hello"
        assert numpy.array_equal(back["weights"], weights)
        assert back["weights"].dtype == numpy.float32
        assert numpy.array_equal(back["pool"], state["pool"].numpy())
        assert back["pool"].dtype == numpy.int8
        assert back["scale"].shape == () and back["scale"] == 0.25
        assert numpy.array_equal(back["nested"]["ints"],
                                 state["nested"]["ints"])
        assert numpy.array_equal(back["listy"][0], state["listy"][0])
    numpy_state = dict(state, pool=state["pool"].numpy(),
                       scale=state["scale"].numpy())
    jax_path = jax_save_state(str(tmp_path / "jax"), "mixed", numpy_state,
                              chunk_bytes=256)
    back = load_state(jax_path)
    assert numpy.array_equal(back["pool"], numpy_state["pool"])
    _, port_man, _ = open_checkpoint(path)
    _, jax_man, _ = open_checkpoint(jax_path)
    assert port_man.digests() == jax_man.digests()
    # same-name save replaces
    state["step"] = 5678
    assert save_state(str(tmp_path / "port"), "mixed", state) == path
    assert load_state(path)["step"] == 5678
    assert resolve_checkpoint(str(tmp_path / "port")) == path
    assert list_checkpoints(str(tmp_path / "port")) == [path]


# -- decode KV restore --------------------------------------------------------

def test_decode_kv_checkpoint_restores_identical_tokens(tmp_path):
    """Cut a serving scheduler mid-generation, restore the KV pools and
    sessions into a fresh scheduler: the resumed sequences emit exactly
    the tokens the uninterrupted run emits."""
    model = FlagshipDecodeModel(**GEO, device="cpu")
    geom = dict(max_batch=4, block_size=4, max_prompt_len=8,
                max_new_tokens=64)
    rng = numpy.random.RandomState(9)
    prompts = [rng.randint(0, 32, 6).tolist() for _ in range(3)]
    want = [oracle(p, 64) for p in prompts]

    s1 = _sched(model, "kvsrc", **geom)
    futures = [s1.submit(p, 64) for p in prompts]
    _wait_decoding(s1, 3)
    path = s1.checkpoint_kv(str(tmp_path))
    cut_active = len(load_state(path)["sessions"])
    for f, w in zip(futures, want):
        assert f.result(120)["tokens"] == w
    s1.close(drain=True)

    s2 = _sched(model, "kvdst", **geom)
    try:
        restored = s2.restore_kv(path)
        assert len(restored) == cut_active == 3
        for row, future in restored.items():
            tokens = future.result(120)["tokens"]
            assert tokens in want, "row %d diverged after restore" % row
        stats = s2.stats()
        assert stats["free_blocks"] == stats["num_blocks"] - 1
    finally:
        s2.close(drain=True)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_restored_pools_equal_the_saved_ones(tmp_path, kv_dtype):
    """An idle scheduler holding cached prefix chains checkpoints; a
    fresh one restores it with pools bit for bit the saved ones, the
    same pool accounting, and serves a resubmission from the restored
    chains with the saved run's tokens."""
    model = FlagshipDecodeModel(**GEO, device="cpu",
                                kv_dtype=kv_dtype)
    kw = dict(PREFIX_GEOM, kv_dtype=kv_dtype)
    s1 = _sched(model, "ckpool1", **kw)
    s2 = _sched(model, "ckpool2", **kw)
    try:
        prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8, 1]]
        first = [s1.generate(p, 8, timeout=60)["tokens"] for p in prompts]
        path = s1.checkpoint_kv(str(tmp_path), name="idle")
        saved = _pool_arrays(s1)
        assert s2.restore_kv(path) == {}
        got = _pool_arrays(s2)
        assert len(got) == len(saved)
        for a, b in zip(got, saved):
            assert a.dtype == b.dtype and numpy.array_equal(a, b)
        assert s2._pool.state_dict() == s1._pool.state_dict()
        assert all(t.device == torch.device("cpu")
                   for t in s2._pool_tensors())
        again = [s2.generate(p, 8, timeout=60)["tokens"] for p in prompts]
        assert again == first
        assert s2.stats()["prefix_hits"] == len(prompts)
        assert s2.kv_dump()["integrity"] == []
    finally:
        s1.close(drain=True)
        s2.close(drain=True)


def test_checkpoint_refuses_dtype_mismatch_by_name(tmp_path):
    toy = ToyDecodeModel(vocab=31, device="cpu")
    s8 = _sched(toy, "qck8", kv_dtype="int8", **GEOM)
    s8b = _sched(toy, "qck8b", kv_dtype="int8", **GEOM)
    s32 = _sched(toy, "qck32", **GEOM)
    try:
        s8.generate([9, 8, 7], 4, timeout=60)
        path = s8.checkpoint_kv(str(tmp_path))
        s8b.restore_kv(path)                     # same dtype: fine
        with pytest.raises(ValueError, match="kv_dtype mismatch"):
            s32.restore_kv(path)
    finally:
        for s in (s8, s8b, s32):
            s.close(drain=True)


def test_checkpoint_restore_with_shared_blocks(tmp_path):
    """checkpoint_kv captures the pool's shared/cached accounting;
    restore_kv resumes deduped sequences bitwise in a fresh scheduler."""
    model = ToyDecodeModel(vocab=31, step_delay=0.02, device="cpu")
    s1 = _sched(model, "ckpta", **PREFIX_GEOM)
    s2 = None
    try:
        system = [3, 1, 4, 1, 5, 9, 2, 6]
        seed = system + [8]
        assert s1.generate(seed, 8, timeout=60)["tokens"] == \
            toy_oracle(seed, 8)
        prompts = [system + [11], system + [12], [7, 7]]
        futures = [s1.submit(p, 8) for p in prompts]
        _wait_decoding(s1, 3)
        path = s1.checkpoint_kv(str(tmp_path))
        assert any(s["shared"] for s in load_state(path)["sessions"])
        # the source keeps running and still answers bitwise
        for p, f in zip(prompts, futures):
            assert f.result(60)["tokens"] == toy_oracle(p, 8)
        s2 = _sched(model, "ckptb", **PREFIX_GEOM)
        restored = s2.restore_kv(path)
        assert restored
        want = {tuple(toy_oracle(p, 8)) for p in prompts}
        got = {tuple(f.result(60)["tokens"]) for f in restored.values()}
        assert got <= want and len(got) == len(restored)
        assert s2.kv_dump()["integrity"] == []
    finally:
        s1.close(drain=True)
        if s2 is not None:
            s2.close(drain=True)


def test_restore_rejects_prefix_geometry_mismatch(tmp_path):
    toy = ToyDecodeModel(vocab=31, device="cpu")
    s1 = _sched(toy, "geoa", **PREFIX_GEOM)
    try:
        path = s1.checkpoint_kv(str(tmp_path))
    finally:
        s1.close(drain=True)
    geom = {k: v for k, v in PREFIX_GEOM.items()
            if k not in ("prefix_caching", "prefill_chunk_tokens")}
    s2 = _sched(toy, "geob", **geom)                 # prefix OFF
    try:
        with pytest.raises(ValueError, match="geometry mismatch") as err:
            s2.restore_kv(path)
        assert "'prefix_caching': True" in str(err.value)
        assert "'prefix_caching': False" in str(err.value)
    finally:
        s2.close(drain=True)


def test_restore_refuses_a_busy_scheduler(tmp_path):
    toy = ToyDecodeModel(vocab=31, step_delay=0.05, device="cpu")
    s1 = _sched(toy, "busya", **GEOM)
    s2 = _sched(toy, "busyb", **GEOM)
    try:
        path = s1.checkpoint_kv(str(tmp_path))
        fut = s2.submit([1, 2, 3], 8)
        _wait_decoding(s2, 1)
        with pytest.raises(RuntimeError, match="busy scheduler"):
            s2.restore_kv(path)
        assert fut.result(60)["tokens"] == toy_oracle([1, 2, 3], 8)
    finally:
        s1.close(drain=True)
        s2.close(drain=True)


def test_checkpoint_crosses_spec_boundary(tmp_path):
    """Speculation is a strategy, not geometry: a checkpoint taken
    mid-generation under speculation restores into a PLAIN scheduler
    and finishes with the same tokens."""
    model = ToyDecodeModel(vocab=31, step_delay=0.05,
                           draft_agreement=0.7, device="cpu")
    geom = dict(max_batch=3, block_size=4, max_prompt_len=16,
                max_new_tokens=8)
    s1 = _sched(model, "ckspeca", **geom, spec_depth=2)
    s2 = None
    try:
        prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 11], [7, 7], [8, 9, 10]]
        futures = [s1.submit(p, 8) for p in prompts]
        _wait_decoding(s1, 3)
        path = s1.checkpoint_kv(str(tmp_path))
        for p, f in zip(prompts, futures):
            assert f.result(60)["tokens"] == toy_oracle(p, 8)
        s2 = _sched(model, "ckspecb", **geom)       # spec OFF
        restored = s2.restore_kv(path)
        assert restored
        want = {tuple(toy_oracle(p, 8)) for p in prompts}
        got = {tuple(f.result(60)["tokens"]) for f in restored.values()}
        assert got <= want and len(got) == len(restored)
        assert s2.kv_dump()["integrity"] == []
    finally:
        s1.close(drain=True)
        if s2 is not None:
            s2.close(drain=True)


# -- across packages ----------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("kind", ["toy-int8", "flagship"])
def test_checkpoint_kv_across_packages(tmp_path, kind, direction):
    """A scheduler cut mid-generation by one package restores in the
    other's and finishes with the oracle's tokens."""
    kv = {"kv_dtype": "int8"} if kind == "toy-int8" else {}
    if kind == "flagship":
        port_model = FlagshipDecodeModel(**GEO, device="cpu")
        jax_model = jf.FlagshipDecodeModel(**GEO)
        want = oracle
    else:
        port_model = ToyDecodeModel(vocab=31, device="cpu")
        jax_model = JaxToy(vocab=31)
        want = toy_oracle
    port_model.step_host_delay = jax_model.step_host_delay = 0.03
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]

    def port():
        return _sched(port_model, "ckxport", **GEOM, **kv)

    def jax_s():
        return JaxScheduler(jax_model, name="ckxjax", cache=False,
                            **GEOM, **kv)
    src, dst = ((jax_s(), port()) if direction == "jax-to-port"
                else (port(), jax_s()))
    try:
        futures = [src.submit(p, 8) for p in prompts]
        _wait_decoding(src, 2)
        path = src.checkpoint_kv(str(tmp_path))
        for p, f in zip(prompts, futures):
            assert f.result(60)["tokens"] == want(p, 8)
        restored = dst.restore_kv(path)
        assert len(restored) == 2
        wanted = {tuple(want(p, 8)) for p in prompts}
        got = {tuple(f.result(60)["tokens"]) for f in restored.values()}
        assert got == wanted
        assert dst.kv_dump()["integrity"] == []
    finally:
        src.close(drain=True)
        dst.close(drain=True)
