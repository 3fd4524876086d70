"""The tiered KV cache of the port (host RAM and disk), held against the
JAX package.

Mirrors ``tests/test_kvtier.py`` (its warm-restart test waits for the
port's compile cache, ROADMAP queue A item 3) and its int8 counterpart
in ``tests/test_quantized.py``, with the port's ``kvtier`` package,
``KVBlockPool`` and ``DecodeScheduler`` on ``device="cpu"``, and the
same numpy-seeded inputs through the JAX package:

- ``pack_block`` of the same block gives the JAX package's bytes, and
  every tier round-trips a block bitwise; a disk tier written by either
  package reads in the other;
- each tier evicts by byte capacity, the host tier cascades to disk, a
  corrupt chunk makes its chain absent, and the store's observer is
  duck-typed;
- the pool's eviction hook sees exactly the JAX pool's evictions, and
  never a referenced chain;
- a chain evicted from the pool readmits from host RAM or disk with the
  oracle's tokens and the JAX scheduler's tier counters (and bytes); "no
  re-prefill" is held by counters (disk readmits, prefill tokens), never
  by a time ratio;
- a disk tier the JAX scheduler wrote readmits in the port's;
- every ``veles_kvtier_*`` series and the TTFT-by-tier histogram move;
- every option off is the prior scheduler exactly.

Tolerances: tokens equal, tier bytes equal, tier counters equal.
"""

import os
import threading

import numpy
import pytest

from veles_tpu.kvtier import DiskTier as JaxDiskTier
from veles_tpu.serving import DecodeScheduler as JaxScheduler
from veles_tpu.serving import KVBlockPool as JaxPool
from veles_tpu.serving import ToyDecodeModel as JaxToy
from veles_tpu.serving.sessions import pack_block as jax_pack_block
from veles_tpu_torch.checkpoint.store import digest_of
from veles_tpu_torch.kvtier import (DIR_ENV, DiskTier, HostTier,
                                    PrefixDirectory, TieredKVStore,
                                    advert_key, prefix_key_header)
from veles_tpu_torch.observability.registry import REGISTRY
from veles_tpu_torch.serving import DecodeScheduler, KVBlockPool, \
    ToyDecodeModel
from veles_tpu_torch.serving.kvcache import key_chain
from veles_tpu_torch.serving.sessions import pack_block, unpack_block

GEOM = dict(max_batch=2, block_size=4, max_prompt_len=16,
            max_new_tokens=8, num_blocks=8, prefix_caching=True,
            prefill_chunk_tokens=8)


@pytest.fixture(scope="module")
def toy():
    return ToyDecodeModel(vocab=31, device="cpu")


@pytest.fixture(scope="module")
def toy_oracle(toy):
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = toy.generate_reference(prompt, n)
            assert memo[key] == JaxToy(vocab=31).generate_reference(
                prompt, n)
        return memo[key]
    return run


def _payload(rng, scale=1):
    return {"kv_k": numpy.asarray(rng.randint(0, 255, 16 * scale),
                                  dtype=numpy.uint8),
            "kv_v": rng.rand(8 * scale).astype(numpy.float32)}


def _sched(model, name, **kw):
    return DecodeScheduler(model, name=name, device="cpu", **kw)


def _churn(s, oracle, n=4, base=40):
    """Push n distinct 8-token prompts through to force eviction."""
    for i in range(n):
        filler = [(base + 5 * i + j) % 31 for j in range(8)]
        assert s.generate(filler, 4, timeout=60)["tokens"] == \
            oracle(filler, 4)


def _tier_counts(stats):
    return {k: stats[k] for k in ("demotions", "promotions",
                                  "disk_readmits", "host_blocks",
                                  "disk_blocks", "host_bytes",
                                  "disk_bytes")}


# -- wire ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "f32", "int8", "toy-int8"])
def test_pack_block_bitwise_canonical_and_as_jax(kind):
    """Identical contents give identical bytes (what lets the disk tier
    content-address across sessions, replicas and packages), the same
    bytes as the JAX package's, and unpack bitwise."""
    rng = numpy.random.RandomState(0)
    if kind == "random":
        payload = _payload(rng)
    else:
        # a flagship block (f32: [bs, H, D] per leaf; int8: data + [H]
        # scales) or a toy int8 block (its scale leaf is 0-d)
        def leaf():
            if kind == "f32":
                return [rng.standard_normal((4, 2, 8)).astype(
                    numpy.float32)]
            if kind == "int8":
                return [rng.randint(-127, 128, (4, 2, 8)).astype(
                    numpy.int8), rng.rand(2).astype(numpy.float32)]
            return [rng.randint(-127, 128, 4).astype(numpy.int8),
                    numpy.asarray(rng.rand(), numpy.float32)]
        payload = {"kv_k": leaf() + leaf(), "kv_v": leaf() + leaf()}
    data = pack_block(payload)
    assert data == jax_pack_block(payload)
    back = unpack_block(data)
    for name in payload:
        got = back[name] if kind != "random" else [back[name]]
        want = payload[name] if kind != "random" else [payload[name]]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert numpy.array_equal(g, w)
    clone = {k: (v.copy() if isinstance(v, numpy.ndarray)
                 else [a.copy() for a in v]) for k, v in payload.items()}
    assert pack_block(clone) == data


# -- host tier ----------------------------------------------------------------

def test_host_tier_lru_touch_and_spill():
    tier = HostTier(capacity_bytes=30)
    assert tier.put("a", b"x" * 10) == []
    assert tier.put("b", b"y" * 10) == []
    assert tier.put("c", b"z" * 10) == []
    assert tier.get("a") == b"x" * 10         # touch: 'a' newest now
    spilled = tier.put("d", b"w" * 10)        # 'b' is oldest -> spills
    assert spilled == [("b", b"y" * 10)]
    assert tier.used_bytes == 30 and len(tier) == 3
    assert tier.check_integrity() == []
    # a sole block bigger than capacity spills itself (never wedges)
    small = HostTier(capacity_bytes=4)
    assert small.put("big", b"q" * 10) == [("big", b"q" * 10)]
    assert len(small) == 0 and small.used_bytes == 0


# -- disk tier ----------------------------------------------------------------

def test_disk_tier_roundtrip_reopen_dedup(tmp_path):
    d = str(tmp_path / "tier")
    tier = DiskTier(d)
    tier.put("aa11", b"payload-one")
    tier.put("bb22", b"payload-two")
    tier.put("cc33", b"payload-one")          # same bytes as aa11
    assert tier.get("aa11") == b"payload-one"
    assert sorted(tier.keys()) == ["aa11", "bb22", "cc33"]
    # content addressing: two refs, ONE chunk for the shared payload
    assert len(list(tier._chunks.digests())) == 2
    assert tier.check_integrity() == []
    # a fresh instance over the same directory (the respawn path) sees
    # the same index and the same bytes, and so does the JAX package's
    again = DiskTier(d)
    assert sorted(again.keys()) == ["aa11", "bb22", "cc33"]
    assert again.get("bb22") == b"payload-two"
    jax_tier = JaxDiskTier(d)
    assert sorted(jax_tier.keys()) == ["aa11", "bb22", "cc33"]
    assert jax_tier.get("cc33") == b"payload-one"
    # and the other way round
    JaxDiskTier(str(tmp_path / "jax")).put("dd44", b"from-jax")
    assert DiskTier(str(tmp_path / "jax")).get("dd44") == b"from-jax"


def test_disk_tier_corrupt_chunk_is_absent_not_poisonous(tmp_path):
    tier = DiskTier(str(tmp_path))
    tier.put("aa11", b"precious")
    digest = digest_of(b"precious")
    with open(tier._chunks.path_for(digest), "wb") as f:
        f.write(b"bitrot")
    assert tier.get("aa11") is None           # absent, ref discarded
    assert "aa11" not in tier
    assert tier.check_integrity() == []


def test_disk_tier_capacity_drops_stalest_then_gcs(tmp_path):
    tier = DiskTier(str(tmp_path), capacity_bytes=25)
    tier.put("k0", b"0" * 10)
    tier.put("k1", b"1" * 10)
    # third insert busts 25 bytes: k0 (stalest ref) goes, chunk gc'd
    tier.put("k2", b"2" * 10)
    assert "k0" not in tier
    assert "k1" in tier and "k2" in tier
    assert tier.used_bytes <= 25
    assert tier.check_integrity() == []


# -- tiered store -------------------------------------------------------------

def test_tiered_store_requires_a_tier():
    with pytest.raises(ValueError):
        TieredKVStore()


def test_tiered_store_roundtrip_cascade_promote(tmp_path):
    rng = numpy.random.RandomState(7)
    blocks = {("%02x" % i) * 8: pack_block(_payload(rng))
              for i in range(6)}
    nbytes = len(next(iter(blocks.values())))
    store = TieredKVStore(host_bytes=2 * nbytes, disk_dir=str(tmp_path))
    for key, data in blocks.items():
        store.demote(key, data)
    # host holds the 2 newest; the other 4 cascaded to disk
    res = store.resident_keys()
    assert len(res["host"]) == 2 and len(res["disk"]) == 4
    assert store.demotions["host"] == 6 and store.demotions["disk"] == 4
    assert store.check_integrity() == []
    # every chain still round-trips bitwise, whatever tier it is on
    for key, data in blocks.items():
        tier, got = store.lookup(key)
        assert got == data, key
    # a disk hit touch-promotes: the chain is copied up into host RAM
    disk_key = next(k for k in blocks if store.tier_of(k) == "disk"
                    or k in res["disk"])
    before = store.disk_readmits
    tier, got = store.lookup(disk_key)
    if tier == "disk":                        # (may have promoted above)
        assert store.tier_of(disk_key) == "host"
        assert store.disk_readmits == before + 1
    assert store.check_integrity() == []
    # version bumps on mutation: advertisement rebuilds are gated on it
    v = store.version
    store.demote("ff" * 8, pack_block(_payload(rng)))
    assert store.version > v


def test_tiered_store_observer_is_duck_typed(tmp_path):
    calls = []

    class Obs:
        def record_tier_demotion(self, tier, nbytes):
            calls.append(("demote", tier))

        def record_disk_readmit(self):
            calls.append(("readmit", "disk"))
        # record_tier_promotion intentionally absent

    store = TieredKVStore(disk_dir=str(tmp_path), observer=Obs())
    store.demote(b"\x01" * 32, b"data")
    assert store.lookup(b"\x01" * 32) == ("disk", b"data")
    assert ("demote", "disk") in calls and ("readmit", "disk") in calls


# -- eviction hook safety -----------------------------------------------------

@pytest.mark.parametrize("pool_cls", [KVBlockPool, JaxPool],
                         ids=["port", "jax"])
def test_pool_on_evict_fires_only_for_unreferenced_chains(pool_cls):
    """The demotion hook sees exactly the refcount-0 LRU evictions the
    pool was already doing — a refcounted chain never reaches it — and
    the port's pool evicts what the JAX pool evicts."""
    def run(cls):
        pool = cls(num_blocks=7, block_size=4, prefix_caching=True)
        evicted = []
        pool.on_evict = lambda block, key: evicted.append((block, key))
        keep = pool.alloc(2)
        for i, b in enumerate(keep):
            pool.publish(b, b"keep%d" % i)    # refcount 1: pinned
        park = pool.alloc(3)
        for i, b in enumerate(park):
            pool.publish(b, b"park%d" % i)
        pool.release(park)                    # refcount 0: evictable
        assert pool.alloc(3) is not None      # pressure: evicts parked
        assert len(evicted) == 2              # 1 free + 3 cached, need 3
        assert {k for _, k in evicted} <= {b"park0", b"park1", b"park2"}
        # the referenced chains survived the pressure
        assert len(pool.acquire_prefix([b"keep0", b"keep1"])) == 2
        assert pool.check_integrity() == []
        return evicted, pool.state_dict()
    assert run(pool_cls) == run(JaxPool)


def test_pool_state_dict_roundtrip_as_jax():
    """``state_dict`` gives the JAX pool's dict after the same
    operations, and ``load_state`` of either restores an equal pool."""
    pools = [KVBlockPool(9, 4, prefix_caching=True),
             JaxPool(9, 4, prefix_caching=True)]
    for pool in pools:
        a = pool.alloc(3)
        pool.publish(a[0], b"k0")
        pool.publish(a[1], b"k1")
        pool.release([a[1]])
        pool.alloc(2)
    state = pools[1].state_dict()
    assert pools[0].state_dict() == state
    fresh = KVBlockPool(9, 4, prefix_caching=True)
    fresh.load_state(state)
    assert fresh.state_dict() == state and fresh.check_integrity() == []
    # the index state, not the lifetime tallies, is what a checkpoint
    # carries
    for attr in ("free_blocks", "live_blocks", "cached_blocks",
                 "shared_blocks"):
        assert getattr(fresh, attr) == getattr(pools[0], attr), attr
    assert sorted(fresh.resident_keys()) == sorted(
        pools[0].resident_keys())
    with pytest.raises(ValueError, match="corrupt pool state"):
        KVBlockPool(9, 4, prefix_caching=True).load_state(
            dict(state, free=state["free"] + [state["live"][0]]))


# -- prefix directory ---------------------------------------------------------

def test_prefix_directory_longest_run_ties_and_residency():
    d = PrefixDirectory()
    d.update("r1", {"hbm": ["aa"], "disk": ["bb"]})
    d.update("r0", {"host": ["aa", "bb"], "disk": ["cc"]})
    # longest consecutive LEADING run wins: r0 holds aa,bb,cc
    assert d.best_replica(["aa", "bb", "cc", "dd"]) == ("r0", 3)
    # a gap stops the run even if later keys are resident
    assert d.best_replica(["zz", "aa"]) == (None, 0)
    # candidates restrict the search to eligible replicas
    assert d.best_replica(["aa", "bb"], candidates={"r1"}) == ("r1", 2)
    # fastest tier wins per key; residency reports per-replica tiers
    d.update("r1", {"hbm": ["aa"], "disk": ["aa", "bb"]})
    assert d.residency("aa") == {"r0": "host", "r1": "hbm"}
    snap = d.snapshot()
    assert snap["r1"]["hbm"] == ["aa"] and snap["r1"]["disk"] == ["bb"]
    d.drop("r0")
    assert d.replicas() == ["r1"]
    # ties break on the smaller rid for determinism
    ties = PrefixDirectory()
    ties.update("rB", {"hbm": ["aa"]})
    ties.update("rA", {"hbm": ["aa"]})
    assert ties.best_replica(["aa"]) == ("rA", 1)


def test_advert_key_truncates_hex_and_header_as_jax():
    from veles_tpu.kvtier import prefix_key_header as jax_header
    assert advert_key(b"\xab" * 32) == "ab" * 8
    assert advert_key("ff00" * 20) == ("ff00" * 4)
    tokens = list(range(3, 40))
    assert prefix_key_header(tokens, 4) == jax_header(tokens, 4)
    assert prefix_key_header(tokens, 4, max_keys=3).count(",") == 2


# -- scheduler: demote / readmit bitwise --------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_host_tier_readmit_bitwise(toy, toy_oracle, kv_dtype):
    """A chain churned out of the pool into host RAM readmits with the
    oracle's tokens, and the port's tier counters and bytes equal the
    JAX scheduler's on the same traffic."""
    def run(sched):
        try:
            prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]  # two full blocks
            cold = sched.generate(prompt, 6, timeout=60)
            assert cold["tokens"] == toy_oracle(prompt, 6)
            _churn(sched, toy_oracle)
            assert sched.stats()["kvtier"]["demotions"]["host"] > 0
            warm = sched.generate(prompt, 6, timeout=60)
            assert warm["tokens"] == cold["tokens"]
            kstats = sched.stats()["kvtier"]
            assert kstats["promotions"]["host"] >= 2   # both lead blocks
            assert sched.kv_dump()["integrity"] == []
            return _tier_counts(kstats)
        finally:
            sched.close(drain=True)
    kw = dict(GEOM, kvtier={"host_bytes": 1 << 20},
              kv_dtype=None if kv_dtype == "f32" else kv_dtype)
    port = run(_sched(toy, "kvhost", **kw))
    jax = run(JaxScheduler(JaxToy(vocab=31), name="kvhost-jax",
                           cache=False, **kw))
    assert port == jax


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_disk_tier_readmit_bitwise_zero_reprefill(tmp_path, kv_dtype):
    """A chain evicted from the pool with ONLY a disk tier below
    readmits from disk: identical tokens, ``disk_readmits`` counted,
    and the readmitted admit prefills one token (12 of 13 prompt tokens
    come back from disk) — zero re-prefill held by counters.  The
    JAX scheduler's counters and tier bytes on the same traffic are the
    port's."""
    model = ToyDecodeModel(vocab=31, device="cpu")
    oracle = model.generate_reference

    def run(sched):
        try:
            prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]  # 3 blocks
            cold = sched.generate(prompt, 6, timeout=60)
            assert cold["tokens"] == oracle(prompt, 6)
            for i in range(4):
                filler = [(7 + 3 * i + j) % 31 for j in range(8)]
                assert sched.generate(filler, 4, timeout=60)["tokens"] == \
                    oracle(filler, 4)
            kstats = sched.stats()["kvtier"]
            assert kstats["demotions"]["disk"] > 0
            assert kstats["disk_blocks"] > 0
            before = sched.metrics.prefill_tokens
            warm = sched.generate(prompt, 6, timeout=60)
            assert warm["tokens"] == cold["tokens"] == oracle(prompt, 6)
            assert sched.metrics.prefill_tokens - before == 1
            kstats = sched.stats()["kvtier"]
            assert kstats["disk_readmits"] >= 3        # the 3 lead blocks
            assert sched._kvtier.check_integrity() == []
            return _tier_counts(kstats)
        finally:
            sched.close(drain=True)
    kw = dict(GEOM, kv_dtype=None if kv_dtype == "f32" else kv_dtype)
    port = run(_sched(model, "kvdisk", **kw,
                      kvtier={"disk_dir": str(tmp_path / "port")}))
    jax = run(JaxScheduler(JaxToy(vocab=31), name="kvdisk-jax",
                           cache=False, **kw,
                           kvtier={"disk_dir": str(tmp_path / "jax")}))
    assert port == jax


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_jax_written_disk_tier_readmits_in_the_port(tmp_path, kv_dtype):
    """A disk tier the JAX scheduler filled (its chains demoted by
    churn) is read by a fresh port scheduler over the same directory:
    the chains advertise before any traffic and readmit with the JAX
    oracle's tokens, no re-prefill."""
    tier_dir = str(tmp_path / "tier")
    kw = dict(GEOM, kv_dtype=None if kv_dtype == "f32" else kv_dtype,
              kvtier={"disk_dir": tier_dir})
    jax_model = JaxToy(vocab=31)
    prompt = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9]
    js = JaxScheduler(jax_model, name="kvwrite-jax", cache=False, **kw)
    try:
        cold = js.generate(prompt, 6, timeout=60)["tokens"]
        for i in range(4):
            js.generate([(3 + 5 * i + j) % 31 for j in range(8)], 4,
                        timeout=60)
        assert js.stats()["kvtier"]["disk_blocks"] > 0
    finally:
        js.close(drain=True)
    assert cold == jax_model.generate_reference(prompt, 6)
    s = _sched(ToyDecodeModel(vocab=31, device="cpu"), "kvread", **kw)
    try:
        adv = s.load()["kv_tiers"]
        expect = {advert_key(k) for k in key_chain(
            prompt, 4, kv_dtype=kv_dtype)}
        assert expect <= set(adv["disk"]), adv
        before = s.metrics.prefill_tokens
        again = s.generate(prompt, 6, timeout=60)
        assert again["tokens"] == cold
        assert s.metrics.prefill_tokens - before == 1
        assert s.stats()["kvtier"]["disk_readmits"] >= 3
        assert s.kv_dump()["integrity"] == []
    finally:
        s.close(drain=True)


def test_concurrent_admits_while_demoting(toy, toy_oracle):
    """Submissions racing each other over a tight pool with the tier
    stack wired: the worker serializes admit/demote/readmit, so every
    response is bitwise its oracle and every invariant holds after."""
    s = _sched(toy, "kvrace", **GEOM, kvtier={"host_bytes": 1 << 20})
    rng = numpy.random.RandomState(5)
    universe = [rng.randint(0, 31, 9).tolist() for _ in range(6)]
    failures = []

    def client(seed):
        r = numpy.random.RandomState(seed)
        for _ in range(6):
            prompt = universe[r.randint(len(universe))]
            try:
                out = s.generate(prompt, 4, timeout=60)
                if out["tokens"] != toy_oracle(prompt, 4):
                    failures.append((prompt, out["tokens"]))
            except Exception as e:        # noqa: BLE001 - collected
                failures.append((prompt, repr(e)))
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert failures == []
        assert s._pool.check_integrity() == []
        assert s._kvtier.check_integrity() == []
        assert s.stats()["kvtier"]["demotions"]["host"] > 0
    finally:
        s.close(drain=True)


# -- knobs default off --------------------------------------------------------

def test_kvtier_default_off_is_prior_behavior(toy, toy_oracle, tmp_path,
                                              monkeypatch):
    s = _sched(toy, "kvoff", **GEOM)
    try:
        prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1]
        assert s.generate(prompt, 6, timeout=60)["tokens"] == \
            toy_oracle(prompt, 6)
        assert "kvtier" not in s.stats()
        assert "kv_tiers" not in s.load()
        assert "kvtier" not in s.kv_dump()
        assert "kvtier" not in s.metrics.snapshot()
        assert s._pool.on_evict is None
    finally:
        s.close(drain=True)
    # the tier stack rides the prefix machinery; without it, refuse
    with pytest.raises(ValueError, match="prefix"):
        _sched(toy, "kvbad", max_batch=2, block_size=4, max_prompt_len=16,
               max_new_tokens=8, num_blocks=8,
               kvtier={"host_bytes": 1 << 20})
    # a disk tier without a directory reads it from DIR_ENV, or raises
    monkeypatch.delenv(DIR_ENV, raising=False)
    with pytest.raises(ValueError, match=DIR_ENV):
        _sched(toy, "kvnoenv", **GEOM, kvtier={"disk_dir": True})
    monkeypatch.setenv(DIR_ENV, str(tmp_path / "env"))
    s = _sched(toy, "kvenv", **GEOM, kvtier={"disk_dir": True})
    try:
        assert s._kvtier.disk.directory == str(tmp_path / "env")
        assert os.path.isdir(str(tmp_path / "env" / "keys"))
    finally:
        s.close(drain=True)


# -- advertisement and metrics ------------------------------------------------

def test_load_advertises_resident_tiers(toy, toy_oracle):
    s = _sched(toy, "kvadv", **GEOM, kvtier={"host_bytes": 1 << 20})
    try:
        prompt = [11, 12, 13, 14, 15, 16, 17, 18, 19]
        s.generate(prompt, 6, timeout=60)
        adv = s.load()["kv_tiers"]
        expect = {advert_key(k) for k in key_chain(prompt, 4)}
        assert expect <= set(adv["hbm"])      # resident on the device
        _churn(s, toy_oracle)
        adv = s.load()["kv_tiers"]
        assert expect & set(adv["host"])      # demoted chains re-advertise
        dump = s.kv_dump()
        assert set(dump["kvtier"]["resident"]) == {"hbm", "host"}
    finally:
        s.close(drain=True)


def _series(text, name, **labels):
    """The value of one sample of ``name`` with ``labels`` in a
    Prometheus text rendering (0.0 when absent)."""
    want = ",".join('%s="%s"' % kv for kv in sorted(labels.items()))
    for line in text.splitlines():
        if line.startswith(name + "{"):
            head, value = line.rsplit(" ", 1)
            got = ",".join(sorted(head[len(name) + 1:-1].split(",")))
            if got == want:
                return float(value)
    return 0.0


def test_kvtier_metric_series_each_move(tmp_path):
    """Every observer method the tier store calls by duck typing exists
    (a missing one would leave its counter at zero silently): after a
    host-and-disk run each ``veles_kvtier_*`` series, the TTFT-by-tier
    histogram and the snapshot's ``kvtier`` block have moved, under the
    JAX package's series names."""
    model = ToyDecodeModel(vocab=31, device="cpu")
    oracle = model.generate_reference
    s = _sched(model, "kvseries", **GEOM,
               kvtier={"host_bytes": 1, "disk_dir": str(tmp_path)})
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]
        s.generate(prompt, 6, timeout=60)
        _churn(s, oracle, base=7)
        assert s.generate(prompt, 6, timeout=60)["tokens"] == \
            oracle(prompt, 6)
        snap = s.metrics.snapshot()["kvtier"]
        assert snap["demotions"]["host"] > 0
        assert snap["demotions"]["disk"] > 0
        assert snap["promotions"]["disk"] > 0
        assert snap["disk_readmits"] > 0
        assert snap == {key: s.stats()["kvtier"][key]
                        for key in ("demotions", "promotions",
                                    "disk_readmits")}
        text = REGISTRY.render_prometheus()
        for name, labels in (
                ("veles_kvtier_demotions_total", {"tier": "host"}),
                ("veles_kvtier_demotions_total", {"tier": "disk"}),
                ("veles_kvtier_promotions_total", {"tier": "disk"}),
                ("veles_kvtier_disk_readmits_total", {}),
                ("veles_kvtier_bytes", {"tier": "disk"}),
                ("veles_serving_decode_ttft_by_tier_seconds_count",
                 {"tier": "disk"})):
            assert _series(text, name, model="kvseries", **labels) > 0, \
                (name, labels)
    finally:
        s.close(drain=True)
