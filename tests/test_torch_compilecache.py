"""The port's build cache (``veles_tpu_torch.compilecache``) and warmup
manifests, held against the JAX package's (``veles_tpu.compilecache``)
and to its own contract.

Mirrors the host-side tests of ``tests/test_compilecache.py`` where the
port has a counterpart.  The kernels build with ``nvcc``, which this
host lacks, so a stand-in ``nvcc`` (it builds a shared library with the
C entry every kernel library has, with the host's ``gcc``) drives the
real build path of ``_build`` through the cache:

- the key is stable and moves with the source, the flags and the
  toolchain (drift is a clean miss, both entries live);
- the store's atomic round trip, LRU eviction under a byte budget and
  quarantine;
- a miss builds and persists, a hit loads with no ``nvcc``, with the
  counters; an entry that fails to load is quarantined (warned once)
  and rebuilt; the cache unset builds into ``build/veles_tpu_torch/``
  exactly as before;
- schedulers: an unset cache reproduces the behavior without one, the
  manifest records and orders the warmup (decode too), a background
  warmup serves before its tail is warm, ``inject_env`` hands the cache
  to children, a mangled manifest starts empty, and a manifest written
  by either package reads in the other.

No counterpart, so no mirror: the JAX ``AotStep`` and the fused step's
cache (``test_aot_step_*``, ``test_fused_step_cache_roundtrip_bitwise_
parity``; the port's steps run eagerly until they become CUDA graphs),
the engine's JAX compilation-cache knob
(``test_backends_apply_jax_compilation_cache_knob``), and the stored-key
cross-check of a serialized executable (a library carries no key: its
file name is its content address).
"""

import ctypes
import json
import os
import time

import numpy
import pytest

from veles_tpu_torch import _build
from veles_tpu_torch import compilecache as cc
from veles_tpu_torch.compilecache import keys as keys_mod
from veles_tpu_torch.config import root
from veles_tpu_torch.observability.registry import REGISTRY

from test_torch_autotune import fake_toolkit


@pytest.fixture
def cache_dir(tmp_path):
    """A cache directory wired into config, torn back down after."""
    d = str(tmp_path / "compile_cache")
    prior = root.common.compile_cache.get("dir", None)
    root.common.compile_cache.dir = d
    cc.reset_default_caches()
    try:
        yield d
    finally:
        root.common.compile_cache.dir = prior
        cc.reset_default_caches()


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    """The stand-in ``nvcc`` first on PATH -> its log of runs."""
    env, log = fake_toolkit(tmp_path)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(keys_mod, "_nvcc_line", [])
    yield log
    keys_mod._nvcc_line.clear()


def _counter(name):
    metric = REGISTRY.get(name)
    return metric.value if metric is not None else 0.0


def _answers(lib):
    """The stand-in library's ``vt_error_string(0)``: it loaded and
    runs."""
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib.vt_error_string(0)


# -- keys ---------------------------------------------------------------------

def test_cache_key_stable_and_sensitive(monkeypatch):
    src = b"__global__ void k() {}"
    k1 = cc.cache_key(src)
    assert k1 == cc.cache_key(src.decode())
    assert cc.cache_key(src, extra={"name": "lrn"}) != k1
    assert cc.cache_key(src + b" ") != k1
    key = cc.CompileCache.key_for("lrn", src, _build.NVCC_FLAGS)
    assert key != cc.CompileCache.key_for("lrn", src, ("-O2",))
    monkeypatch.setattr(keys_mod, "toolchain_fingerprint",
                        lambda: "nvcc=99.9;flags=-O3")
    assert cc.cache_key(src) != k1


def test_environment_fingerprint_names_card_toolchain_and_sources():
    fp = cc.environment_fingerprint()
    parts = dict(kv.split("=", 1) for kv in fp.split(";") if "=" in kv)
    assert parts["torch"]
    assert parts["csrc"] == keys_mod.sources_digest()
    assert "sm_90a" in parts["flags"]
    if not _build.torch.cuda.is_available():
        assert parts["device_kind"] == "none" and parts["sms"] == "0"


# -- store --------------------------------------------------------------------

def _put(store, key, blob):
    """``blob`` stored under ``key`` as a build would leave it."""
    built = os.path.join(store.directory, "built")
    with open(built, "wb") as f:
        f.write(blob)
    try:
        return store.put_file(key, built)
    finally:
        os.unlink(built)


def _read(store, key):
    path = store.lookup(key)
    if path is None:
        return None
    with open(path, "rb") as f:
        return f.read()


def test_store_roundtrip_atomic(tmp_path):
    store = cc.ExecutableStore(str(tmp_path))
    assert store.lookup("k" * 64) is None
    assert _put(store, "k" * 64, b"payload") == 7
    assert store.lookup("k" * 64) == store.path_for("k" * 64)
    assert _read(store, "k" * 64) == b"payload"
    assert sorted(os.listdir(str(tmp_path))) == ["k" * 64 + ".so"]


def test_store_lru_eviction_respects_budget(tmp_path):
    store = cc.ExecutableStore(str(tmp_path), max_bytes=250)
    for i in range(4):
        _put(store, "key%060d" % i, b"x" * 100)
        time.sleep(0.01)
    assert store.total_bytes() <= 250
    keys = {k for k, _, _ in store.entries()}
    assert "key%060d" % 3 in keys
    assert "key%060d" % 0 not in keys


def test_store_quarantine_renames_aside(tmp_path):
    store = cc.ExecutableStore(str(tmp_path))
    _put(store, "q" * 64, b"bad")
    assert store.quarantine("q" * 64, "test")
    assert store.lookup("q" * 64) is None
    assert os.path.exists(store.path_for("q" * 64) + ".corrupt")
    assert not store.quarantine("q" * 64)


# -- the build path -----------------------------------------------------------

def test_build_miss_then_hit_with_metrics(tmp_path, toolkit):
    cache = cc.CompileCache(str(tmp_path / "cc"))
    h0, m0 = (_counter("veles_compile_cache_hits_total"),
              _counter("veles_compile_cache_misses_total"))
    runs = _build.build.nvcc_runs
    path, _ = _build.build(["lrn"], cache=cache)["lrn"]
    assert _build.build.nvcc_runs == runs + 1
    assert str(path).startswith(cache.store.directory)
    again, _ = _build.build(["lrn"], cache=cache)["lrn"]
    assert again == path and _build.build.nvcc_runs == runs + 1
    assert _counter("veles_compile_cache_misses_total") == m0 + 1
    assert _counter("veles_compile_cache_hits_total") == h0 + 1
    assert _counter("veles_compile_cache_bytes_total") > 0
    assert cache.stats()["entries"] == 1
    assert _answers(_build._load("lrn", cache)) == b"ok"
    assert len(toolkit.read_text().splitlines()) == 1


def test_corrupt_entry_rebuilds_quarantines_logs_once(tmp_path, toolkit,
                                                      caplog):
    cache = cc.CompileCache(str(tmp_path / "cc"))
    _build.build(["lrn"], cache=cache)
    (key, _, _), = cache.store.entries()
    with open(cache.store.path_for(key), "wb") as f:
        f.write(b"\x7fELF truncated garbage")
    with caplog.at_level("WARNING", logger="veles_tpu_torch.compilecache"):
        lib = _build._load("lrn", cache)
    assert _answers(lib) == b"ok"
    assert os.path.exists(cache.store.path_for(key) + ".corrupt")
    assert len([r for r in caplog.records if "corrupt" in r.message]) == 1
    assert cache.stats()["quarantined"] == 1
    assert len(toolkit.read_text().splitlines()) == 2    # rebuilt once
    runs = _build.build.nvcc_runs
    _build._load("lrn", cache)                           # a hit now
    assert _build.build.nvcc_runs == runs


def test_toolchain_drift_is_clean_miss(tmp_path, toolkit, monkeypatch):
    cache = cc.CompileCache(str(tmp_path / "cc"))
    _build.build(["lrn"], cache=cache)
    monkeypatch.setattr(keys_mod, "toolchain_fingerprint",
                        lambda: "nvcc=cuda_nvcc 99.0;flags=-O3")
    runs = _build.build.nvcc_runs
    _build.build(["lrn"], cache=cache)
    assert _build.build.nvcc_runs == runs + 1      # never a misload
    assert len(cache.store.entries()) == 2         # both keys live


def test_unset_cache_builds_into_the_build_directory(tmp_path, toolkit,
                                                     monkeypatch):
    """No cache configured: ``_build`` names and places its libraries
    exactly as without the cache."""
    assert root.common.compile_cache.get("dir", None) is None
    monkeypatch.delenv(cc.cache.CACHE_DIR_ENV, raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    cc.reset_default_caches()
    assert _build._resolve_cache(None) is None
    path, _ = _build.build(["lrn"])["lrn"]
    assert path == _build._target("lrn")[1]
    assert path.parent == tmp_path / "build" and path.exists()
    runs = _build.build.nvcc_runs
    _build.build(["lrn"])
    assert _build.build.nvcc_runs == runs


# -- serving integration ------------------------------------------------------

def _model(scale=3.0):
    from veles_tpu_torch.serving.scheduler import OpaqueModel
    return OpaqueModel(lambda x: x * scale, sample_shape=(2,))


def test_scheduler_unset_dir_reproduces_seed_behavior():
    from veles_tpu_torch.serving import BucketScheduler
    assert root.common.compile_cache.get("dir", None) is None
    sched = BucketScheduler(_model(), max_batch=8, name="cc_off",
                            device="cpu")
    try:
        assert sched._cache is None and sched._manifest is None
        stats = sched.stats()
        assert stats["compiles"] == stats["cache_hits"] == 0
        assert stats["buckets"] == [1, 2, 4, 8]
    finally:
        sched.close()


def test_manifest_records_and_orders_warmup(cache_dir):
    from veles_tpu_torch.serving import BucketScheduler
    sched = BucketScheduler(_model(), max_batch=8, name="cc_m2",
                            device="cpu")
    sched.close()
    manifest = cc.default_cache().manifest
    assert manifest.buckets("cc_m2") == [1, 2, 4, 8]
    path = os.path.join(cache_dir, "warmup_manifest.json")
    assert json.load(open(path))["models"]["cc_m2"]
    again = BucketScheduler(_model(), max_batch=8, name="cc_m2",
                            warmup=False, device="cpu")
    try:
        assert again._warmup_order() == [1, 2, 4, 8]
        manifest.forget("cc_m2")
        manifest.record("cc_m2", 4)
        assert again._warmup_order()[0] == 4
    finally:
        again.close()


def test_decode_scheduler_records_buckets_and_tuned_configs(cache_dir,
                                                            tmp_path):
    from veles_tpu_torch.autotune import dispatch, store
    from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
    tune = str(tmp_path / "tune")
    store.TuningStore(tune).put("serving.decode", "ctx16",
                                {"max_batch": 2, "block_size": 4},
                                default={"max_batch": 8, "block_size": 8},
                                speedup=1.1)
    prior = root.common.autotune.get("dir", None)
    root.common.autotune.dir = tune
    dispatch.reset_default_stores()
    try:
        s = DecodeScheduler(ToyDecodeModel(vocab=31, device="cpu"),
                            name="toy", max_prompt_len=8,
                            max_new_tokens=8, device="cpu")
        s.close()
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()
    manifest = cc.default_cache().manifest
    assert manifest.buckets("toy@prefill") == [1, 2, 4, 8]
    assert manifest.configs("toy") == {
        "serving.decode": {"max_batch": 2, "block_size": 4}}
    assert s.stats()["compiles"] == 0


def test_background_warmup_serves_before_tail_finishes(cache_dir):
    from veles_tpu_torch.serving import BucketScheduler
    BucketScheduler(_model(), max_batch=8, name="cc_m3",
                    device="cpu").close()
    sched = BucketScheduler(_model(), max_batch=8, name="cc_m3",
                            background_warmup=True, device="cpu")
    try:
        out = sched.infer(numpy.ones((1, 2), numpy.float32))
        numpy.testing.assert_allclose(out, numpy.full((1, 2), 3.0))
        assert sched.join_warmup(timeout=30.0)
        stats = sched.stats()
        assert sorted(stats["buckets"]) == [1, 2, 4, 8]
        assert len(sched._executables) == 4
        assert stats["post_warmup_compiles"] == stats["compiles"] == 0
    finally:
        sched.close()


def test_background_warmup_knob_from_config(cache_dir):
    from veles_tpu_torch.serving import BucketScheduler
    prior = root.common.compile_cache.get("background_warmup", False)
    root.common.compile_cache.background_warmup = True
    try:
        sched = BucketScheduler(_model(), max_batch=4, name="cc_bg",
                                device="cpu")
        assert sched._background_warmup
        assert sched.join_warmup(timeout=30.0)
        sched.close()
    finally:
        root.common.compile_cache.background_warmup = prior


def test_inject_env_hands_cache_to_children(tmp_path):
    prior_cc = root.common.compile_cache.get("dir", None)
    prior_tune = root.common.autotune.get("dir", None)
    try:
        root.common.compile_cache.dir = None
        root.common.autotune.dir = None
        assert cc.inject_env({"A": "1"}) == {"A": "1"}
        root.common.compile_cache.dir = str(tmp_path / "cc")
        env = cc.inject_env({})
        assert env["VELES_COMPILE_CACHE_DIR"] == str(tmp_path / "cc")
        assert env["VELES_COMPILE_CACHE_MAX_BYTES"] == str(4 << 30)
        assert "VELES_AUTOTUNE_DIR" not in env
    finally:
        root.common.compile_cache.dir = prior_cc
        root.common.autotune.dir = prior_tune


def test_manifest_survives_corruption(tmp_path):
    path = str(tmp_path / "m.json")
    m = cc.WarmupManifest(path)
    assert m.record("a", 4, sample_shape=(2, 3))
    assert not m.record("a", 4)
    assert m.record("a", 1)
    assert cc.WarmupManifest(path).buckets("a") == [1, 4]
    with open(path, "w") as f:
        f.write("{mangled json")
    m2 = cc.WarmupManifest(path)
    assert m2.buckets("a") == []
    assert m2.record("b", 2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifest_written_by_either_package_reads_in_the_other(tmp_path,
                                                               writer):
    from veles_tpu.compilecache import WarmupManifest as JaxManifest
    path = str(tmp_path / "warmup_manifest.json")
    make, read = ((cc.WarmupManifest, JaxManifest) if writer == "port"
                  else (JaxManifest, cc.WarmupManifest))
    m = make(path)
    m.record("mnist", 8, sample_shape=(784,))
    m.record("mnist", 1, sample_shape=(784,))
    m.record("toy@prefill", 4)
    m.record_config("toy", "serving.decode",
                    {"max_batch": 4, "block_size": 4})
    m.record_config("mnist", "serving.bucket_ladder",
                    {"shape": "coarse", "buckets": [1, 2, 4, 8]})
    other = read(path)
    assert other.models() == m.models() == ["mnist", "toy", "toy@prefill"]
    for model in other.models():
        assert other.buckets(model) == m.buckets(model)
        assert other.configs(model) == m.configs(model)
    with open(path) as f:
        first = f.read()
    other.record("mnist", 8)                    # known: no rewrite
    with open(path) as f:
        assert f.read() == first
