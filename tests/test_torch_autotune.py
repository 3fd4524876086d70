"""The port's autotuner (``veles_tpu_torch.autotune``), held against the
JAX package's (``veles_tpu.autotune``) and to its own contract.

Mirrors the host-side tests of ``tests/test_autotune.py`` one for one
where the port has a counterpart, on ``device="cpu"``:

- every site's default is its first candidate and each kernel site's
  default is the port's own constant or rule (read from the CUDA
  source where the rule lives there); the ten site names, the serving
  sites' parameters, defaults and shape classes, ``ladder()`` and
  ``pow2_bucket()`` equal the JAX package's;
- the store round trip, quarantine (warned once), wrong identity
  fields, version drift as a clean miss, and a record the JAX package
  wrote: a clean miss here, never a misload;
- the tuner off resolves with no disk access, ``enabled=False`` wins
  over a configured directory, hits and fallbacks count, grown params
  merge; the LRN unit, K4's split, K1/K2's plan and the flash tiles
  dispatch a tuned record and revert with the tuner off;
- the runner: fast-but-wrong never wins, no viable candidate keeps the
  default, the speedup is relative to the default candidate, a timed
  out probe's whole process group dies, a real subprocess tune (per
  candidate and batched) persists a gated winner;
- serving: the tuned ladder, explicit buckets, the decode geometry,
  ``"auto"`` chunk / depth / KV dtype, each picked the same in both
  packages from the same record, tokens equal on ``ToyDecodeModel``;
- the CLI's subcommands and exit codes, and one cross-process restart:
  a second ``python -c`` with the same directories resolves ``"tuned"``,
  builds nothing (a stand-in ``nvcc`` counts the builds) and leaves the
  tuning store as it was.

No test asserts a time ratio.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy
import pytest
import torch

from veles_tpu_torch.autotune import dispatch, runner, space, store
from veles_tpu_torch.compilecache import keys as keys_mod
from veles_tpu_torch.config import root
from veles_tpu_torch.observability.registry import REGISTRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def tune_dir(tmp_path):
    """A tuning store wired into config, torn back down after."""
    d = str(tmp_path / "autotune")
    prior = root.common.autotune.get("dir", None)
    root.common.autotune.dir = d
    dispatch.reset_default_stores()
    try:
        yield d
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()


def _counter(name):
    metric = REGISTRY.get(name)
    return metric.value if metric is not None else 0.0


def _put_lrn(st, shape_class="c96_n5", impl="band"):
    return st.put("lrn", shape_class, {"impl": impl},
                  default={"impl": "kernel"}, speedup=1.3,
                  baseline_s=1e-3, best_s=8e-4, candidates_tried=2)


SITE_CTXS = {"lrn": {"rows": 2048, "c": 96, "n": 5},
             "flash_attention": {"t": 1024, "d": 64, "causal": True},
             "window_attention": {"t": 1024, "d": 64, "window": 256},
             "precise_gemm": {"m": 60, "k": 784, "n": 100, "level": 1},
             "paged_attention": {"batch": 32, "heads": 8, "d": 128,
                                 "block_size": 8, "max_blocks": 128},
             "serving.bucket_ladder": {"max_batch": 16},
             "serving.decode": {"max_context": 64},
             "serving.prefill_chunk": {"max_prompt_len": 64},
             "serving.spec_depth": {"max_new_tokens": 32},
             "serving.kv_dtype": {"max_context": 64}}
SERVING_SITES = ("serving.bucket_ladder", "serving.decode",
                 "serving.prefill_chunk", "serving.spec_depth",
                 "serving.kv_dtype")


# -- search space -------------------------------------------------------------

def test_every_site_default_is_its_own_first_candidate():
    from veles_tpu.autotune import space as jax_space
    assert set(SITE_CTXS) == set(space.SITES) == set(jax_space.SITES)
    for name, ctx in SITE_CTXS.items():
        sp = space.site(name)
        cands = sp.candidates(ctx)
        assert cands[0] == sp.default, name
        assert len(cands) == len({json.dumps(c, sort_keys=True)
                                  for c in cands}), name  # deduped
        assert len(cands) >= 2, name        # something to choose from
        for c in cands:
            assert sp.valid(c, ctx), (name, c)


def _cuda_plan(src, struct, dmax, key):
    m = re.search(r"struct %s<%d> \{\s*static constexpr int ([^;]*);"
                  % (struct, dmax), src)
    fields = dict(f.split(" = ") for f in m.group(1).split(", "))
    return int(fields[key])


def test_space_defaults_match_kernel_constants():
    """The declared defaults ARE what the port does without a tuner — if
    a constant or rule drifts, the tuner-off path would change."""
    from veles_tpu_torch.serving import decode
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz import paged_attention as pa
    assert space.site("lrn").default == {"impl": "kernel"}
    assert space.site("precise_gemm").default == {"split": "rule"}
    assert space.PRECISE_TILE_K == gemm.DEFAULT_BLOCK_K
    assert space.site("paged_attention").default == {
        "block_size": pa.DEFAULT_BLOCK_SIZE, "split": "rule"}
    assert space.PAGED_MAX_SPLIT_BLOCKS == pa._MAX_SPLIT_BLOCKS
    assert space.site("serving.decode").default == {
        "max_batch": decode.DEFAULT_MAX_BATCH,
        "block_size": pa.DEFAULT_BLOCK_SIZE}
    assert space.site("serving.prefill_chunk").default == {
        "chunk_tokens": decode.DEFAULT_PREFILL_CHUNK}
    assert space.site("serving.spec_depth").default == {
        "spec_depth": decode.DEFAULT_SPEC_DEPTH}
    # the flash tiles: the plans of csrc/flash_attention.cu
    with open(os.path.join(ROOT, "veles_tpu_torch", "csrc",
                           "flash_attention.cu")) as f:
        src = f.read()
    for dmax in (32, 64, 128, 256):
        fwd = 64 if dmax == 32 else 32          # FwdPlan's BK rule
        assert re.search(r"template <int DMAX, int BK = DMAX == 32 \? 64 "
                         r": 32>\nstruct FwdPlan", src)
        assert space.FLASH_TILES[dmax] == (
            fwd, _cuda_plan(src, "DqPlan", dmax, "kBK"),
            _cuda_plan(src, "DkvPlan", dmax, "kBQ")), dmax
    wide = re.search(r"constexpr int kFwdWideBK = (\d+), kDqWideBK = "
                     r"(\d+), kDkvWideBQ = (\d+);", src)
    assert space.FLASH_TILES["wide"] == tuple(map(int, wide.groups()))
    alt = re.search(r"constexpr int kAltTile64\[3\] = \{(\d+), (\d+), "
                    r"(\d+)\};", src)
    assert tuple(zip(*[tuple(map(int, alt.groups()))])) == \
        space.FLASH_ALT_TILES[64]
    assert space.site("flash_attention").default == \
        space.flash_plan_tiles(64) == \
        space.site("window_attention").default
    # K4's unit of compensation in its source
    with open(os.path.join(ROOT, "veles_tpu_torch", "csrc",
                           "precise_matmul.cu")) as f:
        assert "constexpr int kBK = %d;" % space.PRECISE_TILE_K in f.read()


def test_serving_site_defaults_equal_the_jax_package():
    from veles_tpu.autotune import space as jax_space
    ctxs = [{"max_batch": 16, "max_context": 64, "max_prompt_len": 64,
             "max_new_tokens": 32},
            {"max_batch": 100, "max_context": 300, "max_prompt_len": 128,
             "max_new_tokens": 3}, {"max_batch": 1}]
    for name in SERVING_SITES:
        ours, theirs = space.site(name), jax_space.site(name)
        assert ours.params == theirs.params, name
        assert ours.default == theirs.default, name
        assert ours.error_bound == theirs.error_bound, name
        for ctx in ctxs:
            assert ours.candidates(ctx) == theirs.candidates(ctx), name
            if name == "serving.bucket_ladder" or len(ctx) > 1:
                assert ours.shape_class(ctx) == \
                    theirs.shape_class(ctx), name


def test_ladder_and_pow2_bucket_equal_the_jax_package():
    from veles_tpu.autotune import space as jax_space
    for shape in ("pow2", "coarse", "dense"):
        for mb in range(1, 257):
            assert space.ladder(shape, mb) == jax_space.ladder(shape, mb), \
                (shape, mb)
    for n in list(range(-2, 1100)) + [4095, 4096, 4097, 1 << 20]:
        assert space.pow2_bucket(n) == jax_space.pow2_bucket(n), n
    with pytest.raises(ValueError):
        space.ladder("pow2", 0)
    with pytest.raises(ValueError):
        space.ladder("spiral", 8)


def test_ladder_pow2_is_byte_identical_to_bucket_sizes():
    from veles_tpu_torch.serving.scheduler import bucket_sizes
    for mb in (1, 2, 3, 8, 16, 48, 64, 100):
        assert space.ladder("pow2", mb) == bucket_sizes(mb), mb


def test_ladder_shapes_end_at_max_batch_and_start_at_one():
    for shape in ("pow2", "coarse", "dense"):
        for mb in (1, 4, 16, 64):
            sizes = space.ladder(shape, mb)
            assert sizes[0] == 1 and sizes[-1] == mb, (shape, mb)
            assert sizes == sorted(set(sizes))


def test_constraints_filter_invalid_candidates():
    # only the instantiated tiles launch: one plan past head dim 64
    flash = space.site("flash_attention")
    assert len(flash.candidates({"t": 512, "d": 64})) == 8
    for d in (16, 128, 256, 300):
        assert flash.candidates({"t": 512, "d": d}) == \
            [space.flash_plan_tiles(d)], d
    # K4's split runs: fewer than the K tiles, within the workspace cap
    gemm_site = space.site("precise_gemm")
    for ctx in ({"m": 60, "k": 784, "n": 100}, {"m": 4096, "k": 4096,
                                                "n": 4096}):
        tiles = -(-ctx["k"] // 256)
        for c in gemm_site.candidates(ctx):
            if isinstance(c["split"], int):
                assert c["split"] < tiles
                assert tiles * ctx["m"] * ctx["n"] <= space.PRECISE_MAX_WS
    assert [c["split"] for c in gemm_site.candidates(
        {"m": 4, "k": 256, "n": 4})] == ["rule", "none"]
    # K1/K2: the pools' block size; a split's blocks fit a CTA
    paged = space.site("paged_attention")
    ctx = {"batch": 2, "heads": 2, "d": 16, "block_size": 4,
           "max_blocks": 300}
    for c in paged.candidates(ctx)[1:]:
        assert c["block_size"] == 4
        assert -(-300 // c["split"]) <= space.PAGED_MAX_SPLIT_BLOCKS
    assert paged.shape_class(dict(ctx, quantized=True)) == \
        "h2_d16_len2048_b2_bs4_int8"


# -- store --------------------------------------------------------------------

def test_store_roundtrip_schema_and_provenance(tmp_path):
    st = store.TuningStore(str(tmp_path))
    rec = _put_lrn(st)
    got = st.get("lrn", "c96_n5")
    assert got == rec
    for field in store._REQUIRED:
        assert field in got, field
    assert got["schema"] == store.SCHEMA == 1
    assert got["fingerprint"] == store.environment_fingerprint()
    assert got["torch"] == torch.__version__
    assert got["device_kind"] != "?"
    assert all(".tmp" not in f for f in os.listdir(str(tmp_path)))


def test_corrupt_record_quarantines_falls_back_and_warns_once(
        tmp_path, caplog):
    st = store.TuningStore(str(tmp_path))
    _put_lrn(st)
    key = store.record_key("lrn", "c96_n5")
    path = st.path_for(key)
    with open(path, "w") as f:
        f.write("{ not json")
    corrupt_before = _counter("veles_autotune_corrupt_total")
    with caplog.at_level("WARNING", logger="veles_tpu_torch.autotune"):
        assert st.get("lrn", "c96_n5") is None
        assert st.get("lrn", "c96_n5") is None
    assert len([r for r in caplog.records if "corrupt" in r.message]) == 1
    assert not os.path.exists(path)
    assert os.path.exists(path + ".corrupt")
    assert _counter("veles_autotune_corrupt_total") == corrupt_before + 1


def test_wrong_identity_fields_are_rejected(tmp_path):
    st = store.TuningStore(str(tmp_path))
    rec = _put_lrn(st)
    key = store.record_key("lrn", "c96_n5")
    with open(st.path_for(key), "w") as f:
        json.dump(dict(rec, site="flash_attention"), f)
    assert st.get("lrn", "c96_n5") is None


def test_version_drift_is_clean_miss_never_misload(tmp_path, monkeypatch):
    st = store.TuningStore(str(tmp_path))
    _put_lrn(st)
    assert st.get("lrn", "c96_n5") is not None
    monkeypatch.setattr(keys_mod, "environment_fingerprint",
                        lambda: "torch=9.9.9;cuda=99.9;device_kind=H900")
    assert st.get("lrn", "c96_n5") is None
    assert not any(f.endswith(".corrupt")
                   for f in os.listdir(str(tmp_path)))
    monkeypatch.undo()
    assert st.get("lrn", "c96_n5") is not None


def test_jax_written_record_is_a_clean_miss_never_a_misload(tmp_path):
    """A record the JAX package wrote keys on its own (jax) fingerprint:
    the port finds no record under its key, and quarantines nothing.
    The same file forced under the port's key is rejected by its
    fingerprint field, never served."""
    from veles_tpu.autotune import store as jax_store
    jst = jax_store.TuningStore(str(tmp_path))
    jst.put("serving.decode", "ctx16", {"max_batch": 4, "block_size": 4},
            default={"max_batch": 8, "block_size": 8}, speedup=1.2)
    st = store.TuningStore(str(tmp_path))
    assert st.get("serving.decode", "ctx16") is None
    assert not any(f.endswith(".corrupt")
                   for f in os.listdir(str(tmp_path)))
    (jkey, jrec, _), = jst.records()
    assert jrec["config"] == {"max_batch": 4, "block_size": 4}
    ours = store.record_key("serving.decode", "ctx16")
    with open(os.path.join(str(tmp_path), jkey + store.SUFFIX)) as f:
        text = f.read()
    with open(st.path_for(ours), "w") as f:
        f.write(text)
    assert st.get("serving.decode", "ctx16") is None
    assert os.path.exists(st.path_for(ours) + ".corrupt")


def test_store_records_lists_corrupt_without_quarantining(tmp_path):
    st = store.TuningStore(str(tmp_path))
    _put_lrn(st)
    key = store.record_key("lrn", "c96_n5")
    with open(st.path_for(key), "w") as f:
        f.write("garbage")
    (k, rec, reason), = st.records()
    assert k == key and rec is None and reason
    assert os.path.exists(st.path_for(key))


# -- dispatch -----------------------------------------------------------------

def test_tuner_off_returns_exact_default_no_disk_access(monkeypatch):
    prior = root.common.autotune.get("dir", None)
    monkeypatch.delenv(dispatch.AUTOTUNE_DIR_ENV, raising=False)

    def no_store(*_a, **_k):
        raise AssertionError("the tuner off touched a store")

    monkeypatch.setattr(dispatch, "TuningStore", no_store)
    try:
        root.common.autotune.dir = None
        dispatch.reset_default_stores()
        default = {"impl": "kernel"}
        cfg, src = dispatch.resolve("lrn", "c96_n5", default=default)
        assert src == "default" and cfg == default
        assert cfg is not default
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()


def test_enabled_false_overrides_configured_dir(tune_dir):
    _put_lrn(store.TuningStore(tune_dir))
    prior = root.common.autotune.get("enabled", True)
    try:
        root.common.autotune.enabled = False
        dispatch.reset_default_stores()
        cfg, src = dispatch.resolve("lrn", "c96_n5",
                                    default={"impl": "kernel"})
        assert src == "default" and cfg["impl"] == "kernel"
    finally:
        root.common.autotune.enabled = prior
        dispatch.reset_default_stores()


def test_tuned_record_resolves_and_counts(tune_dir):
    _put_lrn(store.TuningStore(tune_dir))
    hits = _counter("veles_autotune_tuned_hits_total")
    cfg, src = dispatch.resolve("lrn", "c96_n5", default={"impl": "kernel"})
    assert src == "tuned" and cfg["impl"] == "band"
    assert _counter("veles_autotune_tuned_hits_total") == hits + 1
    dispatch.resolve("lrn", "c96_n5", default={"impl": "kernel"})
    assert _counter("veles_autotune_tuned_hits_total") == hits + 1


def test_miss_counts_fallback_and_merges_grown_params(tune_dir):
    st = store.TuningStore(tune_dir)
    st.put("flash_attention", "t1024_d64_causal", {"fwd_block_k": 64},
           default=space.flash_plan_tiles(64), speedup=1.1)
    falls = _counter("veles_autotune_fallbacks_total")
    cfg, src = dispatch.resolve("flash_attention", "t2048_d64_causal",
                                default=space.flash_plan_tiles(64))
    assert src == "default"
    assert _counter("veles_autotune_fallbacks_total") == falls + 1
    cfg, src = dispatch.resolve("flash_attention", "t1024_d64_causal",
                                default=space.flash_plan_tiles(64))
    assert src == "tuned"
    assert cfg == dict(space.flash_plan_tiles(64), fwd_block_k=64)


class _OnTheCard:
    """A stand-in device: the LRN unit's choice asks only its backend."""
    BACKEND = "cuda"


def test_lrn_unit_dispatches_tuned_impl_and_reverts_when_off(tune_dir):
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.lrn import LRNormalizerForward
    _put_lrn(store.TuningStore(tune_dir))
    unit = LRNormalizerForward(Workflow(None))
    unit.device = _OnTheCard()
    assert unit._resolved_use_pallas(96) is False      # the band form
    assert unit.config_source == "tuned"
    assert unit._resolved_use_pallas(32) is True       # no record
    assert unit.config_source == "default"
    forced = LRNormalizerForward(Workflow(None), use_pallas=True)
    forced.device = _OnTheCard()
    assert forced._resolved_use_pallas(96) is True
    assert forced.config_source == "explicit"
    prior = root.common.autotune.get("dir", None)
    try:
        root.common.autotune.dir = None
        dispatch.reset_default_stores()
        assert unit._resolved_use_pallas(96) is True   # the kernel pair
        assert unit.config_source == "default"
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()


def test_kernel_plans_of_site_choices():
    """K4's split runs and K1/K2's plans for each kind of choice (the
    kernels' own rules need the card; the fixed choices do not)."""
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz import paged_attention as pa
    assert gemm.split_runs("none", 60, 100, 784, CPU) == 0
    assert [gemm.split_runs(v, 60, 100, 784, CPU) for v in (1, 2, 3)] == \
        [4, 2, 2]
    rule = pa.paged_attention_plan(32, 8, 128, 8, 128, 132)
    assert pa.plan_for_split("rule", 32, 8, 128, 8, 128, 132) == rule
    assert pa.plan_for_split(4, 32, 8, 128, 8, 128, 132) == \
        pa.PagedPlan(4, 32, rule.tile)
    assert pa.plan_for_split(3, 2, 2, 16, 4, 10, 132).split == 3
    with pytest.raises(ValueError, match="past the kernel"):
        pa.plan_for_split(1, 2, 2, 16, 4, 300, 132)


def test_flash_tiles_resolve_the_attention_sites(tune_dir):
    from veles_tpu_torch.znicz import flash_attention as fa
    q = torch.zeros((1, 1000, 2, 64))
    assert fa.flash_tiles(q, causal=True) == space.flash_plan_tiles(64)
    assert fa.flash_tiles(torch.zeros((1, 8, 1, 200))) == \
        space.flash_plan_tiles(200)
    st = store.TuningStore(tune_dir)
    tuned = {"fwd_block_k": 64, "dq_block_k": 16, "dkv_block_q": 32}
    st.put("flash_attention", "t1024_d64_causal", tuned,
           default=space.flash_plan_tiles(64), speedup=1.1)
    st.put("window_attention", "t1024_d64_w128", dict(tuned,
                                                      dkv_block_q=16),
           default=space.flash_plan_tiles(64), speedup=1.1)
    dispatch.reset_default_stores()
    assert fa.flash_tiles(q, causal=True) == tuned
    assert fa.flash_tiles(q, causal=False) == space.flash_plan_tiles(64)
    assert fa.flash_tiles(q, True, 128)["dkv_block_q"] == 16


# -- runner -------------------------------------------------------------------

def test_fast_but_wrong_candidate_can_never_win(tune_dir):
    def fake_measure(site, config, ctx):
        if config["impl"] == "band":
            return {"ok": True, "config": config,
                    "gate": "failed:max_err=1", "score": 0.01,
                    "cand_s": 1e-6, "ref_s": 1e-4}
        return {"ok": True, "config": config, "gate": "passed",
                "score": 1.0, "cand_s": 1e-4, "ref_s": 1e-4}
    gate_failures = _counter("veles_autotune_gate_failures_total")
    rec = runner.tune_site("lrn", {"rows": 2048, "c": 96, "n": 5},
                           store=store.TuningStore(tune_dir),
                           measure=fake_measure)
    assert rec["config"]["impl"] == "kernel"
    assert rec["gate"] == "passed"
    assert _counter("veles_autotune_gate_failures_total") > gate_failures


def test_no_viable_candidate_keeps_default(tune_dir):
    rec = runner.tune_site(
        "lrn", {"rows": 2048, "c": 96, "n": 5},
        store=store.TuningStore(tune_dir),
        measure=lambda s, c, x: {"ok": False, "error": "boom"})
    assert rec is None
    assert store.TuningStore(tune_dir).get("lrn", "c96_n5") is None
    assert dispatch.resolve("lrn", "c96_n5",
                            default={"impl": "kernel"})[1] == "default"


def test_speedup_is_relative_to_default_candidate(tune_dir):
    def fake_measure(site, config, ctx):
        score = 1.0 if config["fwd_block_k"] == 64 else 2.0
        return {"ok": True, "config": config, "gate": "passed",
                "score": score, "cand_s": score * 1e-4, "ref_s": 1e-4}
    rec = runner.tune_site("flash_attention",
                           {"t": 1024, "d": 64, "causal": True},
                           store=store.TuningStore(tune_dir),
                           measure=fake_measure)
    assert rec["config"]["fwd_block_k"] == 64
    assert rec["speedup"] == pytest.approx(2.0)
    assert rec["default"] == space.flash_plan_tiles(64)


def test_run_isolated_kills_whole_process_group(tmp_path):
    pidfile = str(tmp_path / "grandchild.pid")
    script = textwrap.dedent("""
        import subprocess, sys, time
        p = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
        open(%r, "w").write(str(p.pid))
        time.sleep(600)
    """ % pidfile)
    t0 = time.perf_counter()
    rc, out, err, timed_out = runner.run_isolated(
        [sys.executable, "-c", script], timeout=3.0)
    assert timed_out
    assert time.perf_counter() - t0 < 30
    deadline = time.time() + 10
    gpid = int(open(pidfile).read())
    while time.time() < deadline:
        try:
            os.kill(gpid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.2)
    else:
        os.kill(gpid, 9)
        pytest.fail("grandchild outlived the process-group kill")


@pytest.mark.parametrize("batch", [False, True])
def test_real_subprocess_lrn_tune_end_to_end(tune_dir, batch):
    """The whole pipeline, no injection: fresh-subprocess probes (one
    per candidate, or one for the site), the gate, the persist."""
    env = dict(os.environ)
    env.pop(dispatch.AUTOTUNE_DIR_ENV, None)
    st = store.TuningStore(tune_dir)
    rec = runner.tune_site("lrn", {"rows": 64, "c": 8, "n": 3,
                                   "device": "cpu"},
                           store=st, timeout=120, env=env, batch=batch)
    assert rec is not None and rec["gate"] == "passed"
    assert st.get("lrn", "c8_n3")["config"] == rec["config"]
    assert rec["candidates_tried"] == 2
    assert rec["baseline_s"] > 0 and rec["best_s"] > 0


def test_probe_gates_each_kernel_site_against_its_plain_version():
    """Every kernel probe runs on the CPU (the plain versions), gates
    and times; a probe without a device asks for the card."""
    from veles_tpu_torch.autotune import probe
    ctxs = {"precise_gemm": {"m": 20, "k": 600, "n": 30},
            "paged_attention": {"batch": 2, "heads": 2, "d": 16,
                                "block_size": 8, "max_blocks": 6,
                                "quantized": True},
            "flash_attention": {"b": 1, "t": 40, "h": 2, "d": 16},
            "window_attention": {"b": 1, "t": 40, "h": 1, "d": 16,
                                 "window": 8},
            "lrn": {"rows": 30, "c": 12, "n": 5}}
    for name, ctx in ctxs.items():
        ctx = dict(ctx, device="cpu")
        for config in space.site(name).candidates(ctx)[:2]:
            out = probe.measure(name, config, ctx, reps=1, windows=1)
            assert out["ok"], (name, out.get("error"))
            assert out["gate"] == "passed", (name, out)
            assert out["score"] > 0
    bad = probe.measure("lrn", {"impl": "kernel"}, {"rows": 4, "c": 4},
                        reps=1, windows=1)
    if not torch.cuda.is_available():
        assert not bad["ok"] and "CUDA" in bad["error"]


# -- serving integration ------------------------------------------------------

def test_scheduler_resolves_tuned_ladder_and_records_manifest(tune_dir,
                                                              tmp_path):
    from veles_tpu_torch.compilecache import WarmupManifest
    from veles_tpu_torch.serving.scheduler import BucketScheduler
    store.TuningStore(tune_dir).put(
        "serving.bucket_ladder", "mb16", {"shape": "coarse"},
        default={"shape": "pow2"}, speedup=1.2)
    dispatch.reset_default_stores()
    manifest = str(tmp_path / "manifest.json")
    s = BucketScheduler(lambda x: x * 2.0, max_batch=16, sample_shape=(4,),
                        cache=False, manifest=manifest, device="cpu")
    try:
        assert s.config_source == "tuned"
        assert s.buckets == space.ladder("coarse", 16) == [1, 4, 8, 16]
        out = s.submit(numpy.ones((3, 4), numpy.float32)).result(30)
        assert numpy.allclose(out, 2.0)
        assert s.stats()["bucket_config"]["config_source"] == "tuned"
    finally:
        s.close()
    cfg = WarmupManifest(manifest).configs("default")
    assert cfg["serving.bucket_ladder"]["buckets"] == [1, 4, 8, 16]
    assert WarmupManifest(manifest).buckets("default") == [1, 4, 8, 16]


def test_scheduler_explicit_buckets_and_off_path(tune_dir):
    from veles_tpu_torch.serving.scheduler import (BucketScheduler,
                                                   bucket_sizes)
    s = BucketScheduler(lambda x: x + 1.0, max_batch=8, sample_shape=(4,),
                        cache=False, warmup=False, buckets=[1, 8],
                        device="cpu")
    assert s.config_source == "explicit" and s.buckets == [1, 8]
    s.close()
    with pytest.raises(ValueError):
        BucketScheduler(lambda x: x, max_batch=8, sample_shape=(4,),
                        cache=False, warmup=False, buckets=[2, 4],
                        device="cpu")
    prior = root.common.autotune.get("dir", None)
    try:
        root.common.autotune.dir = None
        dispatch.reset_default_stores()
        s2 = BucketScheduler(lambda x: x + 1.0, max_batch=8,
                             sample_shape=(4,), cache=False,
                             warmup=False, device="cpu")
        assert s2.config_source == "default"
        assert s2.buckets == bucket_sizes(8)
        s2.close()
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()


def _both_packages_put(tmp_path, site, shape_class, config, default):
    """The same winner written by each package's own store (each keys
    on its own fingerprint), into one directory per package."""
    from veles_tpu.autotune import store as jax_store
    dirs = (str(tmp_path / "port"), str(tmp_path / "jax"))
    store.TuningStore(dirs[0]).put(site, shape_class, config,
                                   default=default, speedup=1.2)
    jax_store.TuningStore(dirs[1]).put(site, shape_class, config,
                                       default=default, speedup=1.2)
    return dirs


@pytest.fixture
def both_dirs(tmp_path):
    """Point both packages' tuners at their own directories."""
    from veles_tpu.autotune import dispatch as jax_dispatch
    from veles_tpu.config import root as jax_root
    priors = (root.common.autotune.get("dir", None),
              jax_root.common.autotune.get("dir", None))

    def wire(dirs):
        root.common.autotune.dir, jax_root.common.autotune.dir = dirs
        dispatch.reset_default_stores()
        jax_dispatch.reset_default_stores()
    try:
        yield wire
    finally:
        wire(priors)


@pytest.mark.parametrize("site,shape_class,config,kwargs", [
    ("serving.decode", "ctx16", {"max_batch": 4, "block_size": 4},
     dict(max_prompt_len=8, max_new_tokens=8)),
    ("serving.prefill_chunk", "mp8", {"chunk_tokens": 8},
     dict(max_batch=2, block_size=4, max_prompt_len=8, max_new_tokens=8,
          prefill_chunk_tokens="auto")),
    ("serving.spec_depth", "mn8", {"spec_depth": 3},
     dict(max_batch=2, block_size=4, max_prompt_len=8, max_new_tokens=8,
          spec_depth="auto")),
    ("serving.kv_dtype", "ctx16", {"kv_dtype": "int8"},
     dict(max_batch=2, block_size=4, max_prompt_len=8, max_new_tokens=8,
          kv_dtype="auto")),
])
def test_decode_schedulers_pick_the_same_from_the_same_record(
        tmp_path, both_dirs, site, shape_class, config, kwargs):
    from veles_tpu.serving import DecodeScheduler as JaxScheduler
    from veles_tpu.serving.toydecode import ToyDecodeModel as JaxToy
    from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
    default = space.site(site).default
    both_dirs(_both_packages_put(tmp_path, site, shape_class, config,
                                 default))
    toy = ToyDecodeModel(vocab=31, device="cpu")
    s = DecodeScheduler(toy, name="tuned", device="cpu", **kwargs)
    j = JaxScheduler(JaxToy(vocab=31), name="tuned", cache=False,
                     **kwargs)
    try:
        got, want = s.stats(), j.stats()
        for key in ("max_batch", "block_size", "prefill_chunk_tokens",
                    "spec_depth", "kv_dtype", "config_source",
                    "chunk_source", "spec_source", "kv_dtype_source"):
            assert got.get(key) == want.get(key), key
        assert "tuned" in (got["config_source"], got.get("chunk_source"),
                           got.get("spec_source"),
                           got.get("kv_dtype_source"))
        prompts = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 2, 6, 5, 3, 5]]
        ours = [f.result(60)["tokens"]
                for f in [s.submit(p, 6) for p in prompts]]
        theirs = [f.result(60)["tokens"]
                  for f in [j.submit(p, 6) for p in prompts]]
        assert ours == theirs
        if got["kv_dtype"] == "f32":
            assert ours == [toy.generate_reference(p, 6) for p in prompts]
    finally:
        s.close()
        j.close(drain=False)


def test_bucket_schedulers_pick_the_same_ladder_from_the_same_record(
        tmp_path, both_dirs):
    from veles_tpu.serving.scheduler import BucketScheduler as JaxBucket
    from veles_tpu_torch.serving.scheduler import BucketScheduler
    both_dirs(_both_packages_put(tmp_path, "serving.bucket_ladder", "mb32",
                                 {"shape": "dense"}, {"shape": "pow2"}))
    s = BucketScheduler(lambda x: x, max_batch=32, sample_shape=(2,),
                        cache=False, warmup=False, device="cpu")
    j = JaxBucket(lambda x: x, max_batch=32, sample_shape=(2,),
                  cache=False, warmup=False)
    try:
        assert s.buckets == j.buckets == space.ladder("dense", 32)
        assert s.stats()["bucket_config"] == j.stats()["bucket_config"]
    finally:
        s.close()
        j.close()


def test_decode_scheduler_tuned_explicit_and_off_geometry(tune_dir):
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(stages=2, experts=2, d=16, heads=2,
                                hidden=32, vocab=32, seed=0, device="cpu")
    store.TuningStore(tune_dir).put(
        "serving.decode", "ctx16", {"max_batch": 4, "block_size": 4},
        default={"max_batch": 8, "block_size": 8}, speedup=1.2)
    dispatch.reset_default_stores()
    s = DecodeScheduler(model, max_prompt_len=8, max_new_tokens=8,
                        cache=False, device="cpu")
    assert (s.config_source, s.max_batch, s.block_size) == ("tuned", 4, 4)
    assert s.stats()["config_source"] == "tuned"
    s.close()
    s2 = DecodeScheduler(model, max_batch=2, block_size=8, max_prompt_len=8,
                         max_new_tokens=8, cache=False, device="cpu")
    assert (s2.config_source, s2.max_batch, s2.block_size) == \
        ("explicit", 2, 8)
    s2.close()
    prior = root.common.autotune.get("dir", None)
    try:
        root.common.autotune.dir = None
        dispatch.reset_default_stores()
        s3 = DecodeScheduler(model, max_prompt_len=8, max_new_tokens=8,
                             cache=False, device="cpu")
        assert (s3.config_source, s3.max_batch, s3.block_size) == \
            ("default", 8, 8)
        s3.close()
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()


def test_prefill_chunk_tuned_auto_and_explicit(tune_dir):
    from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
    model = ToyDecodeModel(vocab=31, device="cpu")
    store.TuningStore(tune_dir).put(
        "serving.prefill_chunk", "mp8", {"chunk_tokens": 8},
        default={"chunk_tokens": 32}, speedup=1.5)
    dispatch.reset_default_stores()
    geom = dict(max_batch=2, block_size=4, max_prompt_len=8,
                max_new_tokens=8, cache=False, device="cpu")
    s = DecodeScheduler(model, prefill_chunk_tokens="auto", **geom)
    assert s.chunk_tokens == 8 and s.stats()["chunk_source"] == "tuned"
    s.close()
    s2 = DecodeScheduler(model, prefill_chunk_tokens=4, **geom)
    assert s2.chunk_tokens == 4
    assert s2.stats()["chunk_source"] == "explicit"
    s2.close()
    s3 = DecodeScheduler(model, **geom)
    assert s3.chunk_tokens is None and "chunk_source" not in s3.stats()
    s3.close()


def test_manifest_configs_roundtrip_and_backward_compat(tmp_path):
    from veles_tpu_torch.compilecache import WarmupManifest
    path = str(tmp_path / "m.json")
    m = WarmupManifest(path)
    m.record("mdl", 4)
    assert m.record_config("mdl", "serving.bucket_ladder",
                           {"shape": "coarse", "buckets": [1, 4]})
    assert not m.record_config("mdl", "serving.bucket_ladder",
                               {"shape": "coarse", "buckets": [1, 4]})
    again = WarmupManifest(path)
    assert again.buckets("mdl") == [4]
    assert again.configs("mdl") == {
        "serving.bucket_ladder": {"shape": "coarse", "buckets": [1, 4]}}
    with open(path, "w") as f:
        json.dump({"models": {"mdl": [{"bucket": 2}]}}, f)
    old = WarmupManifest(path)
    assert old.buckets("mdl") == [2] and old.configs("mdl") == {}
    assert old.forget("mdl")


def test_inject_env_forwards_autotune_dir(tmp_path):
    from veles_tpu_torch import compilecache as cc
    prior = root.common.autotune.get("dir", None)
    prior_cc = root.common.compile_cache.get("dir", None)
    try:
        root.common.compile_cache.dir = None
        root.common.autotune.dir = str(tmp_path / "tune")
        env = cc.inject_env({})
        assert env["VELES_AUTOTUNE_DIR"] == str(tmp_path / "tune")
        assert "VELES_COMPILE_CACHE_DIR" not in env
    finally:
        root.common.autotune.dir = prior
        root.common.compile_cache.dir = prior_cc


# -- CLI + cross-process ------------------------------------------------------

def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.autotune"] + list(args),
        capture_output=True, text=True, timeout=180, cwd=ROOT,
        env=dict(os.environ, **(env or {})))


def test_cli_list_show_verify_resolve_and_corrupt_exit_code(tune_dir):
    _put_lrn(store.TuningStore(tune_dir))
    p = _cli("list", "--dir", tune_dir, "--json")
    assert p.returncode == 0, p.stderr[-500:]
    rows = json.loads(p.stdout)
    assert len(rows) == 1 and rows[0]["record"]["site"] == "lrn"
    p = _cli("show", "--dir", tune_dir, "--site", "lrn", "--shape",
             "c96_n5", "--json")
    assert p.returncode == 0
    assert json.loads(p.stdout)["config"]["impl"] == "band"
    p = _cli("show", "--dir", tune_dir, "--site", "lrn", "--shape", "c1_n5")
    assert p.returncode == 1
    p = _cli("resolve", "--dir", tune_dir, "--site", "lrn", "--shape",
             "c96_n5")
    assert p.returncode == 0
    assert json.loads(p.stdout)["config_source"] == "tuned"
    p = _cli("verify", "--dir", tune_dir)
    assert p.returncode == 0
    with open(os.path.join(tune_dir, store.record_key("lrn", "c96_n5")
                           + store.SUFFIX), "w") as f:
        f.write("junk")
    p = _cli("verify", "--dir", tune_dir)
    assert p.returncode == 1 and "CORRUPT" in p.stdout


def test_cli_tune_exit_codes(tmp_path):
    d = str(tmp_path / "t")
    p = _cli("tune", "--dir", d, "--site", "lrn", "--batch", "--json",
             "--ctx", json.dumps({"rows": 32, "c": 8, "n": 3,
                                  "device": "cpu"}))
    assert p.returncode == 0, p.stderr[-800:]
    doc = json.loads(p.stdout)
    assert len(doc["tuned"]) == 1 and doc["no_winner"] == []
    # no viable candidate anywhere: exit 1 (every probe needs the card)
    p = _cli("tune", "--dir", d, "--site", "lrn", "--timeout", "60",
             "--ctx", json.dumps({"rows": 32, "c": 8}),
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 1
    assert "no viable candidate" in p.stdout


#: a stand-in ``nvcc``: builds a shared library with the C entry every
#: kernel library has, so the build cache's path runs on any host
FAKE_NVCC = '''#!%s
import os, subprocess, sys, tempfile
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(" ".join(args) + "\\n")
if args == ["--version"]:
    print("Cuda compilation tools, release 0.0, V0.0.1 (a stand-in)")
    sys.exit(0)
out = args[args.index("-o") + 1]
fd, stub = tempfile.mkstemp(suffix=".c")
os.write(fd, b'const char* vt_error_string(int c) { return "ok"; }\\n')
os.close(fd)
rc = subprocess.call(["gcc", "-shared", "-fPIC", "-o", out, stub])
os.unlink(stub)
sys.exit(rc)
''' % sys.executable


def fake_toolkit(tmp_path, version_json=True):
    """A directory with ``bin/nvcc`` (the stand-in) and, with
    ``version_json``, a ``version.json`` -> (env additions, the log of
    nvcc runs)."""
    kit = tmp_path / "cuda"
    (kit / "bin").mkdir(parents=True)
    nvcc = kit / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    if version_json:
        (kit / "version.json").write_text(json.dumps(
            {"cuda_nvcc": {"name": "stand-in", "version": "0.0.1"}}))
    log = tmp_path / "nvcc.log"
    log.write_text("")
    return {"PATH": str(kit / "bin") + os.pathsep + os.environ["PATH"],
            "FAKE_NVCC_LOG": str(log)}, log


RESTART = textwrap.dedent("""
    import json, torch
    from veles_tpu_torch import _build
    from veles_tpu_torch.autotune import dispatch, space
    from veles_tpu_torch.compilecache import default_cache
    from veles_tpu_torch.serving.scheduler import warm_kernels
    # what a scheduler's warmup does on the card (loading needs none)
    built, found = warm_kernels(default_cache(), torch.device("cuda"))
    cfg, src = dispatch.resolve(
        "precise_gemm", space.site("precise_gemm").shape_class(
            {"m": 60, "k": 784, "n": 100, "level": 1}),
        default={"split": "rule"})
    print(json.dumps({"built": built, "found": found, "nvcc_runs":
                      _build.build.nvcc_runs, "config": cfg,
                      "source": src, "cache": default_cache().stats()}))
""")


def test_cross_process_restart_resolves_tuned_and_builds_nothing(
        tmp_path):
    """The warm-restart contract: after one process built the kernel
    libraries into the build cache and a winner sits in the tuning
    store, a second process with the same two directories resolves the
    site ``"tuned"``, runs no ``nvcc`` and leaves both stores as they
    were (no re-measurement, no new entry).  The toolkit has no
    ``version.json`` (as on the card): the first process that keys
    anything asks ``nvcc --version`` once and the cache remembers the
    answer for every process after it."""
    env, log = fake_toolkit(tmp_path, version_json=False)
    cache_dir, tune = str(tmp_path / "cc"), str(tmp_path / "tune")
    env.update(VELES_COMPILE_CACHE_DIR=cache_dir, VELES_AUTOTUNE_DIR=tune,
               PYTHONPATH=ROOT)

    def run():
        p = subprocess.run([sys.executable, "-c", RESTART], cwd=ROOT,
                           capture_output=True, text=True, timeout=180,
                           env=dict(os.environ, **env))
        assert p.returncode == 0, p.stderr[-800:]
        return json.loads(p.stdout.strip().splitlines()[-1])

    def state(d):
        return sorted((f, os.path.getmtime(os.path.join(d, f)),
                       os.path.getsize(os.path.join(d, f)))
                      for f in os.listdir(d))

    # a tuner puts a fixed winner through the real store (measuring K4
    # needs the card), with no build cache: it asks nvcc its version
    tuner_env = dict(os.environ, **env)
    tuner_env.pop("VELES_COMPILE_CACHE_DIR")
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            from veles_tpu_torch.autotune import store
            store.TuningStore(%r).put(
                "precise_gemm", "m64_k1024_n128_l1", {"split": 2},
                default={"split": "rule"}, speedup=1.1)
        """ % tune)], cwd=ROOT, env=tuner_env, timeout=120)
    assert p.returncode == 0
    assert log.read_text().splitlines() == ["--version"]
    # the cold process builds every kernel into the cache (its version
    # query is a run of nvcc, not a build) and remembers the version
    cold = run()
    assert (cold["built"], cold["found"]) == (6, 0)
    assert cold["nvcc_runs"] == 7
    assert cold["cache"]["misses"] == 6 and cold["cache"]["hits"] == 0
    assert cold["source"] == "tuned" and cold["config"] == {"split": 2}
    assert len(log.read_text().splitlines()) == 8
    assert os.path.exists(os.path.join(cache_dir, "nvcc_versions.json"))
    before = (state(cache_dir), state(tune))
    time.sleep(0.05)                    # a rewrite would move an mtime
    warm = run()
    assert warm["nvcc_runs"] == 0
    assert (warm["built"], warm["found"]) == (0, 6)
    assert warm["cache"]["misses"] == 0 and warm["cache"]["hits"] == 6
    assert warm["source"] == "tuned" and warm["config"] == {"split": 2}
    assert len(log.read_text().splitlines()) == 8   # nothing more ran
    assert [n for n, _, _ in state(cache_dir)] == \
        [n for n, _, _ in before[0]]
    assert state(tune) == before[1]
