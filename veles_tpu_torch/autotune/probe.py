"""Candidates in a fresh process: measure + correctness-gate them.

The port's counterpart of ``veles_tpu/autotune/probe.py``.

    python -m veles_tpu_torch.autotune.probe --site S --config JSON \
        [--ctx JSON]
    python -m veles_tpu_torch.autotune.probe --site S --configs LIST ...

builds the site's work with the candidate configuration, checks its
output against the site's gate (a kernel candidate against the PLAIN
version of the kernel, never against the default plan, so a wrong pair
cannot vouch for itself), then times the candidate AND the site's
default in turns in this same process (:func:`_timed_pair`: on the card
CUDA events around each window after a warm-up, else the host clock).
Emits ONE JSON line::

    {"ok": true, "site": ..., "config": {...}, "gate": "passed",
     "cand_s": ..., "ref_s": ..., "score": cand_s / ref_s}

or, with ``--configs``, ``{"ok": true, "site": ..., "results": [one
such dict a config]}``.  ``score`` is the in-process candidate/default
time ratio: the runner ranks by it, so load drift between probe
processes cancels.  A gate other than ``"passed"`` disqualifies the
candidate whatever its score.  Any exception still prints a parseable
``{"ok": false}`` (for that config, with ``--configs``).

``ctx["device"]`` picks the device (default: the card, raising without
one; ``"cpu"`` runs the kernels' plain versions, for tests).
"""

import argparse
import json
import math
import sys
import time
import traceback

import numpy
import torch

from ..device import resolve_device
from . import space as _space


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window_seconds(fn, reps, dev):
    """Seconds a call of ``fn`` over one window of ``reps`` calls: CUDA
    events on the card, the host clock elsewhere."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _timed_pair(cand_fn, ref_fn, reps, windows, dev=None):
    """Interleaved min-of-windows seconds for (candidate, reference):
    alternating window order cancels monotone load drift, the min
    discards contended windows; both warm before any timing."""
    dev = dev or torch.device("cpu")
    reps, windows = max(int(reps), 1), max(int(windows), 1)
    for fn in (cand_fn, ref_fn):
        fn()
        fn()
    _sync(dev)
    cand_times, ref_times = [], []
    for w in range(windows):
        pairs = [(cand_fn, cand_times), (ref_fn, ref_times)]
        if w % 2:
            pairs.reverse()
        for fn, acc in pairs:
            acc.append(_window_seconds(fn, reps, dev))
    return min(cand_times), min(ref_times)


def _gate(ok, detail=""):
    return "passed" if ok else "failed:%s" % (detail or "mismatch")


def _device(ctx):
    return resolve_device(ctx.get("device"))


def _rel(got, want):
    """max|got - want| over max(1, max|want|)."""
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


# -- kernel sites -------------------------------------------------------------

def probe_lrn(config, ctx, reps, windows):
    from ..znicz import lrn as lrn_mod
    dev = _device(ctx)
    rows, c = int(ctx.get("rows", 2048)), int(ctx.get("c", 96))
    n = int(ctx.get("n", 5))
    alpha, beta, k = 1e-4, 0.75, 2.0
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((rows, c), generator=gen, device=dev)

    def make(cfg):
        form = lrn_mod.lrn if cfg["impl"] == "kernel" else lrn_mod.lrn_mxu
        return lambda: form(x, n, alpha, beta, k)

    f_cand, f_ref = make(config), make(_space.site("lrn").default)
    err = float((f_cand() - lrn_mod.lrn_reference(x, n, alpha, beta, k))
                .abs().max())
    cand_s, ref_s = _timed_pair(f_cand, f_ref, reps, windows, dev)
    return {"gate": _gate(err <= 2e-4, "max_err=%.3g" % err),
            "max_err": err, "cand_s": cand_s, "ref_s": ref_s}


def _probe_attention(site_name, config, ctx, reps, windows):
    from ..znicz import flash_attention as fa
    dev = _device(ctx)
    b, t = int(ctx.get("b", 1)), int(ctx.get("t", 256))
    h, d = int(ctx.get("h", 2)), int(ctx.get("d", 64))
    causal = bool(ctx.get("causal", site_name == "window_attention"))
    window = ctx.get("window") if site_name == "window_attention" \
        else None
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (0.5 * torch.randn((b, t, h, d), generator=gen,
                                     device=dev) for _ in range(4))
    kw = dict(causal=causal, window=window)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = fa.flash_delta(do, ref_out)
    ref_dq = fa.flash_dq_reference(q, k, v, do, ref_lse, delta, **kw)
    ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta,
                                            **kw)

    def make(cfg):
        def run():
            out, lse = fa.flash_attention_fwd(q, k, v, tiles=cfg, **kw)
            dq = fa.flash_attention_dq(q, k, v, do, ref_lse, delta,
                                       tiles=cfg, **kw)
            dk, dv = fa.flash_attention_dkv(q, k, v, do, ref_lse, delta,
                                            tiles=cfg, **kw)
            return out, lse, dq, dk, dv
        return run

    f_cand = make(config)
    f_ref = make(_space.site(site_name).default_for(ctx))
    out, lse, dq, dk, dv = f_cand()
    err = {"out": float((out - ref_out).abs().max()),
           "lse": float((lse - ref_lse).abs().max()),
           "grad": max(_rel(dq, ref_dq), _rel(dk, ref_dk),
                       _rel(dv, ref_dv))}
    ok = err["out"] <= 2e-5 and err["lse"] <= 2e-6 and err["grad"] <= 5e-4
    cand_s, ref_s = _timed_pair(f_cand, f_ref, reps, windows, dev)
    return {"gate": _gate(ok, "errors %s" % json.dumps(err)),
            "errors": err, "cand_s": cand_s, "ref_s": ref_s}


def probe_flash_attention(config, ctx, reps, windows):
    return _probe_attention("flash_attention", config, ctx, reps, windows)


def probe_window_attention(config, ctx, reps, windows):
    ctx = dict(ctx or {})
    ctx.setdefault("window", max(int(ctx.get("t", 256)) // 4, 32))
    return _probe_attention("window_attention", config, ctx, reps,
                            windows)


def probe_precise_gemm(config, ctx, reps, windows):
    from ..znicz import gemm
    dev = _device(ctx)
    m, kk, n = int(ctx.get("m", 512)), int(ctx.get("k", 512)), \
        int(ctx.get("n", 512))
    level = int(ctx.get("level", 1))
    rng = numpy.random.RandomState(0)
    a = torch.tensor(rng.standard_normal((m, kk)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal((kk, n)), dtype=torch.float32,
                     device=dev)

    def make(cfg):
        if dev.type == "cpu":
            return lambda: gemm._precise_launch(a, b, level)
        split = gemm.split_runs(cfg["split"], m, n, kk, dev)
        return lambda: gemm._precise_launch(a, b, level, split)

    f_cand = make(config)
    f_ref = make(_space.site("precise_gemm").default)
    out = f_cand()
    # K4's fold adds the same partials in the same order whatever the
    # split: a candidate must give the default's bits, and the default
    # must hold to the plain version
    bitwise = bool(torch.equal(out, f_ref()))
    want = gemm.precise_matmul_reference(a, b, level)
    # phase 2's limit: 1e-6 of max(|a| @ |b|), the scale of the sums
    err = float((out - want).abs().max()) / max(
        float((a.abs() @ b.abs()).max()), 1e-30)
    cand_s, ref_s = _timed_pair(f_cand, f_ref, reps, windows, dev)
    return {"gate": _gate(bitwise and err <= 1e-6,
                          "bitwise=%s rel_err=%.3g" % (bitwise, err)),
            "rel_err": err, "cand_s": cand_s, "ref_s": ref_s}


def _paged_inputs(ctx, dev, bs, quantized):
    from ..znicz import paged_attention as pa
    b, h = int(ctx.get("batch", 2)), int(ctx.get("heads", 2))
    d = int(ctx.get("d", 16))
    nb = int(ctx.get("max_blocks", pa.required_blocks(
        ctx.get("length", 48), bs)))
    rng = numpy.random.RandomState(int(ctx.get("seed", 0)))
    lengths = rng.randint(1, nb * bs + 1, b)
    lengths[0] = nb * bs                   # one row at the table's end
    n_pool = b * nb + 1                    # + the trash block 0
    gen = torch.Generator(device=dev).manual_seed(0)
    kp, vp = (torch.randn((n_pool, bs, h, d), generator=gen, device=dev)
              for _ in range(2))
    table = torch.tensor((1 + rng.permutation(n_pool - 1)).reshape(b, nb),
                         dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kw = {}
    if quantized:
        kp, ks = pa.quantize_pool(kp)
        vp, vs = pa.quantize_pool(vp)
        kw = {"k_scales": ks, "v_scales": vs}
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, kp, vp, table, lens), kw, (b, h, d, nb)


def probe_paged_attention(config, ctx, reps, windows):
    from ..znicz import paged_attention as pa
    dev = _device(ctx)
    quantized = bool(ctx.get("quantized", False))
    bs = int(config["block_size"])
    args, kw, (b, h, d, nb) = _paged_inputs(ctx, dev, bs, quantized)

    def make(cfg):
        if dev.type == "cpu":
            return lambda: pa.paged_attention(*args, **kw)
        sms = torch.cuda.get_device_properties(
            dev).multi_processor_count
        plan = pa.plan_for_split(cfg["split"], b, h, d, bs, nb, sms,
                                 quantized=quantized)
        return lambda: pa._paged_launch(*args, None, kw.get("k_scales"),
                                        kw.get("v_scales"), plan)

    f_cand = make(config)
    f_ref = make(_space.site("paged_attention").default_for(
        dict(ctx, block_size=bs)))
    err = float((f_cand() - pa.paged_attention_reference(*args, **kw))
                .abs().max())
    cand_s, ref_s = _timed_pair(f_cand, f_ref, reps, windows, dev)
    return {"gate": _gate(err <= 1e-5, "max_err=%.3g" % err),
            "max_err": err, "cand_s": cand_s, "ref_s": ref_s}


# -- serving sites ------------------------------------------------------------

def _decode_model(ctx, dev, **extra):
    """The ctx's decode model: the flagship at ``ctx["flagship"]``'s
    widths, else the JAX probes' small one."""
    from ..znicz.samples.flagship import FlagshipDecodeModel
    kw = dict(ctx.get("flagship") or dict(stages=2, experts=2, d=16,
                                          heads=2, hidden=32, vocab=32,
                                          seed=0))
    kw.update(extra)
    return FlagshipDecodeModel(device=dev, **kw)


def _flagship_oracle(model, prompt, n):
    from ..znicz.samples.flagship import generate_reference
    return generate_reference(model.params, prompt, n, heads=model.heads,
                              k=model.k)


def _drain(sched, prompts, max_new):
    futs = [sched.submit(p, max_new) for p in prompts]
    return [f.result(600) for f in futs]


def _pair_schedulers(build, config_cand, config_ref):
    cand = build(config_cand)
    try:
        ref = build(config_ref)
    except BaseException:
        cand.close(drain=False)
        raise
    return cand, ref


def probe_bucket_ladder(config, ctx, reps, windows):
    """Steady-state drain time of a seeded ragged request mix: what a
    ladder shape pays forever is padding waste."""
    from ..serving.scheduler import BucketScheduler
    dev = _device(ctx)
    mb = int(ctx.get("max_batch", 16))
    dim = int(ctx.get("dim", 64))
    n_requests = int(ctx.get("requests", 48))
    rng = numpy.random.RandomState(int(ctx.get("seed", 0)))
    w = torch.tensor(rng.standard_normal((dim, dim)) * 0.1,
                     dtype=torch.float32, device=dev)

    def fn(x):
        y = torch.tanh(torch.as_tensor(x, device=dev) @ w)
        return y.cpu().numpy()

    mix = [rng.standard_normal((int(rng.randint(1, mb + 1)), dim))
           .astype(numpy.float32) for _ in range(n_requests)]

    def build(shape):
        return BucketScheduler(
            fn, max_batch=mb, queue_limit=4 * n_requests * mb,
            warmup=True, name="autotune-%s" % shape, sample_shape=(dim,),
            cache=False, buckets=_space.ladder(shape, mb), device=dev)

    cand, ref = _pair_schedulers(build, config["shape"], "pow2")
    try:
        def drain(s):
            futs = [s.submit(x) for x in mix]
            return [f.result(60) for f in futs]

        outs = drain(cand)
        ok = all(numpy.allclose(o, fn(x), atol=1e-5)
                 for o, x in zip(outs[:8], mix[:8]))
        cand_s, ref_s = _timed_pair(lambda: drain(cand),
                                    lambda: drain(ref), reps, windows)
    finally:
        cand.close(drain=False)
        ref.close(drain=False)
    return {"gate": _gate(ok), "cand_s": cand_s, "ref_s": ref_s,
            "ladder": _space.ladder(config["shape"], mb)}


def probe_serving_decode(config, ctx, reps, windows):
    """Decode time over a seeded ragged prompt mix under candidate
    geometry, gated on token equality with the cache-free oracle."""
    from ..serving import DecodeScheduler
    dev = _device(ctx)
    max_prompt = int(ctx.get("max_prompt_len", 8))
    max_new = int(ctx.get("max_new_tokens", 8))
    n_requests = int(ctx.get("requests", 12))
    model = _decode_model(ctx, dev)
    rng = numpy.random.RandomState(int(ctx.get("seed", 0)))
    prompts = [[int(t) for t in rng.randint(
        0, model.vocab, size=rng.randint(1, max_prompt + 1))]
        for _ in range(n_requests)]

    def build(cfg):
        return DecodeScheduler(
            model, max_batch=int(cfg["max_batch"]),
            block_size=int(cfg["block_size"]),
            max_prompt_len=max_prompt, max_new_tokens=max_new,
            queue_limit=4 * n_requests, device=dev, cache=False,
            name="autotune-%d-%d" % (cfg["max_batch"],
                                     cfg["block_size"]))

    cand, ref = _pair_schedulers(build, config,
                                 _space.site("serving.decode").default)
    try:
        outs = _drain(cand, prompts, max_new)
        ok = all(outs[i]["tokens"] == _flagship_oracle(
            model, prompts[i], max_new) for i in range(min(4, n_requests)))
        cand_s, ref_s = _timed_pair(
            lambda: _drain(cand, prompts, max_new),
            lambda: _drain(ref, prompts, max_new), reps, windows)
    finally:
        cand.close(drain=False)
        ref.close(drain=False)
    return {"gate": _gate(ok, "tokens diverge from the cache-free "
                              "oracle"),
            "cand_s": cand_s, "ref_s": ref_s}


def probe_prefill_chunk(config, ctx, reps, windows):
    """Short-request TTFT behind long chunked prefills — what the chunk
    size trades (smaller chunks interleave sooner, each chunk pays a
    dispatch) — gated on token equality with the oracle.  ``ctx``
    ``"flagship"`` serves the flagship at those widths on ``device``
    (``"server"``: its scheduler geometry); else the toy decoder with a
    pinned per-prompt-token prefill cost, as the JAX probe."""
    from ..serving import DecodeScheduler, ToyDecodeModel
    dev = _device(ctx)
    max_prompt = int(ctx.get("max_prompt_len", 64))
    longs = int(ctx.get("long_prompts", 2))
    new = int(ctx.get("new_tokens", 4))
    rng = numpy.random.RandomState(int(ctx.get("seed", 0)))
    if ctx.get("flagship"):
        model = _decode_model(ctx, dev)
        geometry = dict(ctx.get("server") or {})
        geometry.setdefault("max_batch", longs + 1)
        oracle = lambda p, n: _flagship_oracle(model, p, n)  # noqa: E731
    else:
        model = ToyDecodeModel(vocab=97, prefill_delay=float(
            ctx.get("prefill_delay", 0.001)), device=dev)
        geometry = {"max_batch": longs + 1, "block_size": 4}
        oracle = model.generate_reference
    geometry.update(max_prompt_len=max_prompt,
                    max_new_tokens=max(new, int(geometry.get(
                        "max_new_tokens", new))))
    long_prompts = [rng.randint(1, min(model.vocab, 90),
                                max_prompt).tolist()
                    for _ in range(longs)]
    short = [3, 1, 4, 1]

    def build(chunk):
        return DecodeScheduler(
            model, queue_limit=64, device=dev, cache=False,
            prefill_chunk_tokens=int(chunk),
            name="autotune-chunk%d" % chunk, **geometry)

    def wave(s):
        futs = [s.submit(p, new) for p in long_prompts]
        got = s.submit(short, new).result(600)
        for f in futs:
            f.result(600)
        return got

    cand, ref = _pair_schedulers(
        build, config["chunk_tokens"],
        _space.site("serving.prefill_chunk").default["chunk_tokens"])
    try:
        ok = wave(cand)["tokens"] == oracle(short, new)
        wave(ref)
        # the _timed_pair discipline (interleaved min-of-windows)
        # applied to the short request's TTFT rather than wall time
        cand_t, ref_t = [], []
        for w in range(max(int(windows), 1)):
            pairs = [(cand, cand_t), (ref, ref_t)]
            if w % 2:
                pairs.reverse()
            for s, acc in pairs:
                vals = [wave(s)["ttft_s"]
                        for _ in range(max(int(reps), 1))]
                acc.append(sum(vals) / len(vals))
        cand_s, ref_s = min(cand_t), min(ref_t)
    finally:
        cand.close(drain=False)
        ref.close(drain=False)
    return {"gate": _gate(ok, "tokens diverge from the oracle"),
            "cand_s": cand_s, "ref_s": ref_s}


def probe_spec_depth(config, ctx, reps, windows):
    """Decode drain time with the draft-and-verify loop at the
    candidate depth, gated on token equality with the pure-host oracle
    (the toy decoder with a pinned per-step host delay and drafter
    agreement rate, as the JAX probe)."""
    from ..serving import DecodeScheduler, ToyDecodeModel
    dev = _device(ctx)
    max_prompt = int(ctx.get("max_prompt_len", 8))
    max_new = int(ctx.get("max_new_tokens", 16))
    n_requests = int(ctx.get("requests", 8))
    model = ToyDecodeModel(vocab=31, step_delay=float(
        ctx.get("step_delay", 0.002)), draft_agreement=float(
        ctx.get("agreement", 0.8)), device=dev)
    rng = numpy.random.RandomState(int(ctx.get("seed", 0)))
    prompts = [[int(t) for t in rng.randint(
        0, 31, size=rng.randint(1, max_prompt + 1))]
        for _ in range(n_requests)]

    def build(depth):
        return DecodeScheduler(
            model, max_batch=4, block_size=4, max_prompt_len=max_prompt,
            max_new_tokens=max_new, queue_limit=4 * n_requests,
            device=dev, cache=False, spec_depth=int(depth),
            name="autotune-spec%d" % depth)

    cand, ref = _pair_schedulers(
        build, config["spec_depth"],
        _space.site("serving.spec_depth").default["spec_depth"])
    try:
        outs = _drain(cand, prompts, max_new)
        ok = all(outs[i]["tokens"] == model.generate_reference(
            prompts[i], max_new) for i in range(n_requests))
        cand_s, ref_s = _timed_pair(
            lambda: _drain(cand, prompts, max_new),
            lambda: _drain(ref, prompts, max_new), reps, windows)
    finally:
        cand.close(drain=False)
        ref.close(drain=False)
    return {"gate": _gate(ok, "tokens diverge from the pure-host "
                              "oracle"),
            "cand_s": cand_s, "ref_s": ref_s}


def _decode_logit_rmse(model, kv_dtype, prompt, n_new):
    """Greedy-rollout logit RMSE of ``kv_dtype`` pools against f32 pools
    — same params, same geometry, token by token through the model's
    ``logits_fn`` hook.  The error-bound gate's measurement."""
    bs = 4
    # the fixed geometry below holds 4 blocks x 4 tokens a row: cap the
    # rollout so no position ever lands past the page table
    n_new = min(int(n_new), 4 * bs - len(prompt))
    per = {}
    for kvd in dict.fromkeys(("f32", kv_dtype)):
        kp, vp = model.make_pools(8, bs, kv_dtype=kvd)
        toks = numpy.zeros(8, numpy.int32)
        toks[:len(prompt)] = prompt
        block_row = numpy.asarray([1, 2, 3, 4], numpy.int32)
        tok = model.prefill_fn(bs, kv_dtype=kvd)(toks, len(prompt), kp,
                                                 vp, block_row)[0]
        table = numpy.zeros((2, 4), numpy.int32)
        table[0] = block_row
        lengths = numpy.asarray([len(prompt), 0], numpy.int32)
        logits = model.logits_fn(bs, kv_dtype=kvd)
        cur = numpy.asarray([int(tok), 0], numpy.int32)
        rows = []
        for _ in range(n_new):
            out = logits(kp, vp, table, lengths, cur)
            nxt, lg = out[0], out[-1]
            rows.append(lg[0].double().cpu().numpy())
            lengths[0] += 1
            cur[0] = int(nxt[0])
        per[kvd] = numpy.stack(rows)
    if kv_dtype == "f32":
        return 0.0
    diff = per[kv_dtype] - per["f32"]
    return float(math.sqrt(float(numpy.mean(diff * diff))))


def probe_kv_dtype(config, ctx, reps, windows):
    """Decode drain time with the candidate KV-pool precision, gated on
    the site's DECLARED error bound: greedy-rollout logit RMSE <=
    ``error_bound`` through the model's ``logits_fn`` hook, measured
    before any timing."""
    from ..serving import DecodeScheduler
    dev = _device(ctx)
    sp = _space.site("serving.kv_dtype")
    bound = float(ctx.get("error_bound", sp.error_bound))
    max_prompt = int(ctx.get("max_prompt_len", 8))
    max_new = int(ctx.get("max_new_tokens", 8))
    n_requests = int(ctx.get("requests", 8))
    kvd = str(config["kv_dtype"])
    model = _decode_model(ctx, dev)
    rng = numpy.random.RandomState(int(ctx.get("seed", 0)))
    prompts = [[int(t) for t in rng.randint(
        0, model.vocab, size=rng.randint(1, max_prompt + 1))]
        for _ in range(n_requests)]
    rmse = _decode_logit_rmse(model, kvd, prompts[0][:3] or [1], max_new)

    def build(kv_dtype):
        return DecodeScheduler(
            model, max_batch=4, block_size=4, max_prompt_len=max_prompt,
            max_new_tokens=max_new, queue_limit=4 * n_requests,
            device=dev, cache=False, kv_dtype=kv_dtype,
            name="autotune-kv-%s" % kv_dtype)

    cand, ref = _pair_schedulers(build, kvd, sp.default["kv_dtype"])
    try:
        _drain(cand, prompts, max_new)
        cand_s, ref_s = _timed_pair(
            lambda: _drain(cand, prompts, max_new),
            lambda: _drain(ref, prompts, max_new), reps, windows)
    finally:
        cand.close(drain=False)
        ref.close(drain=False)
    return {"gate": _gate(rmse <= bound,
                          "logit_rmse=%.3g > bound=%.3g" % (rmse, bound)),
            "logit_rmse": round(rmse, 6), "error_bound": bound,
            "cand_s": cand_s, "ref_s": ref_s}


_IMPLS = {
    "lrn": probe_lrn,
    "flash_attention": probe_flash_attention,
    "window_attention": probe_window_attention,
    "precise_gemm": probe_precise_gemm,
    "paged_attention": probe_paged_attention,
    "serving.bucket_ladder": probe_bucket_ladder,
    "serving.decode": probe_serving_decode,
    "serving.prefill_chunk": probe_prefill_chunk,
    "serving.spec_depth": probe_spec_depth,
    "serving.kv_dtype": probe_kv_dtype,
}

#: serving probes time whole drains: fewer reps than microsecond kernels
_SERVING = ("serving.bucket_ladder", "serving.decode",
            "serving.prefill_chunk", "serving.spec_depth",
            "serving.kv_dtype")
_DEFAULT_REPS = dict.fromkeys(_SERVING, 1)
_DEFAULT_WINDOWS = dict.fromkeys(_SERVING, 2)


def measure(site, config, ctx, reps=None, windows=None):
    """One candidate in this process -> the probe's dict (never raises:
    a failure is ``{"ok": False, "error": ...}``)."""
    reps = reps if reps is not None else _DEFAULT_REPS.get(site, 10)
    windows = windows if windows is not None \
        else _DEFAULT_WINDOWS.get(site, 3)
    out = {"ok": True, "site": site, "config": config}
    try:
        out.update(_IMPLS[site](config, ctx, reps, windows))
        if out.get("ref_s", 0) > 0 and "cand_s" in out:
            out["score"] = round(out["cand_s"] / out["ref_s"], 4)
        out["cand_s"] = round(out.get("cand_s", 0.0), 9)
        out["ref_s"] = round(out.get("ref_s", 0.0), 9)
    except Exception:  # noqa: BLE001 — the line must always print
        out = {"ok": False, "site": site, "config": config,
               "error": traceback.format_exc(limit=3).strip()[-500:]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--site", required=True, choices=sorted(_IMPLS))
    p.add_argument("--config", default=None,
                   help="one candidate configuration (JSON object)")
    p.add_argument("--configs", default=None,
                   help="several candidates (JSON list), one process")
    p.add_argument("--ctx", default="{}",
                   help="call context: shapes/seed/device (JSON object)")
    p.add_argument("--reps", type=int, default=None)
    p.add_argument("--windows", type=int, default=None)
    args = p.parse_args(argv)
    ctx = json.loads(args.ctx)
    if args.configs is not None:
        results = [measure(args.site, c, ctx, args.reps, args.windows)
                   for c in json.loads(args.configs)]
        print(json.dumps({"ok": True, "site": args.site,
                          "results": results}))
    else:
        print(json.dumps(measure(args.site, json.loads(args.config), ctx,
                                 args.reps, args.windows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
