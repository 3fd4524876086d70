#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA
   versions; build every kernel of ``veles_tpu_torch/csrc`` with nvcc.
2. Kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the main path gives it and at
   serving-realistic shapes, timed with CUDA events beside the least
   time the card could take (``bound_ms``) and, where one PyTorch call
   computes the same function, that call (``library_ms``).
   Tolerances: paged attention ``max|kernel - plain| <= 1e-5``; the
   quantized GEMM ``max|kernel - plain| <= 1e-5 * max|plain|``.
3. End to end, over real HTTP: the port's ``InferenceServer`` serving
   the flagship decode model at the README's decode-quickstart widths
   (stages=2, experts=4, d=64, heads=4, hidden=128, vocab=1024; server
   max_batch=16, block_size=16, max_prompt_len=128, max_new_tokens=128)
   answers 8 concurrent requests of seeded ragged prompts (5-128 tokens,
   32 new tokens each).  f32: every answer equals the port's cache-free
   ``generate_reference``.  int8 KV, int8 and fp8 weights: every answer
   equals the same model run by the port on the CPU (plain versions).
   Each run resets the kernels' launch counts just before it and reads
   them just after; every kernel must have launched in its run.
4. Where the time goes: each configuration's burst once more under
   ``torch.profiler`` (after every untraced measurement): the share of
   the burst's wall time the card is busy, and the top kernels.
5. The ``kernels`` JSON line, the card's line, and the result line.

Imports nothing of JAX or of the JAX package.  ``--json PATH`` writes
every number to PATH as well.
"""

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s (no
#: tensor cores)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12

README_MODEL = dict(stages=2, experts=4, d=64, heads=4, hidden=128,
                    vocab=1024, seed=0)
README_SERVER = dict(max_batch=16, block_size=16, max_prompt_len=128,
                     max_new_tokens=128)
N_REQUESTS, NEW_TOKENS = 8, 32
#: (label, kv_dtype, weight_dtype) of the end-to-end runs
CONFIGS = (("f32", "f32", "f32"), ("int8-kv", "int8", "f32"),
           ("int8-weights", "f32", "int8"), ("fp8-weights", "f32", "fp8"))


def _log(*args):
    print(*args, flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back launches,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels against their plain versions ----------------------------

def _paged_case(torch, pa, dev, b, h, d, bs, nb, lengths, quant, seed):
    """Inputs of one paged-attention call and the bytes/flops its valid
    tokens need (each input read once, the output written once)."""
    rng = numpy.random.RandomState(seed)
    n_pool = b * nb + 1
    q = torch.tensor(rng.standard_normal((b, h, d)), dtype=torch.float32,
                     device=dev)
    kp = torch.randn((n_pool, bs, h, d), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    vp = torch.randn((n_pool, bs, h, d), generator=torch.Generator(
        device=dev).manual_seed(seed + 1), device=dev)
    ids = 1 + rng.permutation(n_pool - 1)[:b * nb]
    table = torch.tensor(ids.reshape(b, nb), dtype=torch.int32, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw, elem = {}, 4
    if quant:
        kp, ks = pa.quantize_pool(kp)
        vp, vs = pa.quantize_pool(vp)
        kw, elem = {"k_scales": ks, "v_scales": vs}, 1
    tokens = int(sum(lengths))
    blocks = int(sum(-(-n // bs) for n in lengths))
    nbytes = (2 * tokens * h * d * elem          # K and V of valid tokens
              + 2 * b * h * d * 4                # q in, out
              + blocks * 4 + b * 4               # table entries, lengths
              + (2 * blocks * h * 4 if quant else 0))   # their scales
    flops = 4 * tokens * h * d
    return (q, kp, vp, table, lens), kw, nbytes, flops


def _measure_paged(torch, pa, dev, label, shape, lengths, quant, seed):
    b, h, d, bs, nb = shape
    args, kw, nbytes, flops = _paged_case(torch, pa, dev, b, h, d, bs, nb,
                                          lengths, quant, seed)
    out = pa.paged_attention(*args, **kw)
    ref = pa.paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= 1e-5:
        raise AssertionError("%s: max|kernel - plain| = %g > 1e-5"
                             % (label, err))
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"shape": "B=%d H=%d D=%d bs=%d nb=%d tokens=%d"
                    % (b, h, d, bs, nb, sum(lengths)),
           "max_abs_err": err,
           "ms": _cuda_ms(torch, lambda: pa.paged_attention(*args, **kw)),
           "plain_ms": _cuda_ms(
               torch, lambda: pa.paged_attention_reference(*args, **kw),
               iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    _log("kernel %s [%s] max_err=%.3g kernel_ms=%.4f plain_ms=%.4f "
         "bound_ms=%.4f (%s) library_ms=none"
         % (label, rec["shape"], err, rec["ms"], rec["plain_ms"],
            bound_ms, bound_by))
    return rec


def _measure_qmm(torch, gemm, dev, label, m, k, n, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    w_q, s = gemm.quantize_weight(w, dtype)
    out = gemm.quantized_matmul(a, w_q, s)
    ref = gemm.quantized_matmul_reference(a, w_q, s)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= 1e-5:
        raise AssertionError("%s: max|kernel - plain| / max|plain| = %g "
                             "> 1e-5" % (label, rel))
    w_deq = w_q.to(torch.float32) * s[None, :]
    nbytes = m * k * 4 + k * n * w_q.element_size() + n * 4 + m * n * 4
    bound_ms, bound_by = _bound(nbytes, 2 * m * k * n)
    rec = {"shape": "M=%d K=%d N=%d" % (m, k, n),
           "max_abs_err": err, "max_rel_err": rel,
           "ms": _cuda_ms(torch, lambda: gemm.quantized_matmul(a, w_q, s)),
           "plain_ms": _cuda_ms(
               torch, lambda: gemm.quantized_matmul_reference(a, w_q, s)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _cuda_ms(torch, lambda: torch.matmul(a, w_deq))}
    _log("kernel %s [%s] max_err=%.3g (rel %.3g) kernel_ms=%.4f "
         "plain_ms=%.4f bound_ms=%.4f (%s) library_ms=%.4f (torch.matmul "
         "on the dequantized f32 weights)"
         % (label, rec["shape"], err, rel, rec["ms"], rec["plain_ms"],
            bound_ms, bound_by, rec["library_ms"]))
    return rec


def kernel_phase(torch, pa, gemm, dev):
    """-> {kernel name: {"main": record, "realistic": [records]}}."""
    rng = numpy.random.RandomState(0)
    # the main path: README widths (H=4, D=16, bs=16, 16 blocks a row),
    # decode lengths 1 .. 160 (prompt <= 128 plus 32 new tokens)
    main_shape = (16, 4, 16, 16, 16)
    main_lengths = [1] + rng.randint(1, 161, 15).tolist()
    # serving-realistic: B=32, H=8, D=128, bs=16, 128 blocks a row,
    # ragged lengths in [0, 2048] with one empty and one full row
    big_shape = (32, 8, 128, 16, 128)
    big_lengths = [0, 2048] + rng.randint(0, 2049, 30).tolist()
    out = {}
    for name, quant in (("paged_attention_f32", False),
                        ("paged_attention_int8", True)):
        out[name] = {
            "main": _measure_paged(torch, pa, dev, name, main_shape,
                                   main_lengths, quant, seed=1),
            "realistic": [_measure_paged(torch, pa, dev, name, big_shape,
                                         big_lengths, quant, seed=2)]}
    for dtype in ("int8", "fp8"):
        name = "quantized_matmul_" + dtype
        # the main path's two expert GEMMs at decode (16 rows)
        main = _measure_qmm(torch, gemm, dev, name, 16, 64, 128, dtype, 3)
        _measure_qmm(torch, gemm, dev, name, 16, 128, 64, dtype, 4)
        out[name] = {
            "main": main,
            "realistic": [_measure_qmm(torch, gemm, dev, name, m, 4096,
                                       4096, dtype, 5 + m)
                          for m in (16, 256)]}
    return out


# -- phase 3: end to end over HTTP --------------------------------------------

def _prompts():
    rng = numpy.random.RandomState(7)
    vocab = README_MODEL["vocab"]
    return [rng.randint(0, vocab, int(rng.randint(5, 129))).tolist()
            for _ in range(N_REQUESTS)]


def _post_all(url, prompts):
    """POST every prompt concurrently; -> (answers in order, seconds)."""
    answers = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            req = urllib.request.Request(
                url + "/api/flagship/generate",
                json.dumps({"prompt": prompts[i],
                            "max_new_tokens": NEW_TOKENS}).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                answers[i] = json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    seconds = time.perf_counter() - t0
    if errors or any(a is None for a in answers):
        raise RuntimeError("generate requests failed: %r" % (errors,))
    return answers, seconds


def _cpu_tokens(model_kw, prompts, kv_dtype):
    """The same model served by the port on the CPU (plain versions)."""
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(device="cpu", **model_kw)
    sched = DecodeScheduler(model, name="cpu-oracle", device="cpu",
                            kv_dtype=kv_dtype, **README_SERVER)
    try:
        futures = [sched.submit(p, NEW_TOKENS) for p in prompts]
        return [f.result(900)["tokens"] for f in futures]
    finally:
        sched.close()


def e2e_run(pa, gemm, card, label, kv_dtype, weight_dtype):
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import (
        FlagshipDecodeModel, generate_reference)
    model_kw = dict(README_MODEL, kv_dtype=kv_dtype,
                    weight_dtype=weight_dtype)
    model = FlagshipDecodeModel(**model_kw)          # on the card
    server = InferenceServer({"flagship": model}, kv_dtype=kv_dtype,
                             **README_SERVER)
    prompts = _prompts()
    try:
        pa.paged_attention.launches = 0
        gemm.quantized_matmul.launches = 0
        answers, seconds = _post_all(server.url, prompts)
        launches = {"paged_attention": pa.paged_attention.launches,
                    "quantized_matmul": gemm.quantized_matmul.launches}
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=60) as resp:
            metrics = json.loads(resp.read())["flagship"]
    finally:
        server.stop()
    got = [a["tokens"] for a in answers]
    if any(len(t) != NEW_TOKENS for t in got):
        raise AssertionError("%s: wrong token counts" % label)
    if kv_dtype == "f32" and weight_dtype == "f32":
        want = [generate_reference(model.params, p, NEW_TOKENS,
                                   heads=model.heads) for p in prompts]
        oracle = "cache-free generate_reference on the card"
    else:
        want = _cpu_tokens(model_kw, prompts, kv_dtype)
        oracle = "the same model on the CPU"
    mismatched = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if mismatched:
        raise AssertionError("%s: answers %s differ from %s"
                             % (label, mismatched, oracle))
    ttft = sorted(a["ttft_s"] for a in answers)
    steps = metrics["steps"]
    rec = {"label": label, "kv_dtype": kv_dtype,
           "weight_dtype": weight_dtype, "card": card,
           "requests": len(prompts), "tokens": sum(map(len, got)),
           "prompt_tokens": sum(map(len, prompts)), "seconds": seconds,
           "tok_s": sum(map(len, got)) / seconds,
           "ttft_p50_ms": 1e3 * statistics.median(ttft),
           "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                         int(0.99 * len(ttft)))],
           "step_ms_p50": metrics["step_latency"]["p50_ms"],
           "step_ms_p99": metrics["step_latency"]["p99_ms"],
           "decode_steps": steps, "launches": launches,
           # prefill runs no paged attention; every forward (prefill or
           # decode step) runs the expert GEMMs
           "paged_attention_per_step":
               launches["paged_attention"] / steps,
           "quantized_matmul_per_forward":
               launches["quantized_matmul"] / (steps + len(prompts)),
           "oracle": oracle}
    _log("e2e %s: %d requests, %d tokens in %.3f s = %.1f tok/s; TTFT "
         "p50 %.1f ms p99 %.1f ms; decode step p50 %s ms p99 %s ms over "
         "%d steps; launches %s; tokens equal %s [%s]"
         % (label, rec["requests"], rec["tokens"], seconds, rec["tok_s"],
            rec["ttft_p50_ms"], rec["ttft_p99_ms"], rec["step_ms_p50"],
            rec["step_ms_p99"], steps, launches, oracle, card))
    return rec


# -- phase 4: where the time goes ----------------------------------------------

def trace_run(torch, card, label, kv_dtype, weight_dtype):
    """The same burst once more under ``torch.profiler``, through the
    scheduler directly (HTTP adds no device work): device busy time and
    the kernels that take it.  Runs after every untraced measurement,
    because the tracer slows every later launch of the process."""
    from torch.profiler import ProfilerActivity, profile

    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype,
                                weight_dtype=weight_dtype)
    sched = DecodeScheduler(model, name="trace-" + label,
                            kv_dtype=kv_dtype, **README_SERVER)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            futures = [sched.submit(p, NEW_TOKENS) for p in _prompts()]
            for f in futures:
                f.result(900)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        sched.close()
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _, _ in by_kernel) / 1e3
    if busy_ms <= 0:
        raise AssertionError("%s: the traced run ran nothing on the card"
                             % label)
    rec = {"label": label, "card": card, "traced_seconds": seconds,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / 1e3 / seconds,
           "device_launches": sum(c for _, c, _ in by_kernel),
           "top": [{"kernel": k[:80], "ms": t / 1e3, "count": c}
                   for t, c, k in by_kernel[:5]]}
    _log("trace %s: %.3f s traced, device busy %.3f ms (%.1f%%) over %d "
         "launches; top: %s [%s]"
         % (label, seconds, busy_ms, 100 * rec["device_busy_share"],
            rec["device_launches"],
            "; ".join("%s %.3f ms x%d" % (e["kernel"][:40], e["ms"],
                                          e["count"]) for e in rec["top"]),
            card))
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", metavar="PATH",
                        help="also write every number to PATH")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    from veles_tpu_torch import _build
    from veles_tpu_torch.device import resolve_device
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz import paged_attention as pa

    t_start = time.perf_counter()
    dev = resolve_device()
    card = _card_line()
    _log("card: %s" % card)
    _log("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    _log("built %s in %.2f s" % (", ".join(sorted(built)),
                                 time.perf_counter() - t0))
    for name, (_, log) in sorted(built.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                _log("  %s: %s" % (name, line.strip()))

    kernels = kernel_phase(torch, pa, gemm, dev)

    runs = [e2e_run(pa, gemm, card, label, kv, wd)
            for label, kv, wd in CONFIGS]
    by_label = {r["label"]: r for r in runs}
    launches = {
        "paged_attention_f32": sum(
            r["launches"]["paged_attention"] for r in runs
            if r["kv_dtype"] == "f32"),
        "paged_attention_int8":
            by_label["int8-kv"]["launches"]["paged_attention"],
        "quantized_matmul_int8":
            by_label["int8-weights"]["launches"]["quantized_matmul"],
        "quantized_matmul_fp8":
            by_label["fp8-weights"]["launches"]["quantized_matmul"],
    }
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("kernel %s never launched on the main "
                                 "path" % name)
    if by_label["f32"]["launches"]["quantized_matmul"]:
        raise AssertionError("the f32 model launched the quantized GEMM")

    meta = {   # name: (id in PERF.md's table, source, TPU kernel)
        "paged_attention_f32": (
            "K1", "csrc/paged_attention.cu",
            "veles_tpu/znicz/paged_attention.py:113 (_decode_kernel)"),
        "paged_attention_int8": (
            "K2", "csrc/paged_attention.cu",
            "veles_tpu/znicz/paged_attention.py:167 (_decode_kernel_quant)"),
        "quantized_matmul_int8": (
            "K3", "csrc/quantized_matmul.cu",
            "veles_tpu/znicz/gemm.py:261 (quantized_matmul kernel)"),
        "quantized_matmul_fp8": (
            "K3", "csrc/quantized_matmul.cu",
            "veles_tpu/znicz/gemm.py:261 (quantized_matmul kernel)"),
    }
    line = {"kernels": []}
    for name, (kid, src, replaces) in meta.items():
        main_rec = kernels[name]["main"]
        line["kernels"].append({
            "name": name, "id": kid, "route": "cuda",
            "source": "veles_tpu_torch/" + src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "shape": main_rec["shape"],
            "realistic": kernels[name]["realistic"]})
    traces = [trace_run(torch, card, *config) for config in CONFIGS]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": line["kernels"],
              "e2e": runs, "traces": traces,
              "seconds": time.perf_counter() - t_start}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    _log(json.dumps(line))
    _log(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
