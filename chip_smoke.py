#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA
   versions; build every kernel of ``veles_tpu_torch/csrc`` with nvcc
   and print ptxas's registers and spilled bytes for each instantiation.
2. Kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the main paths give it and at realistic
   shapes, timed with CUDA events beside the least time the card could
   take (``bound_ms``) and, where one PyTorch call computes the same
   function, that call (``library_ms``).  Tolerances: paged attention
   (K1 f32, K2 int8) ``max|kernel - plain| <= 1e-5``, at ``paged_cases``
   (the main path's shape, a realistic batch and a 65536-token context
   past a dense score row in shared memory), each record with
   the plan's split, the profiler's device time a call (the kernel and,
   split, the merge) and ``library_ms``: ``scaled_dot_product_attention``
   pinned to ``SDPA_BACKEND`` over the same valid tokens as a dense [B,
   H, Tmax, D] f32 cache (K2's dequantized) with a boolean length mask,
   the gather that builds it untimed; the quantized GEMM (K3, int8 and
   fp8) ``max|kernel - plain| <= 1e-5 * max|plain|``, timed at the main
   path's two expert GEMMs and at M = 1, 16 and 256 with K = N = 4096,
   with CUDA events and the profiler's device time, each record with the
   tile and the split-K its plan chose (a split call launches the fold
   too), its bound 4MNK TF32 operations (2xTF32) beside the CUDA-core
   bound of 2MNK f32 FMAs; the compensated GEMM
   (K4, levels 0/1/2) ``max|kernel - plain| <= 1e-6 * max(|a| @ |b|)``;
   against the exact product, level 1 must beat level 0 by 1e4x on a
   cancellation case, and level 2 must beat level 1 by 1e4x on a case
   where Neumaier's own carry rounds off; K4 is timed at the five MNIST
   shapes and at 4096^3 with CUDA events and with the profiler's device
   time, each call marked split or not (split-K launches the fold too),
   its bound 6MNK TF32 operations (3xTF32) beside the CUDA-core bound of
   2MNK f32 FMAs; untimed, at the MNIST forward shape (which splits) each
   level must equal the top-left corner of operands too large to split
   bit for bit.  Flash attention (K7 forward,
   K8 dq, K9 dk/dv) on ``randn * 0.5`` inputs, q/k/v as strided views of
   one packed projection: out and lse ``max|kernel - plain| <= 2e-5``,
   each gradient ``<= 5e-4 * max(1, max|plain|)``; at head dims 4, 8, 16,
   T = 7, 8, 256, windows 1-256 and at head dims 129, 192, 256, T = 7,
   256 (untimed), at the main path's shape (B=8, T=2048, H=8, D=64: no
   mask, causal, causal with window 512), at the JAX package's bench
   shapes (B=2, T=2048 causal; B=1, T=16384, window 512) and at head
   dims 128 and 256 (B=2, T=2048, causal); each timed with CUDA events
   and the profiler's device time, with the instantiation (head-dim
   tile) that ran; each kernel's bound is 3x its useful operations at
   the TF32 rate (3xTF32), beside the CUDA-core bound; ``library_ms``
   is ``scaled_dot_product_attention`` pinned to its memory-efficient
   backend (3xTF32 ``mma.sync`` on f32 inputs) on the same f32 inputs,
   its forward on K7's row and its backward on K8's and K9's.  LRN (K5
   forward, K6 backward) on ``randn * 2`` inputs:
   ``max|kernel - plain| <= 1e-5 * max(1, max|plain|)``, at n 1-5 and C
   1-5000 with alpha 0.5 (untimed; how many of them are bitwise equal is
   printed), and timed at the main paths' LRN shapes with CUDA events
   and the profiler's device time: AlexNet's two at minibatch 128 (the
   first is the kernels line's record) and the LRN convnet's two at
   minibatch 100, each record saying whether kernel and plain version
   are bitwise equal; ``library_ms`` is ``F.local_response_norm`` on the
   NCHW view of the same input, its forward on K5's row and its autograd
   backward on K6's.
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
4. Training (slice 2): the MNIST sample through ``create_workflow()``
   → ``initialize()`` → ``run()`` on the card at the gate's settings
   (784-100-10, minibatch 60, 25 epochs, fail_iterations 12, loader
   seed 3, weights seed 42, the committed digits fixture), with plain
   matmuls and with ``precise_gemm`` 1 and 2 (every All2All matmul,
   forward and backward, on K4).  Each run's best validation error must
   be <= 1.48 %; K4 launches are counted from 0 over each run, per train
   and per eval step.  The first epoch of the ``precise_gemm=1`` run is
   held against the same epoch run by the port on the CPU: n_err of each
   class within 1, weights within ``max|card - cpu| <= 1e-4``.
4b. Training (slice 3): ``MultiHeadAttention`` (d_model 512, 8 heads)
   and a softmax head through ``StandardWorkflow`` on the needle task of
   the JAX package's tests/test_attention_unit.py (find the marked
   position's payload class), T=2048, 480 sequences (360 train, 120
   valid), minibatch 8, 5 epochs, lr 0.01 and momentum 0.9 on both
   layers; without a mask and causal with window 512.  Every train step
   launches K7, K8 and K9 once, every eval step K7 once; every loss is
   finite and the last epoch's mean train loss is below the first's.
   The first epoch of each, cut to 24 sequences (16 train, 8 valid), is
   held against the port on the CPU (``use_pallas=True``: the plain
   versions): n_err of each class within 1, weights within
   ``max|card - cpu| <= 1e-4``.  Then the JAX test's own run (T=8, D=8,
   2 heads, 600 sequences, minibatch 50, 25 epochs) must reach a best
   validation error < 40 %.
4c. Training (slice 4): the AlexNet sample at its published widths
   (227x227x3, conv 96/256/384/384/256 with LRN after the first two, fc
   4096/4096 with dropout 0.5, softmax 1000, minibatch 128) through
   ``create_workflow()`` on its synthetic loader's defaults (2048 train
   + 256 valid images, 1.42 GB resident), 3 epochs, dropout on: once
   with ``use_pallas`` unset (K5 twice every step, K6 twice every train
   step) and once with the band form (``use_pallas=False``, neither
   kernel).  Train images/s is the median epoch after the first.  Every
   loss must be finite.  The first 2 train steps at minibatch 128 (on
   256 train + 128 valid images) are held against the port on the CPU:
   each loss within 1e-4 relative, each parameter tensor within 1e-4 of
   its largest magnitude, each dropout mask drawn on the card equal to
   the CPU's bit for bit.
4d. Training (slice 4): the LRN convnet (conv 32 5x5 → LRN → max 3x3/2,
   twice, then fc 64 → dropout 0.5 → softmax 10; lr 0.02, momentum 0.9)
   on the CIFAR sample's synthetic data (5000 train + 1000 valid,
   range_linear), minibatch 100, 5 epochs: best validation error < 25 %,
   K5/K6 launched on every step.
5. Where the time goes: each serving configuration's burst, one
   training epoch of each matmul mode, one full-width attention epoch
   of each mask (none; causal, window 512) and one AlexNet epoch with
   each LRN form once
   more under ``torch.profiler`` (after every untraced measurement):
   the share of the wall time the card is busy, the top kernels, the
   device copies and cuDNN's layout transforms, the int64
   elementwise kernels (dropout's threefry draws), and the device time
   of K1 and K2 (with their merge), K3, K4 (each with its split-K
   fold), K5 and K6.  Each serving
   configuration's tok/s and decode step p50 (phase 3) are printed
   beside its traced burst's launches and device-to-device copies.
   A trace that holds no device time is taken again on a fresh run, up
   to ``TRACE_TRIES`` times in all; a run with none in every try fails.
6. The ``kernels`` JSON line, the card's line, and the result line.
   Each phase prints its wall time.

Imports nothing of JAX or of the JAX package.  ``--json PATH`` writes
every number to PATH as well.
"""

import argparse
import json
import math
import re
import shutil
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
#: dense TF32 tensor-core FLOP/s (the same data sheet)
TF32_FLOPS = 495e12

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


def _device_ms(torch, fn, iters=20, launches=None, per_launch=False):
    """Mean device time of the kernels ``fn`` launches, from
    ``torch.profiler`` (device rows only, after one warm-up call).  With
    ``launches`` (the kernels one call launches), a profile that holds
    another count lost records and is taken again, as one with no
    device time is, up to ``TRACE_TRIES`` in all.  ``per_launch``, for a
    call that launches each of its kernels once: the sum of each
    kernel's mean over the launches the profile holds, so a record it
    lost biases nothing."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = None if launches is None else launches * iters
    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof.key_averages())
        seen = sum(c for _, c, _ in rows)
        if rows and per_launch:
            return sum(t / c for t, c, _ in rows) / 1e3
        if rows and want in (None, seen):
            return sum(t for t, _, _ in rows) / 1e3 / iters
        _log("the profiler saw %d device launches, %s wanted (try %d of %d)"
             % (seen, want or "some", tries, TRACE_TRIES))
    raise AssertionError("the profiler saw %d device launches, %s wanted"
                         % (seen, want or "some"))


def ptxas_report(log):
    """-> [[function, registers, spill-store bytes, spill-load bytes]],
    one for each entry function of ``nvcc -Xptxas -v`` output ``log``,
    demangled and shortened where ``c++filt`` or ``cu++filt`` is found."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), *spills])
            name = None
    tool = shutil.which("c++filt") or shutil.which("cu++filt") or \
        shutil.which("cu++filt", path="/usr/local/cuda/bin")
    if out and tool:
        names = subprocess.run([tool], input="\n".join(r[0] for r in out),
                               capture_output=True, text=True, timeout=60)
        plain = names.stdout.splitlines()
        if names.returncode == 0 and len(plain) == len(out):
            for rec, full in zip(out, plain):
                short = full.replace("(anonymous namespace)::", "")
                rec[0] = short.split("(")[0].replace("void ", "", 1)
    return out


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


def _sdpa_paged(torch, pa, args, kw, scale):
    """``scaled_dot_product_attention`` over the same valid tokens laid
    out as a dense [B, H, Tmax, D] f32 cache (K2's dequantized) with a
    boolean length mask, pinned to ``SDPA_BACKEND``: (call, its output).
    The gather that builds the cache stays outside the call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, kp, vp, table, lens = args
    b, h, d = q.shape
    t_max = int(lens.max())
    if kw:
        kp = pa.dequantize_pool(kp, kw["k_scales"])
        vp = pa.dequantize_pool(vp, kw["v_scales"])
    k, v = (p[table.long()].reshape(b, -1, h, d)[:, :t_max]
            .permute(0, 2, 1, 3).contiguous() for p in (kp, vp))
    del kp, vp
    mask = (torch.arange(t_max, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    backend = getattr(SDPBackend, SDPA_BACKEND)

    def run():
        with sdpa_kernel(backend):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, scale=scale)
    return run, run()[:, :, 0]


def _measure_paged(torch, pa, dev, label, shape, lengths, quant, seed):
    b, h, d, bs, nb = shape
    args, kw, nbytes, flops = _paged_case(torch, pa, dev, b, h, d, bs, nb,
                                          lengths, quant, seed)
    plan = pa._cached_plan(b, h, d, bs, nb, quant, dev)
    merges = pa.paged_attention.merge_launches
    out = pa.paged_attention(*args, **kw)
    if (pa.paged_attention.merge_launches > merges) != (plan.split > 1):
        raise AssertionError("%s: planned split %d, merge launched %d "
                             "times" % (label, plan.split,
                                        pa.paged_attention.merge_launches
                                        - merges))
    ref = pa.paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= 1e-5:
        raise AssertionError("%s: max|kernel - plain| = %g > 1e-5"
                             % (label, err))
    library, lib_out = _sdpa_paged(torch, pa, args, kw, 1.0 / math.sqrt(d))
    live = args[4] > 0          # SDPA gives no zeros for a length-0 row
    lib_err = float((lib_out[live] - ref[live]).abs().max())
    del out, ref, lib_out
    bound_ms, bound_by = _bound(nbytes, flops)
    call = lambda: pa.paged_attention(*args, **kw)  # noqa: E731
    rec = {"shape": "B=%d H=%d D=%d bs=%d nb=%d tokens=%d"
                    % (b, h, d, bs, nb, sum(lengths)),
           "max_abs_err": err, "split": plan.split,
           "plan": list(plan),
           "ms": _cuda_ms(torch, call),
           "device_ms": _device_ms(torch, call, per_launch=True),
           "plain_ms": _cuda_ms(
               torch, lambda: pa.paged_attention_reference(*args, **kw),
               iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _cuda_ms(torch, library, iters=10),
           "library_max_abs_err": lib_err}
    _log("kernel %s [%s] split %d (%d blocks) tile %d "
         "max_err=%.3g kernel_ms=%.4f device_ms=%.4f (a call: the kernel "
         "and, split, the merge) plain_ms=%.4f bound_ms=%.4f (%s) "
         "library_ms=%.4f (scaled_dot_product_attention %s over a dense "
         "[B, H, Tmax, D] f32 cache with a length mask, the gather "
         "untimed; within %.3g of the plain version on rows of length > "
         "0)" % (label, rec["shape"], *plan, err, rec["ms"],
                 rec["device_ms"], rec["plain_ms"], bound_ms, bound_by,
                 rec["library_ms"], SDPA_BACKEND, lib_err))
    return rec


def _measure_qmm(torch, gemm, dev, label, m, k, n, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    w_q, s = gemm.quantize_weight(w, dtype)
    tile, split, k_split = gemm.quantized_matmul_plan(m, k, n, dev)
    folds = gemm.quantized_matmul.fold_launches
    out = gemm.quantized_matmul(a, w_q, s)
    if (gemm.quantized_matmul.fold_launches > folds) != (split > 1):
        raise AssertionError("%s: planned split %d, fold launched %d "
                             "times" % (label, split,
                                        gemm.quantized_matmul.fold_launches
                                        - folds))
    ref = gemm.quantized_matmul_reference(a, w_q, s)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= 1e-5:
        raise AssertionError("%s: max|kernel - plain| / max|plain| = %g "
                             "> 1e-5" % (label, rel))
    w_deq = w_q.to(torch.float32) * s[None, :]
    nbytes = m * k * 4 + k * n * w_q.element_size() + n * 4 + m * n * 4
    # the card's least time: two TF32 tensor-core products (4MNK; the
    # weights are exact in TF32, the activations split in two), or the
    # bytes; the CUDA-core bound (2MNK f32 FMAs) stands beside it
    bound_ms, bound_by = _bound(nbytes, 0)
    t_ops = 4 * m * n * k / TF32_FLOPS * 1e3
    if t_ops > bound_ms:
        bound_ms, bound_by = t_ops, "operations"
    call = lambda: gemm.quantized_matmul(a, w_q, s)  # noqa: E731
    rec = {"shape": "M=%d K=%d N=%d" % (m, k, n),
           "max_abs_err": err, "max_rel_err": rel,
           "tile_m": tile, "split": split, "k_split": k_split,
           "ms": _cuda_ms(torch, call),
           "device_ms": _device_ms(torch, call,
                                   launches=2 if split > 1 else 1),
           "plain_ms": _cuda_ms(
               torch, lambda: gemm.quantized_matmul_reference(a, w_q, s)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "cuda_core_bound_ms": _bound(nbytes, 2 * m * n * k)[0],
           "library_ms": _cuda_ms(torch, lambda: torch.matmul(a, w_deq))}
    _log("kernel %s [%s] tile %dx128 split %d (%d deep) max_err=%.3g (rel "
         "%.3g) kernel_ms=%.4f device_ms=%.4f plain_ms=%.4f bound_ms=%.5f "
         "(%s; CUDA cores %.5f) library_ms=%.4f (torch.matmul on the "
         "dequantized f32 weights)"
         % (label, rec["shape"], tile, split, k_split, err, rel, rec["ms"],
            rec["device_ms"], rec["plain_ms"], bound_ms, bound_by,
            rec["cuda_core_bound_ms"], rec["library_ms"]))
    return rec


#: (M, K, N) of K3's realistic calls: a lone decode row, the decode
#: step's 16 rows an expert and a 256-row prefill, at K = N = 4096
QMM_REALISTIC = ((1, 4096, 4096), (16, 4096, 4096), (256, 4096, 4096))


def k3_phase(torch, gemm, dev):
    """-> {"quantized_matmul_int8" / "_fp8": {"main": record,
    "realistic": [records]}}: K3 at the main path's two expert GEMMs
    (16 rows at decode; the first is the kernels line's record) and at
    ``QMM_REALISTIC``."""
    out = {}
    for dtype in ("int8", "fp8"):
        name = "quantized_matmul_" + dtype
        main = _measure_qmm(torch, gemm, dev, name, 16, 64, 128, dtype, 3)
        second = _measure_qmm(torch, gemm, dev, name, 16, 128, 64, dtype, 4)
        out[name] = {
            "main": main,
            "realistic": [second] + [
                _measure_qmm(torch, gemm, dev, name, m, k, n, dtype, 5 + m)
                for m, k, n in QMM_REALISTIC]}
    return out


def paged_cases():
    """[(label, (B, H, D, block_size, max_blocks), lengths)] of K1/K2:
    the main path (README widths: H=4, D=16, bs=16, 16 blocks a row;
    decode lengths 1 .. 160, prompt <= 128 plus 32 new tokens), a
    serving-realistic batch (B=32, H=8, D=128, bs=16, 128 blocks a row,
    ragged lengths in [0, 2048] with one empty and one full row) and a
    long context (B=2, 4096 blocks a row, 65536 and 40000 tokens: 1.07
    GB of f32 pools; a dense score row of it would pass shared memory)."""
    rng = numpy.random.RandomState(0)
    main_lengths = [1] + rng.randint(1, 161, 15).tolist()
    big_lengths = [0, 2048] + rng.randint(0, 2049, 30).tolist()
    return [("main", (16, 4, 16, 16, 16), main_lengths),
            ("realistic", (32, 8, 128, 16, 128), big_lengths),
            ("long", (2, 8, 128, 16, 4096), [65536, 40000])]


def kernel_phase(torch, pa, gemm, dev):
    """-> {kernel name: {"main": record, "realistic": [records]}}."""
    out = {}
    for name, quant in (("paged_attention_f32", False),
                        ("paged_attention_int8", True)):
        recs = [_measure_paged(torch, pa, dev, name, shape, lengths, quant,
                               seed=1 if label == "main" else 2)
                for label, shape, lengths in paged_cases()]
        out[name] = {"main": recs[0], "realistic": recs[1:]}
        torch.cuda.empty_cache()
    out.update(k3_phase(torch, gemm, dev))
    return out


# -- phase 2, K4: the compensated GEMM ----------------------------------------

#: (label, M, K, N, layout) of every K4 call of an MNIST train step at
#: minibatch 60 (784-100-10); "at" = a is a transposed view, "bt" = b is
K4_MAIN_SHAPES = (("fwd 60x784 @ 784x100", 60, 784, 100, ""),
                  ("fwd 60x100 @ 100x10", 60, 100, 10, ""),
                  ("bwd dx g @ W2^T", 60, 10, 100, "bt"),
                  ("bwd dW2 h^T @ g", 100, 60, 10, "at"),
                  ("bwd dW1 x^T @ g", 784, 60, 100, "at"))
#: the JAX package's realistic precise-GEMM shape (bench.py)
K4_REALISTIC = (4096, 4096, 4096)
#: compensation flops per output element per K tile, beyond the 2MNK
#: multiply-adds: level 0 one add, level 1 TwoSum (6) + carry (1),
#: level 2 two TwoSums + carry; plus the final fold (2)
K4_COMP_OPS = {0: 1, 1: 7, 2: 13}


def _k4_operands(torch, dev, m, k, n, layout, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if "at" in layout:
        a = torch.randn((k, m), generator=gen, device=dev).t()
    else:
        a = torch.randn((m, k), generator=gen, device=dev)
    if "bt" in layout:
        b = torch.randn((n, k), generator=gen, device=dev).t()
    else:
        b = torch.randn((k, n), generator=gen, device=dev)
    return a, b


def _measure_k4(torch, gemm, dev, level, label, m, k, n, layout, seed,
                iters=20):
    a, b = _k4_operands(torch, dev, m, k, n, layout, seed)
    folds = gemm.precise_matmul.fold_launches
    out = gemm.precise_matmul(a, b, level)
    split = gemm.precise_matmul.fold_launches > folds
    ref = gemm.precise_matmul_reference(a, b, level)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float((a.abs() @ b.abs()).max())
    if not err <= 1e-6 * scale:
        raise AssertionError("K4 level %d %s: max|kernel - plain| = %g > "
                             "1e-6 * %g" % (level, label, err, scale))
    tiles = -(-k // gemm.DEFAULT_BLOCK_K)
    comp = m * n * (tiles * K4_COMP_OPS[level] + 2)
    nbytes = (m * k + k * n + m * n) * 4
    # the card's least time: three TF32 products (6MNK on the tensor
    # cores) beside the compensation on the CUDA cores, or the bytes;
    # the CUDA-core bound (2MNK f32 FMAs) stands beside it
    bound_ms, bound_by = _bound(nbytes, 0)
    t_ops = max(6 * m * n * k / TF32_FLOPS, comp / F32_FLOPS) * 1e3
    if t_ops > bound_ms:
        bound_ms, bound_by = t_ops, "operations"
    cuda_core_ms = _bound(nbytes, 2 * m * n * k + comp)[0]
    call = lambda: gemm.precise_matmul(a, b, level)  # noqa: E731
    rec = {"shape": "M=%d K=%d N=%d %s" % (m, k, n, layout or "row-major"),
           "label": label, "level": level, "max_abs_err": err,
           "split": split, "ms": _cuda_ms(torch, call, iters=iters),
           "device_ms": _device_ms(torch, call, iters=iters,
                                   launches=1 + split),
           "plain_ms": _cuda_ms(
               torch, lambda: gemm.precise_matmul_reference(a, b, level),
               iters=iters),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "cuda_core_bound_ms": cuda_core_ms,
           "library_ms": _cuda_ms(torch, lambda: torch.matmul(a, b),
                                  iters=iters)}
    _log("kernel precise_matmul level %d [%s: %s] max_err=%.3g (scale %.3g)"
         " split=%s kernel_ms=%.4f device_ms=%.4f plain_ms=%.4f "
         "bound_ms=%.5f (%s; CUDA cores %.5f) library_ms=%.4f "
         "(torch.matmul, TF32 off)"
         % (level, label, rec["shape"], err, scale, split, rec["ms"],
            rec["device_ms"], rec["plain_ms"], bound_ms, bound_by,
            cuda_core_ms, rec["library_ms"]))
    return rec


def _k4_split_equal(torch, gemm, dev):
    """Untimed: at the MNIST forward shape (which splits K) each level
    equals, bit for bit, the top-left corner of operands too large to
    split."""
    _, m, k, n, _ = K4_MAIN_SHAPES[0]
    out = {}
    for level in (0, 1, 2):
        a_big, b_big = _k4_operands(torch, dev, 2048, k, 1024, "",
                                    seed=50 + level)
        folds = gemm.precise_matmul.fold_launches
        small = gemm.precise_matmul(a_big[:m].contiguous(),
                                    b_big[:, :n].contiguous(), level)
        split = gemm.precise_matmul.fold_launches - folds
        big = gemm.precise_matmul(a_big, b_big, level)
        torch.cuda.synchronize()
        unsplit = gemm.precise_matmul.fold_launches - folds == split
        equal = bool(torch.equal(small, big[:m, :n]))
        if not (split == 1 and unsplit and equal):
            raise AssertionError(
                "K4 level %d: split %d, large call unsplit %s, split equal "
                "to unsplit %s" % (level, split, unsplit, equal))
        out[level] = equal
    _log("kernel precise_matmul split-K: M=%d K=%d N=%d splits and equals "
         "the unsplit corner bit for bit at levels 0-2" % (m, k, n))
    return out


def _k4_errors(torch, gemm, dev, a, b, exact):
    """max|K4 - exact| of each level."""
    err = {}
    for level in (0, 1, 2):
        out = gemm.precise_matmul(torch.tensor(a, device=dev),
                                  torch.tensor(b, device=dev), level)
        err[level] = float(numpy.abs(out.cpu().numpy() - exact).max())
    return err


def _k4_cancellation(torch, gemm, dev):
    """Two cases against the exact product.  Level 1: huge +/-3e7 K
    tiles bracket small ones; plain accumulation of the tile partials
    loses the small tiles, compensation recovers them (the JAX
    package's tests/test_precise_gemm.py criterion).  Level 2: a 2**40
    tile, ten triples of tiles x, y, -x (x in [1, 2), y ~ 1e-9), a
    -2**40 tile; Neumaier's carry rounds every y away, Klein's second
    carry keeps them (one nonzero per tile and power-of-two columns
    make every tile partial exact; the exact sum is ``math.fsum``)."""
    rng = numpy.random.RandomState(1)
    bk = gemm.DEFAULT_BLOCK_K
    row = numpy.zeros(4 * bk, numpy.float32)
    row[:bk] = 3e7
    row[bk:2 * bk] = rng.uniform(-1, 1, bk)
    row[2 * bk:3 * bk] = -3e7
    row[3 * bk:] = rng.uniform(-1, 1, bk)
    a = numpy.tile(row[None, :], (8, 1))
    b = numpy.ones((4 * bk, 8), numpy.float32)
    err = _k4_errors(torch, gemm, dev, a, b,
                     a.astype(numpy.float64) @ b.astype(numpy.float64))
    _log("kernel precise_matmul cancellation: max|out - f64| level 0 %.4g, "
         "level 1 %.4g, level 2 %.4g" % (err[0], err[1], err[2]))
    if not (err[0] > 0.1 and err[1] < err[0] / 1e4 and
            err[2] <= err[1] * 1.01):
        raise AssertionError("K4 compensation does not hold: %r" % err)

    rng = numpy.random.RandomState(2)
    reps = 10
    tiles = 2 + 3 * reps
    a = numpy.zeros((8, tiles * bk), numpy.float32)
    for i in range(8):
        vals = [2.0 ** 40]
        for _ in range(reps):
            x = rng.uniform(1, 2)
            vals += [x, rng.uniform(2.0 ** -31, 2.0 ** -30), -x]
        vals.append(-2.0 ** 40)
        for t, v in enumerate(vals):
            a[i, t * bk + rng.randint(bk)] = v
    cols = 2.0 ** numpy.arange(8, dtype=numpy.float32)
    b = numpy.tile(cols[None, :], (tiles * bk, 1))
    exact = numpy.array([math.fsum(r) for r in a.astype(numpy.float64)])
    exact = exact[:, None] * cols[None, :].astype(numpy.float64)
    klein = _k4_errors(torch, gemm, dev, a, b, exact)
    _log("kernel precise_matmul second carry: max|out - exact| level 0 "
         "%.4g, level 1 %.4g, level 2 %.4g (max|exact| %.4g)"
         % (klein[0], klein[1], klein[2], float(numpy.abs(exact).max())))
    if not (klein[1] > 0.5 * float(numpy.abs(exact).max()) and
            klein[2] < klein[1] / 1e4):
        raise AssertionError("K4 level 2 does not keep its second carry: "
                             "%r" % klein)
    return {"cancellation": err, "second_carry": klein}


def k4_phase(torch, gemm, dev):
    """-> {level: {"main": [records], "realistic": [record]}},
    cancellation errors."""
    out = {}
    for level in (0, 1, 2):
        out[level] = {
            "main": [_measure_k4(torch, gemm, dev, level, label, m, k, n,
                                 layout, seed=10 * level + i)
                     for i, (label, m, k, n, layout)
                     in enumerate(K4_MAIN_SHAPES)],
            "realistic": [_measure_k4(torch, gemm, dev, level, "bench",
                                      *K4_REALISTIC, "", seed=99,
                                      iters=5)]}
    checks = _k4_cancellation(torch, gemm, dev)
    checks["split_equal"] = _k4_split_equal(torch, gemm, dev)
    return out, checks


# -- phase 2, K7-K9: flash attention ------------------------------------------

#: (B, T, H, D) of the main path: the attention unit at d_model 512,
#: 8 heads, T 2048, minibatch 8; and its masks (causal, window)
FLASH_MAIN = (8, 2048, 8, 64)
FLASH_MASKS = ((False, None), (True, None), (True, 512))
#: the JAX package's measured shapes (bench.py:543 bench_flash_attention,
#: :577 bench_window_attention)
FLASH_REALISTIC = (((2, 2048, 8, 64), True, None),
                   ((1, 16384, 8, 64), True, 512),
                   ((2, 2048, 4, 128), True, None),
                   ((2, 2048, 2, 256), True, None))
#: (B, T, H, D, causal, window) held untimed: head dims below a tile, T
#: below and at a tile, the JAX tests' windows, and T=256 with window
#: 40, where both backward passes are banded (test_flash_attention.py);
#: head dims past 128 (the 256 instantiation, zero-padded below 256)
FLASH_SMALL = tuple(
    [(2, t, 2, d, c, w) for d in (4, 8, 16) for t in (7, 8, 256)
     for c, w in ((False, None), (True, None), (True, 5))] +
    [(1, 256, 2, 16, True, w) for w in (1, 5, 64, 100, 256)] +
    [(1, 256, 2, 8, True, 40)] +
    [(2, t, 2, d, c, w) for d in (129, 192, 256) for t in (7, 256)
     for c, w in ((False, None), (True, None), (True, 40))])
#: the head-dim tiles the kernels are instantiated at (csrc dispatch)
FLASH_D_TILES = (32, 64, 128, 256)
FLASH_FWD_TOL = 2e-5
FLASH_GRAD_TOL = 5e-4


def _flash_inputs(torch, dev, b, t, h, d, seed):
    """q, k, v as strided views of one packed [B, T, 3 H D] tensor (the
    unit's layout) and a contiguous dO, all ``randn * 0.5``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev) * 0.5
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen, device=dev) * 0.5
    return q, k, v, do


def _visible(t, causal, window):
    """(query, key) pairs the mask lets through, per batch * head."""
    if not causal:
        return t * t
    if window is None:
        return t * (t + 1) // 2
    w = min(window, t)
    return w * (w + 1) // 2 + (t - w) * w


def _flash_check(torch, fa, q, k, v, do, causal, window, label):
    """Each kernel against its plain version on the same inputs (K8 and
    K9 get the plain forward's lse and delta); -> (errors, plain out,
    lse, delta)."""
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = fa.flash_delta(do, ref_out)
    dq = fa.flash_attention_dq(q, k, v, do, ref_lse, delta, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, ref_lse, delta, **kw)
    ref_dq = fa.flash_dq_reference(q, k, v, do, ref_lse, delta, **kw)
    ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta,
                                            **kw)
    torch.cuda.synchronize()

    def worst(pairs, tol, scaled):
        """max|kernel - plain| over ``pairs``, each held to ``tol`` (times
        max(1, max|plain|) where ``scaled``)."""
        out = 0.0
        for a, r in pairs:
            e = float((a - r).abs().max())
            limit = tol * (max(1.0, float(r.abs().max())) if scaled else 1)
            if not e <= limit:
                raise AssertionError("flash attention %s: max|kernel - "
                                     "plain| = %g > %g" % (label, e, limit))
            out = max(out, e)
        return out

    err = {"fwd": worst(((out, ref_out), (lse, ref_lse)), FLASH_FWD_TOL,
                        False),
           "dq": worst(((dq, ref_dq),), FLASH_GRAD_TOL, True),
           "dkv": worst(((dk, ref_dk), (dv, ref_dv)), FLASH_GRAD_TOL, True)}
    return err, ref_out, ref_lse, delta


#: the backend the library yardstick is pinned to: on f32 inputs the
#: memory-efficient kernel, whose products are 3xTF32 on mma.sync
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def _sdpa_calls(torch, q, k, v, do, causal, window):
    """``scaled_dot_product_attention`` on the same f32 inputs, pinned to
    ``SDPA_BACKEND``: (forward, backward, forward output) for timing; a
    window is a boolean band.  Each call runs inside the pin, so the
    yardstick cannot change backend from run to run."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = torch.nn.functional
    backend = getattr(SDPBackend, SDPA_BACKEND)
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    kw = {"is_causal": causal}
    if window is not None:
        t = q.shape[1]
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        kw = {"attn_mask": (cols <= rows) & (cols > rows - window)}
    with sdpa_kernel(backend):
        out = f.scaled_dot_product_attention(qh, kh, vh, **kw)
    g = do.transpose(1, 2).contiguous()

    def fwd():
        with torch.no_grad(), sdpa_kernel(backend):
            return f.scaled_dot_product_attention(qh, kh, vh, **kw)

    def bwd():
        with sdpa_kernel(backend):
            return torch.autograd.grad(out, (qh, kh, vh), g,
                                       retain_graph=True)

    return fwd, bwd, out.detach().transpose(1, 2)


def _measure_flash(torch, fa, dev, shape, causal, window, seed):
    """One timed case: -> {kernel name: record}."""
    b, t, h, d = shape
    q, k, v, do = _flash_inputs(torch, dev, b, t, h, d, seed)
    label = "B=%d T=%d H=%d D=%d %s" % (
        b, t, h, d, "no mask" if not causal else
        "causal" if window is None else "causal window=%d" % window)
    err, ref_out, lse, delta = _flash_check(torch, fa, q, k, v, do, causal,
                                            window, label)
    kw = dict(causal=causal, window=window)
    sdpa_fwd, sdpa_bwd, sdpa_out = _sdpa_calls(torch, q, k, v, do, causal,
                                               window)
    library = {"fwd": _cuda_ms(torch, sdpa_fwd, iters=10),
               "bwd": _cuda_ms(torch, sdpa_bwd, iters=10)}
    library_err = float((sdpa_out - ref_out).abs().max())
    del sdpa_fwd, sdpa_bwd, sdpa_out
    vis, bh, elem = _visible(t, causal, window), b * h, b * t * h * d
    d_tile = min(x for x in FLASH_D_TILES if x >= d)
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, **kw),
            lambda: fa.flash_fwd_reference(q, k, v, **kw),
            4 * (4 * elem + bh * t), 4 * bh * vis * d, library["fwd"],
            err["fwd"]),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),
            lambda: fa.flash_dq_reference(q, k, v, do, lse, delta, **kw),
            4 * (5 * elem + 2 * bh * t), 6 * bh * vis * d, library["bwd"],
            err["dq"]),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
            lambda: fa.flash_dkv_reference(q, k, v, do, lse, delta, **kw),
            4 * (6 * elem + 2 * bh * t), 8 * bh * vis * d, library["bwd"],
            err["dkv"])}
    recs = {}
    for name, (kernel, plain, nbytes, flops, lib_ms, e) in calls.items():
        # three TF32 tensor-core products a useful one (3xTF32); the
        # CUDA-core bound stands beside it
        bound_ms = _bound(nbytes, flops)[0]
        tc_ms = 3 * flops / TF32_FLOPS * 1e3
        rec = {"shape": label, "max_abs_err": e, "d_tile": d_tile,
               "ms": _cuda_ms(torch, kernel),
               "device_ms": _device_ms(torch, kernel, launches=1),
               "plain_ms": _cuda_ms(torch, plain, iters=3, warmup=1),
               "tf32x3_bound_ms": tc_ms, "cuda_core_bound_ms": bound_ms,
               "library_ms": lib_ms, "flops": flops}
        rec["bound_ms"], rec["bound_by"] = max((tc_ms, "operations"),
                                               _bound(nbytes, 0))
        _log("kernel %s [%s] D tile %d max_err=%.3g kernel_ms=%.4f "
             "device_ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s; CUDA cores "
             "%.4f) library_ms=%.4f (scaled_dot_product_attention %s on "
             "%s; its output within %.3g of the plain one)"
             % (name, label, d_tile, e, rec["ms"], rec["device_ms"],
                rec["plain_ms"], rec["bound_ms"], rec["bound_by"],
                bound_ms, lib_ms, "forward" if name.endswith("fwd")
                else "backward, dq+dk+dv", SDPA_BACKEND, library_err))
        recs[name] = rec
    return recs


def flash_phase(torch, fa, dev):
    """-> {kernel name: {"main": record, "realistic": [records]}}: the
    small cases untimed, then the main path's three masks and the bench
    shapes timed."""
    for i, (b, t, h, d, causal, window) in enumerate(FLASH_SMALL):
        _flash_check(torch, fa, *_flash_inputs(torch, dev, b, t, h, d, i),
                     causal, window, "B=%d T=%d H=%d D=%d causal=%s "
                     "window=%s" % (b, t, h, d, causal, window))
    _log("kernel flash attention: %d small cases (head dims 4/8/16, T "
         "7/8/256, windows 1-256; head dims 129/192/256, T 7/256) within "
         "the limits" % len(FLASH_SMALL))
    cases = [_measure_flash(torch, fa, dev, FLASH_MAIN, causal, window,
                            seed=100 + i)
             for i, (causal, window) in enumerate(FLASH_MASKS)]
    cases += [_measure_flash(torch, fa, dev, shape, causal, window,
                             seed=200 + i)
              for i, (shape, causal, window) in enumerate(FLASH_REALISTIC)]
    return {name: {"main": cases[0][name],
                   "realistic": [c[name] for c in cases[1:]]}
            for name in cases[0]}


# -- phase 2, K5/K6: LRN ------------------------------------------------------

#: (label, NHWC shape) of the LRN layers of the main paths: AlexNet's two
#: at minibatch 128 (227x227 input), then the LRN convnet's two at
#: minibatch 100 (32x32 input)
LRN_SHAPES = (("AlexNet LRN1", (128, 55, 55, 96)),
              ("AlexNet LRN2", (128, 27, 27, 256)),
              ("LRN convnet LRN1", (100, 32, 32, 32)),
              ("LRN convnet LRN2", (100, 15, 15, 32)))
#: AlexNet's LRN parameters (n, alpha, beta, k), the LRN convnet's too
LRN_PARAMS = (5, 1e-4, 0.75, 2.0)
#: (shape, (n, alpha, beta, k)) held untimed: even and odd n, ragged C,
#: C past one 4096-float tile (K6's shared memory opt-in), an alpha that
#: makes the window sum matter
LRN_SMALL = tuple(
    [((3, 5, 7, c), (n, 0.5, 0.75, 2.0)) for c in (1, 7, 16, 33, 96, 256)
     for n in (1, 2, 4, 5)] +
    [((2, 3, 3, 5000), (5, 0.5, 0.6, 1.5)),
     ((4, 9, 9, 96), (3, 1e-4, 0.75, 2.0))])
LRN_TOL = 1e-5


def _lrn_inputs(torch, dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * 2.0
    g = torch.randn(shape, generator=gen, device=dev)
    return x, g


def _lrn_check(torch, lrn_mod, x, g, params, label):
    """K5 and K6 against their plain versions on the same inputs: errors
    ``max|kernel - plain| <= LRN_TOL * max(1, max|plain|)``; -> ({"fwd" /
    "bwd": error}, {"fwd" / "bwd": bitwise equal}, the plain forward)."""
    y = lrn_mod.lrn(x, *params)
    dx = lrn_mod.lrn_backward(x, g, *params)
    ref_y = lrn_mod.lrn_reference(x, *params)
    ref_dx = lrn_mod.lrn_backward_reference(x, g, *params)
    torch.cuda.synchronize()
    err, equal = {}, {}
    for name, a, r in (("fwd", y, ref_y), ("bwd", dx, ref_dx)):
        e = float((a - r).abs().max())
        limit = LRN_TOL * max(1.0, float(r.abs().max()))
        if not e <= limit:
            raise AssertionError("LRN %s %s: max|kernel - plain| = %g > %g"
                                 % (name, label, e, limit))
        err[name] = e
        equal[name] = bool(torch.equal(a, r))
    return err, equal, ref_y


def _measure_lrn(torch, lrn_mod, dev, label, shape, seed):
    """One timed case: -> {kernel name: record}."""
    f = torch.nn.functional
    x, g = _lrn_inputs(torch, dev, shape, seed)
    n = LRN_PARAMS[0]
    err, equal, ref_y = _lrn_check(torch, lrn_mod, x, g, LRN_PARAMS, label)
    # the library's LRN takes NCHW: the channels_last view of NHWC x
    xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
    lib_out = f.local_response_norm(xl, *LRN_PARAMS)
    lib_err = float((lib_out.detach().permute(0, 2, 3, 1) - ref_y).abs().max())
    gl = g.permute(0, 3, 1, 2)

    def lib_fwd():
        with torch.no_grad():
            return f.local_response_norm(xl, *LRN_PARAMS)

    def lib_bwd():
        return torch.autograd.grad(lib_out, xl, gl, retain_graph=True)

    elems = x.numel()
    calls = {
        "lrn_fwd": (lambda: lrn_mod.lrn(x, *LRN_PARAMS),
                    lambda: lrn_mod.lrn_reference(x, *LRN_PARAMS),
                    2 * 4 * elems, elems * (2 * n + 4), lib_fwd, err["fwd"]),
        "lrn_bwd": (lambda: lrn_mod.lrn_backward(x, g, *LRN_PARAMS),
                    lambda: lrn_mod.lrn_backward_reference(x, g,
                                                           *LRN_PARAMS),
                    3 * 4 * elems, elems * (3 * n + 9), lib_bwd, err["bwd"])}
    recs = {}
    shape_s = "%s N=%d C=%d" % (label, elems // shape[-1], shape[-1])
    for name, (kernel, plain, nbytes, flops, lib, e) in calls.items():
        bound_ms, bound_by = _bound(nbytes, flops)
        rec = {"shape": shape_s, "max_abs_err": e,
               "bitwise": equal[name[4:]],
               "ms": _cuda_ms(torch, kernel),
               "device_ms": _device_ms(torch, kernel, per_launch=True),
               "plain_ms": _cuda_ms(torch, plain, iters=5),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": _cuda_ms(torch, lib, iters=10)}
        _log("kernel %s [%s] max_err=%.3g bitwise=%s kernel_ms=%.4f "
             "device_ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
             "library_ms=%.4f (F.local_response_norm %s; its output within "
             "%.3g of the plain one)"
             % (name, shape_s, e, rec["bitwise"], rec["ms"],
                rec["device_ms"], rec["plain_ms"], bound_ms, bound_by,
                rec["library_ms"], "forward" if name == "lrn_fwd"
                else "autograd backward", lib_err))
        recs[name] = rec
    return recs


def lrn_phase(torch, lrn_mod, dev):
    """-> {kernel name: {"main": record, "realistic": [records]}}: the
    small cases untimed, then the main paths' shapes timed (AlexNet's
    first LRN is the main record)."""
    equal = 0
    for i, (shape, params) in enumerate(LRN_SMALL):
        x, g = _lrn_inputs(torch, dev, shape, 300 + i)
        equal += all(_lrn_check(torch, lrn_mod, x, g, params,
                                "%r %r" % (shape, params))[1].values())
    _log("kernel LRN: %d small cases (n 1-5, C 1-5000) within the limits, "
         "%d of them bitwise equal" % (len(LRN_SMALL), equal))
    cases = [_measure_lrn(torch, lrn_mod, dev, label, shape, seed=400 + i)
             for i, (label, shape) in enumerate(LRN_SHAPES)]
    return {name: {"main": cases[0][name],
                   "realistic": [c[name] for c in cases[1:]]}
            for name in cases[0]}

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


# -- phase 4: training, MNIST on the unit engine ------------------------------

#: the MNIST gate's settings (the JAX package's tests/test_samples_gates.py)
GATE_ERROR_PT = 1.48
GATE_LOADER = {"minibatch_size": 60, "n_train": None, "n_valid": None}
GATE_DECISION = {"max_epochs": 25, "fail_iterations": 12, "silent": True}
FIRST_EPOCH_WEIGHT_ATOL = 1e-4


def _mnist_workflow(precise, device="cuda", epochs=None):
    """The gate's workflow with ``root.common.engine.precise_gemm`` set
    to ``precise``, initialized on ``device`` (the card unless the CPU
    is asked for, whatever ``$VELES_BACKEND`` says)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import mnist
    prng.get().seed(42)
    decision = dict(GATE_DECISION)
    if epochs is not None:
        decision["max_epochs"] = epochs
    saved = root.common.engine.get("precise_gemm", 0)
    root.common.engine.precise_gemm = precise
    try:
        wf = mnist.create_workflow(
            loader=dict(GATE_LOADER, prng=RandomGenerator().seed(3)),
            decision=decision)
    finally:
        root.common.engine.precise_gemm = saved
    wf.initialize(device=Device(backend=device))
    if wf.fused_step._dev_.type != device:
        raise AssertionError("the workflow runs on %s, not %s"
                             % (wf.fused_step._dev_, device))
    if [f.precise_gemm for f in wf.forwards] != [precise] * 2:
        raise AssertionError("precise_gemm did not reach the layers")
    return wf


def _instrument(wf, counters):
    """Record each epoch's end time, first-epoch state and train losses,
    and the launches of each wrapper of ``counters`` ({name: wrapper
    with a ``launches`` count}) per minibatch class (wrappers on this
    workflow's units)."""
    from veles_tpu_torch.loader import TRAIN, VALID
    rec = {"epoch_end": [], "first_epoch": None,
           "steps": {TRAIN: 0, VALID: 0}, "train_loss": [[]],
           "launches": {name: {TRAIN: 0, VALID: 0} for name in counters}}
    step, decision = wf.fused_step, wf.decision
    step_run, epoch_end = step.run, decision._on_epoch_end

    def run():
        before = {name: fn.launches for name, fn in counters.items()}
        cls = step.minibatch_class
        step_run()
        rec["steps"][cls] += 1
        for name, fn in counters.items():
            rec["launches"][name][cls] += fn.launches - before[name]
        if cls == TRAIN:     # a device scalar: read at the end, no sync
            rec["train_loss"][-1].append(step.loss)

    def on_epoch_end():
        rec["epoch_end"].append(time.perf_counter())
        rec["train_loss"].append([])
        if rec["first_epoch"] is None:
            rec["first_epoch"] = {
                "n_err": list(decision.epoch_n_err),
                "weights": [{k: numpy.array(v)
                             for k, v in f.host_params.items()}
                            for f in wf.forwards]}
        epoch_end()

    step.run = run
    decision._on_epoch_end = on_epoch_end
    return rec


def _epoch_losses(rec):
    """Each epoch's train losses as floats."""
    return [[float(x) for x in epoch] for epoch in rec["train_loss"]
            if epoch]


def _first_epochs_agree(label, gpu, cpu, seconds):
    """n_err of each class within 1, weights within the stated
    tolerance; -> record."""
    n_err_diff = [abs(a - b) for a, b in zip(cpu["n_err"], gpu["n_err"])]
    w_diff = max(float(numpy.abs(c[k] - g[k]).max())
                 for c, g in zip(cpu["weights"], gpu["weights"]) for k in c)
    _log("train %s first epoch, card vs CPU: n_err card %s cpu %s, "
         "max|w_card - w_cpu| = %.3g (limit %g); CPU epoch %.3f s"
         % (label, gpu["n_err"], cpu["n_err"], w_diff,
            FIRST_EPOCH_WEIGHT_ATOL, seconds))
    if max(n_err_diff) > 1 or not w_diff <= FIRST_EPOCH_WEIGHT_ATOL:
        raise AssertionError("%s: first epoch on the card differs from "
                             "the CPU" % label)
    return {"label": label, "n_err_card": gpu["n_err"],
            "n_err_cpu": cpu["n_err"], "max_weight_diff": w_diff,
            "cpu_seconds": seconds}


def train_run(torch, gemm, card, precise):
    """The gate's training run on the card; -> record."""
    from veles_tpu_torch.loader import TRAIN, VALID
    t_init = time.perf_counter()
    wf = _mnist_workflow(precise)
    init_s = time.perf_counter() - t_init
    if wf.loader.provenance not in ("fixture", "real"):
        raise AssertionError("digits came from %r" % wf.loader.provenance)
    rec = _instrument(wf, {"k4": gemm.precise_matmul})
    gemm.precise_matmul.launches = 0
    gemm.precise_matmul.fold_launches = 0
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gemm.precise_matmul.launches
    folds = gemm.precise_matmul.fold_launches
    res = wf.gather_results()
    ends = [t0] + rec["epoch_end"]
    epoch_s = [b - a for a, b in zip(ends, ends[1:])]
    n_train = wf.loader.class_lengths[TRAIN]
    steps = rec["steps"]
    out = {"label": "precise_gemm=%d" % precise if precise else "plain",
           "precise_gemm": precise, "card": card, "init_s": init_s,
           "seconds": seconds, "epochs": len(epoch_s),
           "epoch_s": epoch_s, "epoch_s_median": statistics.median(epoch_s),
           "train_images_s": [n_train / t for t in epoch_s],
           "train_images_s_median": n_train / statistics.median(epoch_s),
           "best_validation_error_pt": res["best_validation_error_pt"],
           "best_epoch": res["best_epoch"],
           "train_steps": steps[TRAIN], "eval_steps": steps[VALID],
           "k4_launches": launches, "k4_fold_launches": folds,
           "k4_per_train_step":
               rec["launches"]["k4"][TRAIN] / max(steps[TRAIN], 1),
           "k4_per_eval_step":
               rec["launches"]["k4"][VALID] / max(steps[VALID], 1),
           "first_epoch": rec["first_epoch"]}
    _log("train %s: best validation error %.2f%% (epoch %d) in %d epochs, "
         "%.3f s; epoch wall s first %.4f median %.4f; train images/s "
         "median %.0f (first epoch %.0f); %d train + %d eval steps; K4 "
         "launches %d (%.2f per train step, %.2f per eval step), %d of "
         "them split K and folded; init %.3f s [%s]"
         % (out["label"], out["best_validation_error_pt"], out["best_epoch"],
            out["epochs"], seconds, epoch_s[0], out["epoch_s_median"],
            out["train_images_s_median"], out["train_images_s"][0],
            steps[TRAIN], steps[VALID], launches, out["k4_per_train_step"],
            out["k4_per_eval_step"], folds, init_s, card))
    _log("train %s: epoch wall s %s" % (
        out["label"], " ".join("%.4f" % t for t in epoch_s)))
    if not res["best_validation_error_pt"] <= GATE_ERROR_PT:
        raise AssertionError("%s: best validation error %.2f%% > %.2f%%"
                             % (out["label"],
                                res["best_validation_error_pt"],
                                GATE_ERROR_PT))
    if precise and (out["k4_per_train_step"] != 5 or
                    out["k4_per_eval_step"] != 2):
        raise AssertionError("%s: K4 launches per train / eval step %r / "
                             "%r, want 5 / 2" % (
                                 out["label"], out["k4_per_train_step"],
                                 out["k4_per_eval_step"]))
    # the first layer's forward (M = 60, K = 784) is the one call of a
    # step that splits
    if precise and folds != steps[TRAIN] + steps[VALID]:
        raise AssertionError("%s: %d K4 calls split K over %d steps, want "
                             "one a step" % (out["label"], folds,
                                             steps[TRAIN] + steps[VALID]))
    if not precise and launches:
        raise AssertionError("the plain-matmul run launched K4")
    return out


def first_epoch_on_the_cpu(card_run, gemm):
    """The ``precise_gemm`` run's first epoch, again by the port on the
    CPU from the same seeds: n_err within 1, weights within the stated
    tolerance."""
    wf = _mnist_workflow(card_run["precise_gemm"], device="cpu", epochs=1)
    rec = _instrument(wf, {"k4": gemm.precise_matmul})
    t0 = time.perf_counter()
    wf.run()
    return _first_epochs_agree(card_run["label"], card_run["first_epoch"],
                               rec["first_epoch"], time.perf_counter() - t0)


# -- phase 4b: training, the attention unit (slice 3) -------------------------

#: the needle task at the unit's measured width (bench.py:543): T 2048,
#: d_model 512, 8 heads, 4 classes
ATTN_T, ATTN_D, ATTN_HEADS, ATTN_CLASSES = 2048, 512, 8, 4
ATTN_N, ATTN_MINIBATCH, ATTN_EPOCHS = 480, 8, 5
#: sequences (and validation ones) of the first epoch held against the
#: CPU
ATTN_CPU_N, ATTN_CPU_VALID = 24, 8
#: (label, causal, window) of the full-width runs
ATTN_CONFIGS = (("attention", False, None),
                ("attention causal window=512", True, 512))
#: both layers' solver (tests/test_attention_unit.py:146-149)
ATTN_GD = {"learning_rate": 0.01, "gradient_moment": 0.9}
#: the JAX test's own run and gate (tests/test_attention_unit.py:113-160)
SMALL_ATTN = dict(n=600, t=8, d=8, heads=2, minibatch=50, epochs=25)
SMALL_ATTN_GATE_PT = 40.0


def needle_loader(n, t, d, classes, n_valid=None):
    """The needle task of the JAX package's tests/test_attention_unit.py
    as a port FullBatchLoader: n sequences of [T, D] uniform noise in
    [-0.2, 0.2], one marked position per sequence (feature 0 = 2.0) whose
    payload feature 1 + label is 2.0 too; the first ``n_valid`` (default
    n / 4) validate, the rest train."""
    n_valid = n // 4 if n_valid is None else n_valid
    from veles_tpu_torch.loader.base import TEST, TRAIN, VALID
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader

    class NeedleLoader(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.RandomState(3)
            x = rng.uniform(-0.2, 0.2, (n, t, d)).astype(numpy.float32)
            labels = rng.randint(0, classes, n)
            pos = rng.randint(0, t, n)
            rows = numpy.arange(n)
            x[rows, pos, 0] = 2.0                 # the marker
            x[rows, pos, 1 + labels] = 2.0        # the payload class
            self.original_data.mem = x
            self.original_labels = list(labels.astype(numpy.int32))
            self.class_lengths[TEST] = 0
            self.class_lengths[VALID] = n_valid
            self.class_lengths[TRAIN] = n - n_valid

    return NeedleLoader


def attention_workflow(n, t, d, heads, causal=False, window=None,
                       minibatch=ATTN_MINIBATCH, epochs=ATTN_EPOCHS,
                       device="cuda", use_pallas=None, n_valid=None):
    """``StandardWorkflow([multihead_attention, softmax])`` on the needle
    task, weights from seed 42, initialized on ``device`` (the card
    unless the CPU is asked for)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    prng.get().seed(42)
    fwd = {"heads": heads, "causal": causal}
    if window is not None:
        fwd["window"] = window
    if use_pallas is not None:
        fwd["use_pallas"] = use_pallas
    wf = StandardWorkflow(
        None, name="attention",
        loader_factory=needle_loader(n, t, d, ATTN_CLASSES, n_valid),
        loader={"minibatch_size": minibatch,
                "prng": RandomGenerator().seed(5)},
        layers=[{"type": "multihead_attention", "->": fwd,
                 "<-": dict(ATTN_GD)},
                {"type": "softmax",
                 "->": {"output_sample_shape": ATTN_CLASSES},
                 "<-": dict(ATTN_GD)}],
        loss_function="softmax",
        decision={"max_epochs": epochs, "silent": True}, fused=True)
    wf.initialize(device=Device(backend=device))
    unit = wf.forwards[0]
    if wf.fused_step._dev_.type != device or \
            unit.device.BACKEND != device:
        raise AssertionError("the workflow runs on %s, not %s"
                             % (wf.fused_step._dev_, device))
    return wf


def _flash_counters(fa):
    return {"K7": fa.flash_attention_fwd, "K8": fa.flash_attention_dq,
            "K9": fa.flash_attention_dkv}


def attention_run(torch, fa, card, label, causal, window):
    """One full-width run on the card; -> record (with its first
    epoch's state, for the CPU comparison)."""
    from veles_tpu_torch.loader import TRAIN, VALID
    t_init = time.perf_counter()
    wf = attention_workflow(ATTN_N, ATTN_T, ATTN_D, ATTN_HEADS, causal,
                            window)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    if not wf.forwards[0]._resolved_use_pallas():
        raise AssertionError("%s: AUTO did not pick the kernels on the "
                             "card" % label)
    counters = _flash_counters(fa)
    rec = _instrument(wf, counters)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    res = wf.gather_results()
    ends = [t0] + rec["epoch_end"]
    epoch_s = [b - a for a, b in zip(ends, ends[1:])]
    n_train = wf.loader.class_lengths[TRAIN]
    steps = rec["steps"]
    per = {name: (rec["launches"][name][TRAIN] / max(steps[TRAIN], 1),
                  rec["launches"][name][VALID] / max(steps[VALID], 1))
           for name in counters}
    losses = _epoch_losses(rec)
    mean_loss = [statistics.fmean(e) for e in losses]
    median_s = statistics.median(epoch_s)
    out = {"label": label, "causal": causal, "window": window, "card": card,
           "init_s": init_s, "seconds": seconds, "epochs": len(epoch_s),
           "epoch_s": epoch_s, "epoch_s_median": median_s,
           "train_seq_s_median": n_train / median_s,
           "train_tokens_s_median": n_train * ATTN_T / median_s,
           "train_steps": steps[TRAIN], "eval_steps": steps[VALID],
           "launches": launches, "launches_per_train_eval_step": per,
           "mean_train_loss": mean_loss,
           "best_validation_error_pt": res["best_validation_error_pt"],
           "first_epoch": rec["first_epoch"]}
    _log("train %s: T=%d d_model=%d heads=%d, %d train + %d valid "
         "sequences, minibatch %d; %d epochs in %.3f s; epoch wall s %s; "
         "median %.4f s = %.1f train sequences/s = %.0f train tokens/s; "
         "mean train loss by epoch %s; best validation error %.2f%%; "
         "launches %s (per train / eval step %s); init %.3f s [%s]"
         % (label, ATTN_T, ATTN_D, ATTN_HEADS, n_train,
            wf.loader.class_lengths[VALID], ATTN_MINIBATCH, len(epoch_s),
            seconds, " ".join("%.4f" % x for x in epoch_s), median_s,
            out["train_seq_s_median"], out["train_tokens_s_median"],
            " ".join("%.5f" % x for x in mean_loss),
            out["best_validation_error_pt"], launches, per, init_s, card))
    if any(not math.isfinite(x) for e in losses for x in e):
        raise AssertionError("%s: a train loss is not finite" % label)
    if not mean_loss[-1] < mean_loss[0]:
        raise AssertionError("%s: the last epoch's mean train loss %g is "
                             "not below the first's %g"
                             % (label, mean_loss[-1], mean_loss[0]))
    if per != {"K7": (1, 1), "K8": (1, 0), "K9": (1, 0)}:
        raise AssertionError("%s: launches per train / eval step %r, want "
                             "K7 1/1, K8 and K9 1/0" % (label, per))
    return out


def attention_first_epoch_vs_cpu(fa, label, causal, window):
    """The first epoch at full width on ``ATTN_CPU_N`` sequences, on the
    card and by the port on the CPU (``use_pallas=True``: the plain
    versions through the same autograd Function)."""
    first = {}
    for device in ("cuda", "cpu"):
        wf = attention_workflow(ATTN_CPU_N, ATTN_T, ATTN_D, ATTN_HEADS,
                                causal, window, epochs=1, device=device,
                                use_pallas=True, n_valid=ATTN_CPU_VALID)
        rec = _instrument(wf, _flash_counters(fa))
        t0 = time.perf_counter()
        wf.run()
        first[device] = (rec["first_epoch"], time.perf_counter() - t0)
    return _first_epochs_agree(label + " (%d sequences)" % ATTN_CPU_N,
                               first["cuda"][0], first["cpu"][0],
                               first["cpu"][1])


def attention_small_run(torch, fa, card):
    """The JAX test's own settings on the card: best validation error
    under its gate; T=8 is below one kernel tile."""
    cfg = SMALL_ATTN
    wf = attention_workflow(cfg["n"], cfg["t"], cfg["d"], cfg["heads"],
                            minibatch=cfg["minibatch"],
                            epochs=cfg["epochs"])
    counters = _flash_counters(fa)
    before = {name: fn.launches for name, fn in counters.items()}
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches - before[name]
                for name, fn in counters.items()}
    res = wf.gather_results()
    out = {"label": "attention T=8 (the JAX test's run)", "card": card,
           "seconds": seconds, "launches": launches,
           "best_validation_error_pt": res["best_validation_error_pt"],
           "best_epoch": res["best_epoch"]}
    _log("train %s: best validation error %.2f%% (epoch %d; gate < %.0f%%,"
         " chance 75%%) in %.3f s; launches %s [%s]"
         % (out["label"], out["best_validation_error_pt"],
            out["best_epoch"], SMALL_ATTN_GATE_PT, seconds, launches, card))
    if not res["best_validation_error_pt"] < SMALL_ATTN_GATE_PT:
        raise AssertionError("the small attention run missed its gate")
    if min(launches.values()) <= 0:
        raise AssertionError("the small attention run skipped a kernel")
    return out


def trace_attention(torch, card, label, causal, window):
    """One full-width epoch of the ``ATTN_CONFIGS`` entry under
    ``torch.profiler``."""
    return _traced(torch, "train " + label, card, lambda: _epoch(
        attention_workflow(ATTN_N, ATTN_T, ATTN_D, ATTN_HEADS, causal,
                           window, epochs=1)))


def trace_train(torch, card, precise):
    """One epoch of the gate's workflow under ``torch.profiler``: the
    share of the epoch's wall time the card is busy."""
    label = "train precise_gemm=%d" % precise if precise else "train plain"
    return _traced(torch, label, card,
                   lambda: _epoch(_mnist_workflow(precise, epochs=1)))


# -- phase 4c: AlexNet at full width (slice 4) --------------------------------

#: the AlexNet sample as published (227x227x3, conv 96/256/384/384/256, fc
#: 4096/4096, softmax 1000, minibatch 128) on its own synthetic loader
#: defaults (2048 train + 256 valid images, 1.42 GB resident)
ALEX_EPOCHS = 3
#: the card-vs-CPU hold: the first train steps at minibatch 128 on a cut
#: dataset (256 train + 128 valid images; widths untouched)
ALEX_HOLD_STEPS = 2
ALEX_HOLD_LOADER = {"n_train": 256, "n_valid": 128}
#: card vs CPU (and port vs JAX in the tests): each train step's loss
#: within this relative tolerance, each parameter tensor within this
#: fraction of its largest magnitude
STEP_LOSS_RTOL = 1e-4
STEP_WEIGHT_RTOL = 1e-4
#: (label, use_pallas) of the full-width runs: unset (K5/K6 on the card)
#: and the band form
ALEX_CONFIGS = (("alexnet", None), ("alexnet band LRN", False))


def _with_lrn_form(layers, use_pallas):
    """``layers`` with ``use_pallas`` set on every LRN layer (None:
    unchanged)."""
    if use_pallas is None:
        return [dict(layer) for layer in layers]
    return [dict(layer, **{"->": dict(layer["->"], use_pallas=use_pallas)})
            if layer["type"] == "norm" else dict(layer) for layer in layers]


def _on(wf, device):
    """Refuse a workflow that does not run where it was asked to."""
    if wf.fused_step._dev_.type != device:
        raise AssertionError("the workflow runs on %s, not %s"
                             % (wf.fused_step._dev_, device))
    return wf


def alexnet_workflow(device="cuda", use_pallas=None, epochs=ALEX_EPOCHS,
                     **loader):
    """The AlexNet sample through ``create_workflow``, weights from seed
    42, loader seed 7, initialized on ``device`` (the card unless the CPU
    is asked for); ``loader`` overrides the sample's loader config."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import alexnet
    prng.get().seed(42)
    wf = alexnet.create_workflow(
        loader=dict(loader, prng=RandomGenerator().seed(7)),
        layers=_with_lrn_form(root.alexnet.layers, use_pallas),
        decision={"max_epochs": epochs, "silent": True})
    wf.initialize(device=Device(backend=device))
    return _on(wf, device)


def train_steps(wf, n):
    """Run the first ``n`` train minibatches of ``wf`` by hand (the
    loader's validation minibatches are served and skipped); -> their
    losses.  The weights stay in the fused step (``sync_weights``)."""
    from veles_tpu_torch.loader import TRAIN
    losses = []
    for _ in range(n):
        while True:
            wf.loader.run()
            if wf.loader.minibatch_class == TRAIN:
                break
        wf.fused_step.run()
        losses.append(float(wf.fused_step.loss))
    wf.fused_step.sync_weights()
    return losses


def steps_agree(label, losses, weights, want_losses, want_weights):
    """Losses within ``STEP_LOSS_RTOL``, each parameter tensor within
    ``STEP_WEIGHT_RTOL`` of its largest magnitude; -> (max loss rel
    diff, max weight rel diff)."""
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        want_losses))
    w_diff = max(float(numpy.abs(w[k] - ref[k]).max()) /
                 float(numpy.abs(ref[k]).max())
                 for w, ref in zip(weights, want_weights) for k in ref)
    if len(losses) != len(want_losses) or \
            not loss_diff <= STEP_LOSS_RTOL or \
            not w_diff <= STEP_WEIGHT_RTOL:
        raise AssertionError("%s: losses %r against %r (rel %g, limit %g),"
                             " weights rel %g (limit %g)"
                             % (label, losses, want_losses, loss_diff,
                                STEP_LOSS_RTOL, w_diff, STEP_WEIGHT_RTOL))
    return loss_diff, w_diff


def host_weights(wf):
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def _lrn_counters(lrn_mod):
    return {"K5": lrn_mod.lrn, "K6": lrn_mod.lrn_backward}


def _train_record(torch, wf, counters, label, card, t_init, n_seq_label):
    """Run ``wf`` with its kernels' counts reset; -> record of epoch
    times, train samples/s (median epoch, the first apart), losses,
    launches (total and per train / eval step) and the best error."""
    from veles_tpu_torch.loader import TRAIN, VALID
    rec = _instrument(wf, counters)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    ends = [t0] + rec["epoch_end"]
    epoch_s = [b - a for a, b in zip(ends, ends[1:])]
    steps = rec["steps"]
    n_train = wf.loader.class_lengths[TRAIN]
    median_s = statistics.median(epoch_s[1:] or epoch_s)
    losses = _epoch_losses(rec)
    per = {name: (rec["launches"][name][TRAIN] / max(steps[TRAIN], 1),
                  rec["launches"][name][VALID] / max(steps[VALID], 1))
           for name in counters}
    res = wf.gather_results()
    out = {"label": label, "card": card, "init_s": t_init,
           "seconds": seconds, "epochs": len(epoch_s), "epoch_s": epoch_s,
           "epoch_s_median_after_first": median_s,
           "train_samples_s_median": n_train / median_s,
           "train_steps": steps[TRAIN], "eval_steps": steps[VALID],
           "launches": launches, "launches_per_train_eval_step": per,
           "mean_train_loss": [statistics.fmean(e) for e in losses],
           "best_validation_error_pt": res["best_validation_error_pt"],
           "best_epoch": res["best_epoch"]}
    _log("train %s: %d train + %d valid %s, minibatch %d; %d epochs in "
         "%.3f s; epoch wall s %s; median after the first %.4f s = %.1f "
         "train %s/s; mean train loss by epoch %s; best validation error "
         "%.2f%% (epoch %d); launches %s (per train / eval step %s); init "
         "%.3f s [%s]"
         % (label, n_train, wf.loader.class_lengths[VALID], n_seq_label,
            wf.loader.max_minibatch_size, len(epoch_s), seconds,
            " ".join("%.4f" % x for x in epoch_s), median_s,
            out["train_samples_s_median"], n_seq_label,
            " ".join("%.5f" % x for x in out["mean_train_loss"]),
            out["best_validation_error_pt"], out["best_epoch"], launches,
            per, t_init, card))
    if any(not math.isfinite(x) for e in losses for x in e):
        raise AssertionError("%s: a train loss is not finite" % label)
    return out


def alexnet_run(torch, lrn_mod, card, label, use_pallas):
    """AlexNet at full width on the card for ``ALEX_EPOCHS``; -> record.
    Unset ``use_pallas`` must launch K5 twice a step (train and eval) and
    K6 twice a train step; the band form launches neither."""
    t0 = time.perf_counter()
    wf = alexnet_workflow(use_pallas=use_pallas)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    norms = [f for f in wf.forwards if f.MAPPING == "norm"]
    if [f._resolved_use_pallas() for f in norms] != \
            [use_pallas is None] * 2:
        raise AssertionError("%s: the LRN layers took the wrong form"
                             % label)
    out = _train_record(torch, wf, _lrn_counters(lrn_mod), label, card,
                        init_s, "images")
    want = {"K5": (2, 2), "K6": (2, 0)} if use_pallas is None else \
        {"K5": (0, 0), "K6": (0, 0)}
    if out["launches_per_train_eval_step"] != want:
        raise AssertionError("%s: launches per train / eval step %r, want "
                             "%r" % (label,
                                     out["launches_per_train_eval_step"],
                                     want))
    return out


def alexnet_hold(torch, lrn_mod):
    """The first ``ALEX_HOLD_STEPS`` train steps at full width, minibatch
    128, on the card (K5/K6) and by the port on the CPU (the same
    Function, on its plain versions): losses and weights within the
    stated tolerances, and each dropout layer's last mask drawn on the
    card equal, bit for bit, to the one drawn on the CPU."""
    runs = {}
    for device in ("cuda", "cpu"):
        wf = alexnet_workflow(device, use_pallas=True, epochs=1,
                              **ALEX_HOLD_LOADER)
        t0 = time.perf_counter()
        losses = train_steps(wf, ALEX_HOLD_STEPS)
        runs[device] = (wf, losses, time.perf_counter() - t0)
    (card_wf, card_losses, _), (cpu_wf, cpu_losses, cpu_s) = \
        runs["cuda"], runs["cpu"]
    loss_diff, w_diff = steps_agree(
        "alexnet first steps, card vs CPU", card_losses, host_weights(
            card_wf), cpu_losses, host_weights(cpu_wf))
    masks = 0
    for f_card, f_cpu in zip(card_wf.forwards, cpu_wf.forwards):
        if not f_card.stochastic:
            continue
        if f_card.last_key != f_cpu.last_key or f_card.last_key is None:
            raise AssertionError("dropout keys differ: %r, %r"
                                 % (f_card.last_key, f_cpu.last_key))
        shape = tuple(f_card.output.shape)
        on_card = f_card.mask(f_card.last_key, shape, "cuda").cpu()
        if not torch.equal(on_card, f_cpu.mask(f_cpu.last_key, shape,
                                               "cpu")):
            raise AssertionError("a dropout mask on the card differs from "
                                 "the CPU's")
        masks += 1
    if masks != 2:
        raise AssertionError("AlexNet has %d dropout layers, want 2" % masks)
    out = {"steps": ALEX_HOLD_STEPS, "losses_card": card_losses,
           "losses_cpu": cpu_losses, "max_loss_rel_diff": loss_diff,
           "max_weight_rel_diff": w_diff, "dropout_masks_equal": masks,
           "cpu_seconds": cpu_s}
    _log("train alexnet first %d steps, card vs CPU (minibatch 128): losses"
         " card %s cpu %s (max rel diff %.3g, limit %g); max|w_card - "
         "w_cpu| / max|w_cpu| = %.3g (limit %g); %d dropout masks equal; "
         "CPU steps %.3f s"
         % (ALEX_HOLD_STEPS, card_losses, cpu_losses, loss_diff,
            STEP_LOSS_RTOL, w_diff, STEP_WEIGHT_RTOL, masks, cpu_s))
    return out


# -- phase 4d: the LRN convnet on synthetic CIFAR (slice 4) -------------------

#: conv 32 5x5 pad 2 → LRN n 5 → max 3x3/2 → conv 32 5x5 pad 2 → LRN →
#: max 3x3/2 → fc 64 strict RELU → dropout 0.5 → softmax 10; lr 0.02,
#: momentum 0.9 (the JAX package's tests/test_conv_stack.py convnet
#: solver)
LRN_NET_GD = {"learning_rate": 0.02, "gradient_moment": 0.9}
LRN_NET_LAYERS = (
    {"type": "conv_str", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                "padding": 2}, "<-": LRN_NET_GD},
    {"type": "norm", "->": {"n": 5}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_str", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                "padding": 2}, "<-": LRN_NET_GD},
    {"type": "norm", "->": {"n": 5}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "all2all_str", "->": {"output_sample_shape": 64},
     "<-": LRN_NET_GD},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": LRN_NET_GD})
#: the CIFAR loader's synthetic defaults (5000 train + 1000 valid)
LRN_NET_LOADER = {"minibatch_size": 100, "normalization_type": "range_linear"}
LRN_NET_EPOCHS = 5
LRN_NET_GATE_PT = 25.0


def lrn_net_workflow(device="cuda", use_pallas=None, epochs=LRN_NET_EPOCHS,
                     **loader):
    """The LRN convnet through the CIFAR sample's ``create_workflow``,
    weights from seed 42, loader seed 7, on ``device`` (the card unless
    the CPU is asked for)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import cifar
    prng.get().seed(42)
    wf = cifar.create_workflow(
        loader=dict(LRN_NET_LOADER, prng=RandomGenerator().seed(7),
                    **loader),
        layers=_with_lrn_form(LRN_NET_LAYERS, use_pallas),
        decision={"max_epochs": epochs, "silent": True})
    wf.initialize(device=Device(backend=device))
    return _on(wf, device)


def lrn_net_run(torch, lrn_mod, card):
    """The LRN convnet on the card: best validation error under its gate,
    K5/K6 launched on every step."""
    t0 = time.perf_counter()
    wf = lrn_net_workflow()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if wf.loader.provenance != "synthetic":
        raise AssertionError("CIFAR came from %r" % wf.loader.provenance)
    out = _train_record(torch, wf, _lrn_counters(lrn_mod), "LRN convnet",
                        card, init_s, "images")
    if not out["best_validation_error_pt"] < LRN_NET_GATE_PT:
        raise AssertionError("the LRN convnet missed its gate: %.2f%% >= "
                             "%.0f%%" % (out["best_validation_error_pt"],
                                         LRN_NET_GATE_PT))
    if out["launches_per_train_eval_step"] != {"K5": (2, 2),
                                               "K6": (2, 0)}:
        raise AssertionError("the LRN convnet's launches per train / eval "
                             "step: %r" % out["launches_per_train_eval_step"])
    return out


def trace_alexnet(torch, card, label, use_pallas):
    """One AlexNet epoch under ``torch.profiler`` with each LRN form (the
    card's busy time of the two compares the forms inside a real step),
    with the top kernels and every device copy named."""
    return _traced(torch, "train " + label, card, lambda: _epoch(
        alexnet_workflow(use_pallas=use_pallas, epochs=1)), top=25)

# -- phase 5: where the time goes ---------------------------------------------

def trace_run(torch, card, label, kv_dtype, weight_dtype):
    """The same burst once more under ``torch.profiler``, through the
    scheduler directly (HTTP adds no device work): device busy time and
    the kernels that take it.  Runs after every untraced measurement,
    because the tracer slows every later launch of the process."""
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel

    def burst():
        model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype,
                                    weight_dtype=weight_dtype)
        sched = DecodeScheduler(model, name="trace-" + label,
                                kv_dtype=kv_dtype, **README_SERVER)

        def run():
            futures = [sched.submit(p, NEW_TOKENS) for p in _prompts()]
            for f in futures:
                f.result(900)
        return run, sched.close
    return _traced(torch, label, card, burst)


def serving_summary(run, trace):
    """Phase 3's tok/s and decode step p50 of a serving configuration
    beside its burst traced in phase 5: launches and device-to-device
    copies (the int8 KV append's cost)."""
    run["traced_launches"] = trace["device_launches"]
    run["traced_dtod_copies"] = sum(
        c["count"] for c in trace["copies"] if "dtod" in c["kernel"].lower())
    _log("serving %s: %.1f tok/s, decode step p50 %s ms; its traced burst "
         "%d launches, %d device-to-device copies [%s]"
         % (run["label"], run["tok_s"], run["step_ms_p50"],
            run["traced_launches"], run["traced_dtod_copies"], run["card"]))


def device_rows(events):
    """(device us, count, name) of the rows of ``key_averages()`` that
    ran on the card (kernels, copies, sets), longest first.  A host op
    row (``aten::mm``, an autograd Function) also carries, as its self
    device time, the time of the kernels it launched: counting both
    would count each kernel twice."""
    import torch
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and
                   e.self_device_time_total > 0), reverse=True)


#: tries of a traced run before a trace with no device time fails it.  The
#: tracer has kept no device record of a run that launched work (an
#: AlexNet epoch's trace, whose same epoch other runs traced in full); a
#: run that launches nothing on the card fails every try.
TRACE_TRIES = 3


class TraceLost(AssertionError):
    """A traced run whose trace holds no device time."""


def _epoch(wf):
    """(run, close) of one epoch of the workflow ``wf``, for ``_traced``."""
    return wf.run, lambda: None


def _traced(torch, label, card, make, top=5):
    """``_trace_record`` of a run under ``torch.profiler``: ``make()`` ->
    (run, close) builds a fresh run for each try; a try whose trace holds
    no device time is taken again, up to ``TRACE_TRIES``.  The record
    says how many tries it took."""
    from torch.profiler import ProfilerActivity, profile
    for tries in range(1, TRACE_TRIES + 1):
        run, close = make()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            close()
        try:
            rec = _trace_record(prof, label, card, seconds, top)
        except TraceLost as e:
            if tries == TRACE_TRIES:
                raise
            _log("%s; try %d of %d, tracing a fresh run"
                 % (e, tries, TRACE_TRIES))
            continue
        rec["tries"] = tries
        return rec


#: device rows that move data between layouts or buffers: copies, and
#: cuDNN's own NHWC <-> NCHW transforms around a convolution
COPY_MARKS = ("copy", "tonchw", "tonhwc", "transpose")


def _trace_record(prof, label, card, seconds, top=5):
    """Busy share, the ``top`` kernels by device time, the device copies
    and layout transforms (``COPY_MARKS``), and the int64 elementwise
    kernels (dropout's threefry draws and index arithmetic) of a traced
    run."""
    by_kernel = device_rows(prof.key_averages())
    busy_ms = sum(t for t, _, _ in by_kernel) / 1e3
    if busy_ms <= 0:
        raise TraceLost("%s: the traced run ran nothing on the card "
                        "(%.3f s traced, %d host events)"
                        % (label, seconds, len(prof.events())))
    rec = {"label": label, "card": card, "traced_seconds": seconds,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / 1e3 / seconds,
           "device_launches": sum(c for _, c, _ in by_kernel),
           "top": [{"kernel": k[:120], "ms": t / 1e3, "count": c}
                   for t, c, k in by_kernel[:top]],
           "copies": [{"kernel": k[:120], "ms": t / 1e3, "count": c}
                      for t, c, k in by_kernel
                      if any(m in k.lower() for m in COPY_MARKS)],
           "int64_elementwise_ms": sum(
               t for t, _, k in by_kernel
               if "elementwise" in k and "<long" in k) / 1e3,
           "int64_elementwise_launches": sum(
               c for _, c, k in by_kernel
               if "elementwise" in k and "<long" in k)}
    # K4's and K3's products (every instantiation) and their split-K folds
    for kid, name in (("k4", "precise"), ("k3", "quantized")):
        for part, kernel in (("", "_matmul_kernel"),
                             ("_fold", "_fold_kernel")):
            rows = [(t, c) for t, c, k in by_kernel if name + kernel in k]
            rec[kid + part + "_ms"] = sum(t for t, _ in rows) / 1e3
            rec[kid + part + "_launches"] = sum(c for _, c in rows)
        if rec[kid + "_launches"]:
            _log("trace %s: %s %.3f ms over %d products, fold %.3f ms over "
                 "%d [%s]" % (label, kid.upper(), rec[kid + "_ms"],
                              rec[kid + "_launches"], rec[kid + "_fold_ms"],
                              rec[kid + "_fold_launches"], card))
    # K1's and K2's (f32 and int8 pools, every instantiation) and the
    # merge of their split calls
    for kid, kernel in (("k1", "paged_decode_kernel<float"),
                        ("k2", "paged_decode_kernel<signed char"),
                        ("paged_merge", "paged_merge_kernel")):
        rows = [(t, c) for t, c, k in by_kernel if kernel in k]
        rec[kid + "_ms"] = sum(t for t, _ in rows) / 1e3
        rec[kid + "_launches"] = sum(c for _, c in rows)
    if rec["k1_launches"] or rec["k2_launches"]:
        _log("trace %s: K1 %.3f ms over %d launches, K2 %.3f ms over %d, "
             "merge %.3f ms over %d [%s]"
             % (label, rec["k1_ms"], rec["k1_launches"], rec["k2_ms"],
                rec["k2_launches"], rec["paged_merge_ms"],
                rec["paged_merge_launches"], card))
    # the LRN pair's (every instantiation)
    for kid, kernel in (("k5", "lrn_fwd_kernel"), ("k6", "lrn_bwd_kernel")):
        rows = [(t, c) for t, c, k in by_kernel if kernel in k]
        rec[kid + "_ms"] = sum(t for t, _ in rows) / 1e3
        rec[kid + "_launches"] = sum(c for _, c in rows)
    if rec["k5_launches"] or rec["k6_launches"]:
        _log("trace %s: K5 %.3f ms over %d launches, K6 %.3f ms over %d "
             "[%s]" % (label, rec["k5_ms"], rec["k5_launches"],
                       rec["k6_ms"], rec["k6_launches"], card))
    width = 40 if top <= 5 else 70
    _log("trace %s: %.3f s traced, device busy %.3f ms (%.1f%%) over %d "
         "launches; int64 elementwise %.3f ms x%d; top: %s; copies and "
         "layout transforms: %s [%s]"
         % (label, seconds, busy_ms, 100 * rec["device_busy_share"],
            rec["device_launches"], rec["int64_elementwise_ms"],
            rec["int64_elementwise_launches"],
            "; ".join("%s %.3f ms x%d" % (e["kernel"][:width], e["ms"],
                                          e["count"]) for e in rec["top"]),
            "; ".join("%s %.3f ms x%d" % (e["kernel"][:width], e["ms"],
                                          e["count"])
                      for e in rec["copies"]) or "none", card))
    return rec


#: name in the kernels line: (id in PERF.md's table, source, TPU kernel)
KERNEL_META = {
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
    "precise_matmul_l1": (
        "K4", "csrc/precise_matmul.cu",
        "veles_tpu/znicz/gemm.py:126 (_matmul_impl kernel, level 1)"),
    "precise_matmul_l2": (
        "K4", "csrc/precise_matmul.cu",
        "veles_tpu/znicz/gemm.py:126 (_matmul_impl kernel, level 2)"),
    "lrn_fwd": (
        "K5", "csrc/lrn.cu",
        "veles_tpu/znicz/lrn.py:143 (pallas_lrn kernel)"),
    "lrn_bwd": (
        "K6", "csrc/lrn.cu",
        "veles_tpu/znicz/lrn.py:164 (_pallas_lrn_bwd kernel)"),
    "flash_attention_fwd": (
        "K7", "csrc/flash_attention.cu",
        "veles_tpu/znicz/flash_attention.py:141 (_fwd_kernel)"),
    "flash_attention_dq": (
        "K8", "csrc/flash_attention.cu",
        "veles_tpu/znicz/flash_attention.py:265 (_dq_kernel)"),
    "flash_attention_dkv": (
        "K9", "csrc/flash_attention.cu",
        "veles_tpu/znicz/flash_attention.py:307 (_dkv_kernel)"),
}


def serving_launches(runs):
    """Each slice-1 kernel's launches over the serving runs."""
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
    if by_label["f32"]["launches"]["quantized_matmul"]:
        raise AssertionError("the f32 model launched the quantized GEMM")
    return launches


#: (name prefix, keys): what a kernel's entry in the kernels line carries
#: beside the keys every entry has
LINE_KEYS = (
    ("paged_attention", ("device_ms", "split", "library_ms")),
    ("precise_matmul", ("device_ms", "split", "cuda_core_bound_ms")),
    ("quantized_matmul", ("device_ms", "split", "cuda_core_bound_ms",
                          "tile_m")),
    ("flash_attention", ("device_ms", "d_tile", "tf32x3_bound_ms",
                         "cuda_core_bound_ms")),
    ("lrn", ("device_ms", "bitwise")))


def kernels_line(kernels, k4, launches):
    """The ``kernels`` JSON line: every kernel of ``KERNEL_META``, as
    measured in phase 2, with its launches on its main path.  K4's
    level 0 is no main path's (``precise_gemm=0`` means plain
    matmuls): its numbers ride inside the level-1 entry."""
    main = {name: rec["main"] for name, rec in kernels.items()}
    realistic = {name: rec["realistic"] for name, rec in kernels.items()}
    for level in (1, 2):
        main["precise_matmul_l%d" % level] = k4[level]["main"][0]
        realistic["precise_matmul_l%d" % level] = \
            k4[level]["main"][1:] + k4[level]["realistic"]
    out = []
    for name, (kid, src, replaces) in KERNEL_META.items():
        if name not in main:
            raise AssertionError("kernel %s was not measured" % name)
        if launches.get(name, 0) <= 0:
            raise AssertionError("kernel %s never launched on its main "
                                 "path" % name)
        rec = main[name]
        want = next((keys for prefix, keys in LINE_KEYS
                     if name.startswith(prefix)), ())
        missing = set(want) - set(rec)
        if missing:
            raise AssertionError("kernel %s: its record lacks %s"
                                 % (name, ", ".join(sorted(missing))))
        entry = {"name": name, "id": kid, "route": "cuda",
                 "source": "veles_tpu_torch/" + src, "replaces": replaces,
                 "launches": launches[name],
                 "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                 "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                 "bound_by": rec["bound_by"],
                 "library_ms": rec["library_ms"], "shape": rec["shape"],
                 "realistic": realistic[name]}
        entry.update((key, rec[key]) for key in want)
        if name == "precise_matmul_l1":
            entry["level0"] = k4[0]
        out.append(entry)
    return {"kernels": out}


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
    from veles_tpu_torch.znicz import flash_attention as fa
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz import lrn as lrn_mod
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
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "phase_s": {}, "ptxas": {}}
    for name, (_, log) in sorted(built.items()):
        record["ptxas"][name] = ptxas_report(log)
        for fn, regs, stores, loads in record["ptxas"][name]:
            _log("  ptxas %s: %s: %d registers, %d + %d bytes spilled "
                 "(stores + loads)" % (name, fn, regs, stores, loads))
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        record["phase_s"][name] = now - clock[0]
        _log("phase %s: %.1f s" % (name, now - clock[0]))
        clock[0] = now

    kernels = kernel_phase(torch, pa, gemm, dev)
    k4, record["k4_compensation"] = k4_phase(torch, gemm, dev)
    record["k4"] = k4
    kernels.update(flash_phase(torch, fa, dev))
    kernels.update(lrn_phase(torch, lrn_mod, dev))
    phase_done("2 kernels")
    runs = [e2e_run(pa, gemm, card, label, kv, wd)
            for label, kv, wd in CONFIGS]
    launches = serving_launches(runs)
    record["e2e"] = runs
    phase_done("3 serving")
    train = [train_run(torch, gemm, card, precise) for precise in (0, 1, 2)]
    record["first_epoch_vs_cpu"] = first_epoch_on_the_cpu(train[1], gemm)
    for run in train:
        run.pop("first_epoch")
        if run["precise_gemm"]:
            launches["precise_matmul_l%d" % run["precise_gemm"]] = \
                run["k4_launches"]
    record["training"] = train
    phase_done("4 MNIST training")
    attention = [attention_run(torch, fa, card, *config)
                 for config in ATTN_CONFIGS]
    record["attention_first_epoch_vs_cpu"] = [
        attention_first_epoch_vs_cpu(fa, *config)
        for config in ATTN_CONFIGS]
    record["attention_small"] = attention_small_run(torch, fa, card)
    for run in attention:
        run.pop("first_epoch")
    for name, kid in (("flash_attention_fwd", "K7"),
                      ("flash_attention_dq", "K8"),
                      ("flash_attention_dkv", "K9")):
        launches[name] = sum(run["launches"][kid] for run in attention)
    record["attention"] = attention
    phase_done("4b attention training")
    alexnet = [alexnet_run(torch, lrn_mod, card, *config)
               for config in ALEX_CONFIGS]
    record["alexnet"] = alexnet
    record["alexnet_first_steps_vs_cpu"] = alexnet_hold(torch, lrn_mod)
    phase_done("4c AlexNet training")
    lrn_net = lrn_net_run(torch, lrn_mod, card)
    record["lrn_convnet"] = lrn_net
    for name, kid in (("lrn_fwd", "K5"), ("lrn_bwd", "K6")):
        launches[name] = alexnet[0]["launches"][kid] + \
            lrn_net["launches"][kid]
    phase_done("4d LRN convnet training")
    line = kernels_line(kernels, k4, launches)
    record["kernels"] = line["kernels"]
    record["traces"] = (
        [trace_run(torch, card, *config) for config in CONFIGS] +
        [trace_train(torch, card, precise) for precise in (0, 1)] +
        [trace_attention(torch, card, *config) for config in ATTN_CONFIGS] +
        [trace_alexnet(torch, card, *config) for config in ALEX_CONFIGS])
    for run, trace in zip(runs, record["traces"]):
        serving_summary(run, trace)
    phase_done("5 traces")
    record["seconds"] = time.perf_counter() - t_start
    _log("chip_smoke: every phase in %.1f s" % record["seconds"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    _log(json.dumps(line))
    _log(_card_line())
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
