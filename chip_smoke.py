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
   shapes, at level 1 also at STL-10's six (phase 4g's), and at 4096^3
   with CUDA events and with the profiler's device time, each call
   marked split or not (split-K launches the fold too), its bound 6MNK
   TF32 operations (3xTF32) beside the CUDA-core bound of 2MNK f32 FMAs;
   untimed, at the MNIST and STL-10 forward shapes (each splits) each
   level must equal the top-left corner of operands too large to split
   bit for bit.  Flash attention (K7 forward,
   K8 dq, K9 dk/dv) on ``randn * 0.5`` inputs, q/k/v as strided views of
   one packed projection: out and lse ``max|kernel - plain| <= 2e-5``,
   each gradient ``<= 5e-4 * max(1, max|plain|)``; at head dims 4, 8, 16,
   T = 7, 8, 256, windows 1-256 and at head dims 129, 192, 256, 320,
   512, 1024, T = 7, 256 and at the one-head unit's B=8, T=2048, H=1,
   D=512, no mask and causal (untimed), at the main path's shape (B=8,
   T=2048, H=8, D=64: no mask, causal, causal with window 512), at the
   JAX package's bench shapes (B=2, T=2048 causal; B=1, T=16384, window
   512), at head dims 128 and 256 (B=2, T=2048, causal) and at head dim
   512 (B=1, T=2048, H=2, causal: the wide path); each timed with CUDA
   events and the profiler's device time, with the instantiation
   (head-dim tile, or "wide") that ran; each kernel's bound is 3x its
   useful operations at the TF32 rate (3xTF32), beside the CUDA-core
   bound; ``library_ms`` is ``scaled_dot_product_attention`` pinned to
   its memory-efficient backend (3xTF32 ``mma.sync`` on f32 inputs) on
   the same f32 inputs, its forward on K7's row and its backward on
   K8's and K9's.  LRN (K5
   forward, K6 backward) on ``randn * 2`` inputs:
   ``max|kernel - plain| <= 1e-5 * max(1, max|plain|)``, at n 1-5 and C
   1-5000 with alpha 0.5 (untimed; how many of them are bitwise equal is
   printed), and timed at the main paths' LRN shapes with CUDA events
   and the profiler's device time: AlexNet's two at minibatch 128 (the
   first is the kernels line's record) and the LRN convnet's two at
   minibatch 100, each record saying whether kernel and plain version
   are bitwise equal; ``library_ms`` is ``F.local_response_norm`` on the
   NCHW view of the same input, its forward on K5's row and its autograd
   backward on K6's.  The int8-KV append (``csrc/kv_append.cu``, a hand
   kernel that is no TPU kernel) from a pool holding earlier content:
   every block but the trash block and every scale bitwise equal to
   the plain version's, at ``append_cases`` (the README prefill of a
   100-token prompt padded to 128 positions, H 4, hd 16, blocks of 16;
   a verify span [16, 5]; a 2048-position prefill at H 8, hd 128; the
   same prefill with values that grow the scale on every write), timed
   with CUDA events and the profiler's device time; its bound is
   the touched blocks read and written once plus the values and
   indices read once, over the HBM rate; no PyTorch call computes it
   (``library_ms`` null).
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
3b. End to end with the scheduler options (slice 12): the same model
   and server with ``prefix_caching=True, prefill_chunk_tokens=32,
   spec_depth=4`` (``OPTIONS_SERVER``), f32 and int8 KV.  Turn 1: 8
   concurrent requests sharing a 64-token system prefix, each with its
   own 8-24-token suffix; turn 2: each turn-1 prompt with its answer
   and 8 more tokens, resubmitted; 32 new tokens each.  f32: every
   answer equals ``generate_reference`` on the card; int8: the port on
   the CPU with the same options.  The same traffic then goes through
   the core scheduler (no options), held to the same oracles (int8: the
   CPU's core scheduler); f32 answers must equal the options run's.
   Printed: prefix hits, dedup blocks, chunks, drafted / accepted /
   rejected tokens and rollbacks, the launches of paged attention and
   the append, TTFT p50 of each turn, tok/s, and ``GET
   /api/flagship/kv``'s integrity list, which must be empty.
3c. The tiered KV cache, KV checkpoints and live session migration
   (slice 13), the README model in f32 (K1) and int8 KV (K2 and the
   append).  Tiers: ``InferenceServer`` with prefix caching, chunks of
   32, a pool of ``TIER_BLOCKS`` blocks and ``kvtier`` (a host tier of
   ``TIER_HOST_BLOCKS`` blocks' wire bytes over a disk tier in a
   temporary directory); turn 1 of phase 3b, 16 filler prompts that
   churn the pool, then turn 2, which readmits the conversations from
   host RAM and disk.  Every answer equals the cache-free oracle (f32)
   or the port on the CPU with the same options and tiers (int8); the
   KV dump's integrity list (the tiers' included) is empty; demotions
   to both tiers, promotions and disk readmits are all > 0.  Printed:
   TTFT p50 of both turns beside phase 3b's, the prompt tokens turn 2
   prefilled, the tier counters and bytes.  Checkpoint: the 8 turn-1
   requests through the README scheduler, ``checkpoint_kv`` with every
   one mid-generation, then ``restore_kv`` into a fresh scheduler on
   the card; each resumed sequence emits the uninterrupted run's
   tokens.  Printed: checkpoint bytes, save and restore seconds.
   Migration: two servers with ``enable_admin``; a burst of 8 on A is
   exported mid-generation (``POST /admin/sessions/export``), imported
   on B and released on A; every client is answered 307 at A and its
   follow-up with its ``session_id`` completes on B with the oracle's
   tokens (f32: the cache-free oracle; int8: the CPU); nothing answered
   twice or lost.  Printed: export and import ms a session and wire
   bytes a session.  Each path's kernels are counted from 0 just before
   it (the restore, the import) and must have launched.  Then phase
   2's long-context pool (4096 blocks of [16, 8, 128], 2 stages x K/V,
   1.07 GB of f32; int8 a quarter plus scales): ``save_state`` /
   ``load_state`` of the pools (bitwise, GB/s); one block's demote and
   readmit through the host and the disk tier, p50 of 63 blocks, step
   by step (bitwise; the card's wire bytes equal the CPU's on a small
   pool); a ``checkpoint_kv`` / ``restore_kv`` of 8 sessions of 2000
   tokens over that pool (each restored session emits the
   uninterrupted run's tokens).  Temporary directories are removed.
3d. The serving stack (slice 15, after phase 4, whose trained
   ``precise_gemm=1`` MNIST it serves): the flight recorder's timelines
   and cost, the classifier route, a fleet of two replicas on the card
   sharing a fresh build cache (``cache_dir=``), one SIGKILLed
   mid-burst (nothing fails; the build cache's counters of each
   replica's schedulers over ``GET /metrics`` before and after: the
   respawn builds nothing), and the step profiler.
3e. The autotuner and the build cache (slice 16, after 3d): the sites
   of ``TUNE_CASES`` (K4 at MNIST's 784->100 and at 4096^3, K1/K2 at
   the realistic batch in f32 and int8, K5 at AlexNet's LRN1, K7-K9 at
   B=8 T=2048 H=8 D=64, the prefill chunk on phase 3b's model and
   server) tuned into a fresh tuning directory, each site's candidates
   in one isolated subprocess under a hard cap, each gated against the
   kernel's plain version (or the oracle's tokens); printed: each
   site's default and winner times, speedup and gate.  Each tuned
   kernel plan is held against its plain version through the ordinary
   entry points.  Then a fresh process with both directories set
   resolves every tuned site ``"tuned"``, runs no ``nvcc`` (counted;
   the cache's misses and its listing unchanged), serves phase 3's f32
   burst with ``prefill_chunk_tokens="auto"`` (every token equal to
   the cache-free oracle) and trains two MNIST steps with the tuned K4
   split (weights within 1e-4 of the port's on the CPU).
3f. Exported packages (slice 19, after phase 4d, whose trained
   workflows it exports with ``veles_tpu_torch.export.export_model``;
   each package's forward chain is rebuilt from the port's units).
   (a) Phase 4's ``precise_gemm=1`` MNIST at fp32 and fp16, each served
   through ``InferenceServer`` (max_batch 16): 8 threads send 64 rows
   in requests of 1, 2, 3, 5 and 8 rows; K4 counted from 0 must be 2 a
   dispatched batch (and the scheduler's own ``kernel_launches`` the
   same); every answer within 1e-5 of the largest |output| of the live
   workflow's own forward on the card (fp16: over the weights rounded
   to fp16 and promoted back), the count of bitwise rows printed.
   (b) Phase 4c's AlexNet (published widths, ``use_pallas`` unset)
   exported at fp32, loaded as a ``PackageLoader`` and served on ``POST
   /api/alexnet`` (max_batch 8): 16 requests of 1-8 images from 4
   threads; K5 2 a dispatched batch; answers within 1e-5 relative of
   the live forward, and 4 images within 1e-4 relative of the same
   package on the CPU; package bytes, export, load and warmup seconds
   and images/s printed.  (c) Phase 4b's attention net (d_model 512, 8
   heads, T=2048, no mask) through the server's registry entry
   in-process: 8 requests of 1-2 sequences, K7 once a dispatched batch,
   held as (b).  (d) Phase 4d's LRN convnet served by a fleet of two
   replicas (``--model lrn=<package> --device cuda``) over a fresh
   build cache filled before they start: 24 requests of 8 images
   through the router, every answer bitwise the in-process card
   answer, each replica's K5 count over HTTP (``kernel_launches`` in
   ``GET /metrics``) more than 0 and 2 a batch, no replica building a
   kernel.  (e) ``RESTfulAPI`` over (a)'s fp32 package: ``POST /api``
   held like (a).  Each part prints its wall time; the kernels line
   adds the package launches.
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
   validation error < 40 %.  Then the unit with one head (head dim 512:
   K7-K9's wide path) at T=2048 takes 2 train steps on 24 sequences
   (minibatch 8) on the card and on the CPU (``use_pallas=True``): each
   loss within 1e-4 relative, each parameter tensor within 1e-4 of its
   largest magnitude; K7, K8 and K9 counted from 0 over the card's
   steps, once a step each.
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
4e. Graph mode (slice 17): ``StandardWorkflow(fused=False)``, each
   forward, the evaluator and each GD unit a unit of its own, on the
   card.  (a) MNIST at the gate's settings with ``precise_gemm=1``, as
   many epochs as phase 4's run: K4 counted from 0, once per All2All
   forward of every train and eval step (2 and 2) and never inside a GD
   unit; the first epoch held against graph mode on the CPU (n_err of
   each class within 1, weights within 1e-4); the best validation error
   within 0.2 points of phase 4's fused ``precise_gemm=1`` run; graph
   MNIST's train images/s printed beside the fused run's.  (b) Phase
   4d's LRN convnet, 5 epochs: K5 2 per train and eval step, K6 2 per
   train step; best validation error < 25 %; the first 2 train steps on
   300 + 100 images on the card and on the CPU: each dropout mask equal
   bit for bit, losses and weights within ``steps_agree``'s limits.  (c)
   Phase 4b's full-width attention runs (no mask; causal, window 512):
   K7, K8 and K9 once a train step, K7 once an eval step; the first
   epoch cut to 24 sequences (``use_pallas=True``) in graph mode on the
   card against the CPU (n_err within 1, weights within 1e-4) and
   against fused mode on the card (weights within 2e-4).  (d) The JAX
   tests' MSE regression workflow (``MSE_LAYERS``, every All2All on K4),
   graph and fused on the card: weights within 2e-4, best rmse within
   1e-3.  (e) The loader's two paths: 8 graph-mode train steps of the
   full-width attention unit with the host path (``force_numpy``) and
   with the device gather, in turns; each path's sequences/s printed.
   Each part's wall time is printed.
4f. Snapshots and sharded data (slice 20), after 4e.  Each part
   restores in a fresh process (``chip_smoke.py --resume-child``,
   importing only the port), which counts the kernels from 0 and writes
   its weights (``.npz``) and record (JSON) for this process to hold.
   (a) MNIST at the gate's settings with ``precise_gemm=1``, fused and
   graph mode: 6 epochs uninterrupted, and 3 with ``SnapshotterToFile``
   (async, gz) whose ``_current`` resumes to 6: weights, bias and
   ``epoch_n_err_pt`` bit for bit the uninterrupted run's; K4 5 a train
   and 2 an eval step fused, 2 and 2 in graph mode.  The card's fused
   snapshot resumed on the CPU too (CUDA hidden from that process: the
   snapshot names no device): n_err within 1, weights within 1e-4 of
   the card's resume.  (b) AlexNet at its published widths (phase 4c's
   net, ``use_pallas`` unset, dropout 0.5) on 512 + 128 images at
   minibatch 128: 2 epochs uninterrupted, and 1 with
   ``SnapshotterToShards`` (16 MiB chunks) shot at its end and resumed
   for the second: every dropout mask of that epoch bit for bit,
   losses within 1e-4 relative, parameters within 1e-4 of each tensor's
   largest magnitude (cuDNN's f32 algorithms may differ between
   processes); K5 2 a step, K6 2 a train step; the checkpoint's bytes
   and chunks, the capture stall, the writer's save and the restore
   seconds printed; the dataset is not in it.  (c) Phase 4b's
   full-width attention net (no mask) on 16 + 8 sequences at minibatch
   8: 2 epochs uninterrupted, and 1 with ``SnapshotterToDB`` (SQLite)
   shot at its end and resumed for the second: weights bit for bit; K7,
   K8 and K9 once a train step (K7 once an eval step).  (d) (a)'s fused
   run for 3 epochs fed by a ``ShardedBatchLoader`` over the digits
   written by ``write_shards`` (1000 rows a shard, a window of a third
   of the data, global shuffle): weights bit for bit the 3-epoch
   FullBatchLoader run's, the window within its budget, shards loaded;
   images/s of both loaders printed.  The kernels line adds every launch
   of the phase.
4g. The structural conv units and the two conv samples (slice 21),
   after 4f, at the samples' published widths.  (a) STL-10 (96x96x3,
   minibatch 50, its synthetic twin's 5000 train + 800 valid images)
   with ``precise_gemm=1``, fused and in graph mode, ``STL10_EPOCHS``
   epochs each (cut from the sample's 100): K4 ``STL10_K4`` times a
   train / eval step (fused 6 / 2: the all2all and softmax forwards,
   their weight and input gradients; graph mode 2 / 2, never inside a
   GD unit); the best validation error under the JAX gate's 50 %;
   graph mode's mean train loss of each epoch within
   ``CONV_MODES_LOSS_RTOL`` of fused mode's largest (the validation error
   reads 0 % from the first epoch on the separable twin, so it cannot
   tell the modes apart), the first epoch's weights' distance printed;
   the first ``CONV_HOLD_STEPS`` train steps of each
   mode on 300 + 100 images on the card and on the CPU: losses within
   ``CONV_LOSS_RTOL`` relative, parameters within ``CONV_WEIGHT_RTOL``
   of their largest magnitude.  (b) VideoAE (32x32x1 frames, 480 + 120,
   minibatch 50; conv, max pooling, depooling, deconv, MSE) for its 15
   epochs, fused and graph mode: no hand kernel launched (cuDNN runs its
   conv and deconv); the best validation rmse under half the targets'
   standard deviation (the JAX gate); graph against fused mode and the
   first steps against the CPU as in (a).  The synthetic twins are made
   once for the phase.  Each run's train images/s (the median epoch after
   the first) is printed; phase 5 traces one fused STL-10 epoch.  The
   kernels line adds (a)'s K4 launches.
5. Where the time goes: each serving configuration's burst, one
   training epoch of each matmul mode, one full-width attention epoch
   of each mask (none; causal, window 512) and one AlexNet epoch with
   each LRN form once
   more under ``torch.profiler`` (after every untraced measurement):
   the share of the wall time the card is busy, the top kernels, the
   device copies and cuDNN's layout transforms, the int64
   elementwise kernels (dropout's threefry draws), and the device time
   of K1 and K2 (with their merge), K3, K4 (each with its split-K
   fold), K5 and K6; then phase 3b's two turns with the options (f32,
   int8).  Each serving
   configuration's tok/s and decode step p50 (phase 3) are printed
   beside its traced burst's launches and device-to-device copies, and
   int8-kv's beside the burst's numbers before the append kernel
   (``PASSES_INT8_KV``).  Last, one graph-mode MNIST epoch
   (``precise_gemm=1``) and one fused STL-10 epoch (``precise_gemm=1``).
   A trace that holds no device time is taken again on a fresh run, up
   to ``TRACE_TRIES`` times in all; a run with none in every try fails.
6. The ``kernels`` JSON line, the card's line, and the result line.
   Each phase prints its wall time.

Imports nothing of JAX or of the JAX package.  ``--json PATH`` writes
every number to PATH as well.
"""

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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


# -- phase 2, the int8-KV append (not a TPU kernel) ---------------------------

def append_cases():
    """[(label, pool shape (num_blocks, block_size, H, hd), blk, off)] of
    the int8-KV append, numpy int64 (``blk`` 0 is the trash block): the
    README prefill (128 positions, H 4, hd 16, blocks of 16) of a
    100-token prompt, padding past it into the trash block; a verify
    span [16, 5] over rows of ragged lengths (one padding row, one row
    whose span runs past its table); and a realistic prefill of 2048
    positions at H 8, hd 128, blocks of 16."""
    rng = numpy.random.RandomState(11)
    cases = []
    pos = numpy.arange(128)
    row = 1 + rng.permutation(40)[:8]
    cases.append(("prefill", (41, 16, 4, 16),
                  numpy.where(pos < 100, row[pos // 16], 0), pos % 16))
    nb = 4
    table = (1 + rng.permutation(16 * nb)).reshape(16, nb)
    lengths = rng.randint(1, nb * 16 - 4, 16)
    lengths[3], table[3] = 0, 0          # a padding row: the trash block
    lengths[5] = nb * 16 - 2             # its span runs past the table
    span = lengths[:, None] + numpy.arange(5)[None, :]
    blk = numpy.where(span < nb * 16,
                      table[numpy.arange(16)[:, None],
                            numpy.minimum(span // 16, nb - 1)], 0)
    cases.append(("verify", (16 * nb + 1, 16, 4, 16), blk, span % 16))
    pos = numpy.arange(2048)
    row = 1 + rng.permutation(160)[:128]
    cases.append(("realistic", (161, 16, 8, 128), row[pos // 16],
                  pos % 16))
    return cases


def append_inputs(torch, dev, shape, blk, off, seed, scale=1.0,
                  growing=False):
    """(q, s, blk, off, vals) on ``dev``: a pool holding earlier content
    (int8 in [-127, 127], scales in [0, 0.05)) and f32 values
    ``randn * scale`` for each write.  ``growing``: each write's values
    are ``uniform(-1, 1) * g`` with one of them ``g = 1.25 ** off``, so
    a block's scale grows on every write (every ratio differs from 1)."""
    rng = numpy.random.RandomState(seed)
    q = torch.tensor(rng.randint(-127, 128, shape), dtype=torch.int8,
                     device=dev)
    s = torch.tensor(rng.uniform(0, 0.05, (shape[0], shape[2])),
                     dtype=torch.float32, device=dev)
    if growing:
        g = (1.25 ** off.astype(numpy.float64))[..., None, None]
        v = rng.uniform(-1, 1, blk.shape + shape[2:]) * g
        v[..., 0] = g[..., 0]
    else:
        v = rng.standard_normal(blk.shape + shape[2:]) * scale
    vals = torch.tensor(v, dtype=torch.float32, device=dev)
    return (q, s, torch.tensor(blk, device=dev),
            torch.tensor(off, device=dev), vals)


def append_equal(torch, pa, q, s, blk, off, vals):
    """Kernel and plain version from the same pool: whether every block
    but the trash block and every scale come out bitwise equal, and the
    largest byte difference."""
    kq, ks = q.clone(), s.clone()
    pa.kv_append_int8(kq, ks, blk, off, vals)
    rq, rs = q.clone(), s.clone()
    pa.kv_append_int8_reference(rq, rs, blk, off, vals)
    torch.cuda.synchronize()
    err = int((kq[1:].int() - rq[1:].int()).abs().max())
    return (torch.equal(kq[1:], rq[1:]) and torch.equal(ks[1:], rs[1:]),
            err)


def _measure_append(torch, pa, dev, label, shape, blk, off, seed):
    q, s, tblk, toff, vals = append_inputs(torch, dev, shape, blk, off,
                                           seed, growing=label == "growing")
    bitwise, err = append_equal(torch, pa, q, s, tblk, toff, vals)
    if not bitwise:
        raise AssertionError("kv_append_int8 %s: kernel and plain version "
                             "differ (max byte difference %d)"
                             % (label, err))
    _, bs, h, d = shape
    blocks = len(set(blk.reshape(-1).tolist()) - {0})
    # each touched block's bytes and scales read and written once, each
    # value and index read once
    nbytes = (blocks * 2 * (bs * h * d + h * 4) + vals.numel() * 4
              + 2 * blk.size * 8)
    bound_ms, bound_by = _bound(nbytes, 0)
    call = lambda: pa.kv_append_int8(q, s, tblk, toff, vals)  # noqa: E731
    rec = {"shape": "%s: %d writes %r into %d blocks of [%d, %d, %d]"
                    % (label, blk.size, list(blk.shape), blocks, bs, h, d),
           "max_abs_err": float(err), "bitwise": bitwise,
           "ms": _cuda_ms(torch, call),
           "device_ms": _device_ms(torch, call, launches=1),
           "plain_ms": _cuda_ms(torch, lambda: pa.kv_append_int8_reference(
               q, s, tblk, toff, vals), iters=5),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    _log("kernel kv_append_int8 [%s] bitwise=%s kernel_ms=%.4f "
         "device_ms=%.4f plain_ms=%.4f bound_ms=%.5f (%s) library_ms=none "
         "(no single PyTorch call computes the append)"
         % (rec["shape"], bitwise, rec["ms"], rec["device_ms"],
            rec["plain_ms"], bound_ms, bound_by))
    return rec


def append_phase(torch, pa, dev):
    """-> {"kv_append_int8": {"main": README prefill record,
    "realistic": [the verify span's, the 2048-position prefill's, the
    same prefill with a scale that grows on every write]}}."""
    cases = append_cases()
    cases.append(("growing",) + cases[-1][1:])
    recs = [_measure_append(torch, pa, dev, label, shape, blk, off, 20 + i)
            for i, (label, shape, blk, off) in enumerate(cases)]
    return {"kv_append_int8": {"main": recs[0], "realistic": recs[1:]}}


# -- phase 2, K4: the compensated GEMM ----------------------------------------

#: (label, M, K, N, layout) of every K4 call of an MNIST train step at
#: minibatch 60 (784-100-10); "at" = a is a transposed view, "bt" = b is
K4_MAIN_SHAPES = (("fwd 60x784 @ 784x100", 60, 784, 100, ""),
                  ("fwd 60x100 @ 100x10", 60, 100, 10, ""),
                  ("bwd dx g @ W2^T", 60, 10, 100, "bt"),
                  ("bwd dW2 h^T @ g", 100, 60, 10, "at"),
                  ("bwd dW1 x^T @ g", 784, 60, 100, "at"))
#: the same for an STL-10 train step at minibatch 50 (phase 4g: the
#: all2all 7744 -> 128, its input 11x11x64, and the softmax 128 -> 10;
#: ``precise_gemm=1``, so held at level 1)
K4_STL10_SHAPES = (("STL-10 fwd 50x7744 @ 7744x128", 50, 7744, 128, ""),
                   ("STL-10 fwd 50x128 @ 128x10", 50, 128, 10, ""),
                   ("STL-10 bwd dx g @ W2^T", 50, 10, 128, "bt"),
                   ("STL-10 bwd dW2 h^T @ g", 128, 50, 10, "at"),
                   ("STL-10 bwd dx g @ W1^T", 50, 128, 7744, "bt"),
                   ("STL-10 bwd dW1 x^T @ g", 7744, 50, 128, "at"))
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
    """Untimed: at the MNIST and STL-10 forward shapes (each splits K)
    each level equals, bit for bit, the top-left corner of operands too
    large to split."""
    out = {}
    for _, m, k, n, _ in (K4_MAIN_SHAPES[0], K4_STL10_SHAPES[0]):
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
                    "K4 level %d at K=%d: split %d, large call unsplit %s, "
                    "split equal to unsplit %s"
                    % (level, k, split, unsplit, equal))
            out["M=%d K=%d N=%d level %d" % (m, k, n, level)] = equal
        _log("kernel precise_matmul split-K: M=%d K=%d N=%d splits and "
             "equals the unsplit corner bit for bit at levels 0-2"
             % (m, k, n))
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
    cancellation errors.  Level 1's main records are MNIST's then
    STL-10's."""
    out = {}
    for level in (0, 1, 2):
        shapes = K4_MAIN_SHAPES + (K4_STL10_SHAPES if level == 1 else ())
        out[level] = {
            "main": [_measure_k4(torch, gemm, dev, level, label, m, k, n,
                                 layout, seed=10 * level + i)
                     for i, (label, m, k, n, layout)
                     in enumerate(shapes)],
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
#: the same unit with one head (head dim 512: the kernels' wide path),
#: timed at B=1 T=2048 H=2 causal
FLASH_WIDE = ((1, 2048, 2, 512), True, None)
FLASH_MASKS = ((False, None), (True, None), (True, 512))
#: the JAX package's measured shapes (bench.py:543 bench_flash_attention,
#: :577 bench_window_attention)
FLASH_REALISTIC = (((2, 2048, 8, 64), True, None),
                   ((1, 16384, 8, 64), True, 512),
                   ((2, 2048, 4, 128), True, None),
                   ((2, 2048, 2, 256), True, None),
                   FLASH_WIDE)
#: (B, T, H, D, causal, window) held untimed: head dims below a tile, T
#: below and at a tile, the JAX tests' windows, and T=256 with window
#: 40, where both backward passes are banded (test_flash_attention.py);
#: head dims past 128 (the 256 instantiation, zero-padded below 256) and
#: past 256 (the wide path)
FLASH_SMALL = tuple(
    [(2, t, 2, d, c, w) for d in (4, 8, 16) for t in (7, 8, 256)
     for c, w in ((False, None), (True, None), (True, 5))] +
    [(1, 256, 2, 16, True, w) for w in (1, 5, 64, 100, 256)] +
    [(1, 256, 2, 8, True, 40)] +
    [(2, t, 2, d, c, w) for d in (129, 192, 256, 320, 512, 1024)
     for t in (7, 256) for c, w in ((False, None), (True, None),
                                    (True, 40))])
#: the one-head unit's own calls (minibatch 8, T 2048, head dim 512:
#: the wide path's grid on the main path), held untimed under the unit's
#: mask and causal
FLASH_WIDE_MAIN = ((8, 2048, 1, 512, False, None),
                   (8, 2048, 1, 512, True, None))
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
    d_tile = next((x for x in FLASH_D_TILES if x >= d), "wide")
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
        _log("kernel %s [%s] D tile %s max_err=%.3g kernel_ms=%.4f "
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
    held = FLASH_SMALL + FLASH_WIDE_MAIN
    for i, (b, t, h, d, causal, window) in enumerate(held):
        _flash_check(torch, fa, *_flash_inputs(torch, dev, b, t, h, d, i),
                     causal, window, "B=%d T=%d H=%d D=%d causal=%s "
                     "window=%s" % (b, t, h, d, causal, window))
    _log("kernel flash attention: %d small cases (head dims 4/8/16, T "
         "7/8/256, windows 1-256; head dims 129-1024, T 7/256) and the "
         "one-head unit's B=8 T=2048 H=1 D=512, no mask and causal, "
         "within the limits" % len(held))
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


def _post_all(url, prompts, new_tokens=NEW_TOKENS):
    """POST every prompt concurrently; -> (answers in order, seconds)."""
    answers = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            req = urllib.request.Request(
                url + "/api/flagship/generate",
                json.dumps({"prompt": prompts[i],
                            "max_new_tokens": new_tokens}).encode(),
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
    from veles_tpu_torch.observability.flight import RECORDER
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
        RECORDER.reset()     # the ring holds this burst's timelines only
        pa.paged_attention.launches = 0
        pa.kv_append_int8.launches = 0
        gemm.quantized_matmul.launches = 0
        answers, seconds = _post_all(server.url, prompts)
        launches = {"paged_attention": pa.paged_attention.launches,
                    "kv_append_int8": pa.kv_append_int8.launches,
                    "quantized_matmul": gemm.quantized_matmul.launches}
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=60) as resp:
            metrics = json.loads(resp.read())["flagship"]
        flight = burst_timelines(server.url, answers, label)
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
           "oracle": oracle, "flight": flight, "answers": got}
    _log("e2e %s: %d requests, %d tokens in %.3f s = %.1f tok/s; TTFT "
         "p50 %.1f ms p99 %.1f ms; decode step p50 %s ms p99 %s ms over "
         "%d steps; launches %s; tokens equal %s [%s]"
         % (label, rec["requests"], rec["tokens"], seconds, rec["tok_s"],
            rec["ttft_p50_ms"], rec["ttft_p99_ms"], rec["step_ms_p50"],
            rec["step_ms_p99"], steps, launches, oracle, card))
    return rec


# -- phase 3b: prefix caching, chunked prefill, speculation over HTTP ---------

#: the scheduler options phase 3b turns on
OPTIONS_SERVER = dict(prefix_caching=True, prefill_chunk_tokens=32,
                      spec_depth=4)
SYSTEM_TOKENS, SUFFIX_TOKENS, TURN2_TOKENS = 64, (8, 24), 8


def turn1_prompts():
    """8 prompts that share a 64-token system prefix, each with its own
    8-24-token suffix."""
    rng = numpy.random.RandomState(13)
    vocab = README_MODEL["vocab"]
    system = rng.randint(0, vocab, SYSTEM_TOKENS).tolist()
    return [system + rng.randint(0, vocab, int(rng.randint(
        SUFFIX_TOKENS[0], SUFFIX_TOKENS[1] + 1))).tolist()
        for _ in range(N_REQUESTS)]


def turn2_prompts(turn1, answers):
    """Each turn-1 prompt, its answer and 8 more tokens: the
    conversation resubmitted."""
    rng = numpy.random.RandomState(14)
    return [p + list(a) + rng.randint(0, README_MODEL["vocab"],
                                      TURN2_TOKENS).tolist()
            for p, a in zip(turn1, answers)]


def _scheduler_turns(sched, turn1, turn2=None):
    """Both turns through a scheduler directly: -> tokens of turn 1 and
    of turn 2 (each turn submitted at once, the second after the first
    finished; ``turn2`` defaults to the conversations resubmitted)."""
    out = []
    for prompts in (turn1, turn2):
        if prompts is None:
            prompts = turn2_prompts(turn1, out[0])
        futures = [sched.submit(p, NEW_TOKENS) for p in prompts]
        out.append([f.result(900)["tokens"] for f in futures])
    return out


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def options_run(pa, card, label, kv_dtype, options, turn2=None):
    """Both turns over HTTP through ``InferenceServer`` with the
    scheduler ``options`` (none: the core scheduler) and the README
    widths: -> the record, with every answer's tokens.  ``turn2``
    defaults to the conversations resubmitted."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype)
    server = InferenceServer({"flagship": model}, kv_dtype=kv_dtype,
                             **README_SERVER, **options)
    turn1 = turn1_prompts()
    try:
        pa.paged_attention.launches = 0
        pa.kv_append_int8.launches = 0
        first, s1 = _post_all(server.url, turn1)
        if turn2 is None:
            turn2 = turn2_prompts(turn1, [a["tokens"] for a in first])
        second, s2 = _post_all(server.url, turn2)
        launches = {"paged_attention": pa.paged_attention.launches,
                    "kv_append_int8": pa.kv_append_int8.launches}
        metrics = _get_json(server.url + "/metrics")["flagship"]
        dump = _get_json(server.url + "/api/flagship/kv")
    finally:
        server.stop()
    if dump["integrity"]:
        raise AssertionError("%s: the KV dump's integrity list: %s"
                             % (label, dump["integrity"]))
    tokens = [a["tokens"] for a in first + second]
    if any(len(t) != NEW_TOKENS for t in tokens):
        raise AssertionError("%s: wrong token counts" % label)
    ttft = [sorted(a["ttft_s"] for a in turn) for turn in (first, second)]
    rec = {"label": label, "kv_dtype": kv_dtype, "options": options,
           "card": card, "prompts": turn1 + turn2, "tokens": tokens,
           "seconds": s1 + s2, "tok_s": sum(map(len, tokens)) / (s1 + s2),
           "ttft_p50_ms": [1e3 * statistics.median(t) for t in ttft],
           "step_ms_p50": metrics["step_latency"]["p50_ms"],
           "launches": launches, "integrity": dump["integrity"]}
    for key in ("prefix_hits", "dedup_blocks", "chunks", "draft_tokens",
                "accepted_tokens", "rejected_tokens", "verify_steps",
                "steps"):
        rec[key] = metrics[key]
    for key in ("draft_rollbacks", "rolled_back_tokens", "published_blocks",
                "dedup_ratio"):
        rec[key] = dump[key]
    _log("e2e %s: %d requests in two turns, %d tokens in %.3f s = %.1f "
         "tok/s; TTFT p50 turn 1 %.1f ms, turn 2 %.1f ms; decode step p50 "
         "%s ms; prefix hits %d, dedup blocks %d, chunks %d; drafted %d, "
         "accepted %d, rejected %d over %d verify passes, rollbacks %d "
         "(%d tokens); launches %s; kv integrity %s [%s]"
         % (label, len(tokens), sum(map(len, tokens)), rec["seconds"],
            rec["tok_s"], *rec["ttft_p50_ms"], rec["step_ms_p50"],
            rec["prefix_hits"], rec["dedup_blocks"], rec["chunks"],
            rec["draft_tokens"], rec["accepted_tokens"],
            rec["rejected_tokens"], rec["verify_steps"],
            rec["draft_rollbacks"], rec["rolled_back_tokens"], launches,
            dump["integrity"] or "[] (empty)", card))
    return rec


def _cpu_turns(kv_dtype, options, turn1, turn2):
    """The same two turns through the port on the CPU (plain versions)
    with the same scheduler options."""
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype,
                                device="cpu")
    sched = DecodeScheduler(model, name="cpu-oracle", device="cpu",
                            kv_dtype=kv_dtype, **README_SERVER, **options)
    try:
        first, second = _scheduler_turns(sched, turn1, turn2)
    finally:
        sched.close()
    return first + second


def options_phase(pa, card):
    """Phase 3b: for f32 and int8 KV, both turns with ``OPTIONS_SERVER``
    and through the core scheduler, each held to its oracle (f32: the
    cache-free ``generate_reference`` on the card; int8: the port on the
    CPU with the same options)."""
    from veles_tpu_torch.znicz.samples.flagship import (
        FlagshipDecodeModel, generate_reference)
    out = []
    turn1 = turn1_prompts()
    for kv_dtype in ("f32", "int8"):
        runs = [options_run(pa, card, kv_dtype + " options", kv_dtype,
                            OPTIONS_SERVER)]
        # the core scheduler serves the same traffic: the options run's
        # second turn as it was sent
        turn2 = runs[0]["prompts"][len(turn1):]
        runs.append(options_run(pa, card, kv_dtype + " core", kv_dtype, {},
                                turn2))
        for run in runs:
            if kv_dtype == "f32":
                if run is runs[0]:
                    params = FlagshipDecodeModel(**README_MODEL).params
                    want = [generate_reference(params, p, NEW_TOKENS,
                                               heads=README_MODEL["heads"])
                            for p in run["prompts"]]
                oracle = "cache-free generate_reference on the card"
            else:
                want = _cpu_turns(kv_dtype, run["options"], turn1, turn2)
                oracle = "the same options on the CPU"
            bad = [i for i, (g, w) in enumerate(zip(run["tokens"], want))
                   if g != w]
            if bad:
                raise AssertionError("%s: answers %s differ from %s"
                                     % (run["label"], bad, oracle))
            run["oracle"] = oracle
        opts, core = runs
        same = sum(a == b for a, b in zip(opts["tokens"], core["tokens"]))
        opts["core_equal"] = same
        if kv_dtype == "f32" and same != len(opts["tokens"]):
            raise AssertionError("f32: the core scheduler's answers differ "
                                 "from the options run's")
        _log("e2e %s: tokens equal %s; core scheduler on the same traffic: "
             "%.1f tok/s, TTFT p50 %.1f / %.1f ms, tokens equal %s and "
             "%d of %d equal to the options run's; TTFT p50 turn 2 / turn "
             "1 with options %.3f, core %.3f [%s]"
             % (kv_dtype, opts["oracle"], core["tok_s"],
                *core["ttft_p50_ms"], core["oracle"], same,
                len(opts["tokens"]),
                opts["ttft_p50_ms"][1] / opts["ttft_p50_ms"][0],
                core["ttft_p50_ms"][1] / core["ttft_p50_ms"][0], card))
        out += runs
    return out


# -- phase 3c: the tiered KV cache, KV checkpoints, session migration ---------

#: phase 3c's tiered server: phase 3b's prefix caching and chunks (no
#: speculation), a pool of TIER_BLOCKS blocks, which turn 1's chains must
#: leave once the fillers come, and a host tier of TIER_HOST_BLOCKS
#: blocks' wire bytes, so the rest cascade to disk
TIER_OPTIONS = dict(prefix_caching=True, prefill_chunk_tokens=32)
TIER_BLOCKS, TIER_HOST_BLOCKS = 48, 12
N_FILLERS, FILLER_TOKENS, FILLER_NEW = 16, 112, 16
#: the migration source's pinned host time a step, so the export lands
#: mid-generation (32 steps take ~0.3 s instead of ~0.1 s)
MIGRATE_STEP_DELAY = 0.005
#: phase 2's long-context pool: blocks, block size, heads, head dim (2
#: stages x K/V of f32: 1.07 GB); the 8 sessions checkpointed on it
REAL_POOL = (4096, 16, 8, 128)
REAL_SESSIONS, REAL_PROMPT, REAL_NEW = 8, 2000, 16
#: blocks demoted and readmitted per tier to time the round trip
REAL_TIER_BLOCKS = 64


def filler_prompts():
    """16 distinct 112-token prompts that churn the pool between the
    turns."""
    rng = numpy.random.RandomState(15)
    return [rng.randint(0, README_MODEL["vocab"], FILLER_TOKENS).tolist()
            for _ in range(N_FILLERS)]


def _post_json(url, payload, headers=None, timeout=600):
    """POST ``payload`` -> (status, body, headers), error statuses
    included."""
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _block_wire_bytes(model, kv_dtype):
    """The serialized size of one block of ``model``'s pools (what a
    tier holds per block)."""
    from veles_tpu_torch.serving.decode import _gather
    from veles_tpu_torch.serving.sessions import pack_block
    k, v = model.make_pools(2, README_SERVER["block_size"],
                            kv_dtype=kv_dtype)
    return len(pack_block({"kv_k": _gather(k, 1), "kv_v": _gather(v, 1)}))


def _reset_launches(pa):
    pa.paged_attention.launches = 0
    pa.kv_append_int8.launches = 0


def _read_launches(pa, label, kv_dtype):
    """The path's launches since the reset; a path that ran no paged
    attention (or, int8, no append) fails the run."""
    got = {"paged_attention": pa.paged_attention.launches,
           "kv_append_int8": pa.kv_append_int8.launches}
    if got["paged_attention"] <= 0 or \
            (kv_dtype == "int8") != (got["kv_append_int8"] > 0):
        raise AssertionError("%s: the kernels did not run as the path "
                             "needs: %s" % (label, got))
    return got


def _held(label, got, want, oracle):
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad or len(got) != len(want):
        raise AssertionError("%s: answers %s differ from %s"
                             % (label, bad, oracle))


def _card_oracle(prompts_new):
    """Cache-free ``generate_reference`` on the card for each (prompt,
    new tokens)."""
    from veles_tpu_torch.znicz.samples.flagship import (
        FlagshipDecodeModel, generate_reference)
    params = FlagshipDecodeModel(**README_MODEL).params
    return [generate_reference(params, p, n, heads=README_MODEL["heads"])
            for p, n in prompts_new]


def _tier_server_options(model, kv_dtype, tier_dir):
    host = TIER_HOST_BLOCKS * _block_wire_bytes(model, kv_dtype)
    return dict(README_SERVER, **TIER_OPTIONS, num_blocks=TIER_BLOCKS,
                kvtier={"host_bytes": host, "disk_dir": tier_dir})


def _cpu_tier_turns(kv_dtype, traffic):
    """The tier run's traffic (a list of (prompts, new tokens) bursts)
    through the port on the CPU with the same options and its own disk
    tier."""
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype,
                                device="cpu")
    tier_dir = tempfile.mkdtemp(prefix="veles-kvtier-cpu-")
    sched = DecodeScheduler(model, name="cpu-tiers", device="cpu",
                            kv_dtype=kv_dtype,
                            **_tier_server_options(model, kv_dtype,
                                                   tier_dir))
    try:
        out = []
        for prompts, new in traffic:
            futures = [sched.submit(p, new) for p in prompts]
            out += [f.result(900)["tokens"] for f in futures]
        return out
    finally:
        sched.close()
        shutil.rmtree(tier_dir, ignore_errors=True)


def tier_run(pa, card, kv_dtype):
    """Phase 3c's tiers: turn 1 over HTTP through a server whose pool
    cannot keep the conversations, 16 fillers that churn them out to
    host RAM and disk, then turn 2 (each conversation resubmitted),
    which readmits them.  Every answer is held to its oracle; the tier
    counters and the KV dump's integrity list are checked."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    label = kv_dtype + " tiers"
    model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype)
    tier_dir = tempfile.mkdtemp(prefix="veles-kvtier-")
    options = _tier_server_options(model, kv_dtype, tier_dir)
    server = InferenceServer({"flagship": model}, kv_dtype=kv_dtype,
                             **options)
    turn1, fillers = turn1_prompts(), filler_prompts()
    try:
        _reset_launches(pa)
        first, s1 = _post_all(server.url, turn1)
        turn2 = turn2_prompts(turn1, [a["tokens"] for a in first])
        churn, s_fill = _post_all(server.url, fillers, FILLER_NEW)
        before = _get_json(server.url + "/metrics")["flagship"]
        second, s2 = _post_all(server.url, turn2)
        launches = _read_launches(pa, label, kv_dtype)
        metrics = _get_json(server.url + "/metrics")["flagship"]
        dump = _get_json(server.url + "/api/flagship/kv")
    finally:
        server.stop()
        shutil.rmtree(tier_dir, ignore_errors=True)
    if dump["integrity"]:
        raise AssertionError("%s: the KV dump's integrity list (the "
                             "tiers' included): %s"
                             % (label, dump["integrity"]))
    tiers = metrics["kvtier"]
    moved = {"demotions host": tiers["demotions"]["host"],
             "demotions disk": tiers["demotions"]["disk"],
             "promotions": sum(tiers["promotions"].values()),
             "disk_readmits": tiers["disk_readmits"]}
    if min(moved.values()) <= 0:
        raise AssertionError("%s: the tiers were not all used: %s"
                             % (label, moved))
    traffic = [(turn1, NEW_TOKENS), (fillers, FILLER_NEW),
               (turn2, NEW_TOKENS)]
    got = [a["tokens"] for a in first + churn + second]
    if kv_dtype == "f32":
        want = _card_oracle([(p, n) for ps, n in traffic for p in ps])
        oracle = "cache-free generate_reference on the card"
    else:
        want = _cpu_tier_turns(kv_dtype, traffic)
        oracle = "the same options and tiers on the CPU"
    _held(label, got, want, oracle)
    prompt2 = sum(map(len, turn2))
    prefilled2 = metrics["prefill_tokens"] - before["prefill_tokens"]
    ttft = [sorted(a["ttft_s"] for a in turn) for turn in (first, second)]
    rec = {"label": label, "kv_dtype": kv_dtype, "card": card,
           "options": {k: v for k, v in options.items() if k != "kvtier"},
           "host_bytes": options["kvtier"]["host_bytes"],
           "seconds": [s1, s_fill, s2],
           "ttft_p50_ms": [1e3 * statistics.median(t) for t in ttft],
           "turn2_prompt_tokens": prompt2,
           "turn2_prefilled_tokens": prefilled2,
           "tiers": tiers, "launches": launches, "oracle": oracle,
           "integrity": dump["integrity"]}
    _log("e2e %s: turn 1, %d fillers, turn 2 over a %d-block pool with a "
         "%d-byte host tier and a disk tier; TTFT p50 turn 1 %.1f ms, turn "
         "2 %.1f ms; turn 2 prefilled %d of %d prompt tokens; demotions "
         "%s, promotions %s, disk readmits %d, tier bytes host %d disk %d; "
         "launches %s; tokens equal %s; kv integrity [] (empty) [%s]"
         % (label, N_FILLERS, TIER_BLOCKS, rec["host_bytes"],
            *rec["ttft_p50_ms"], prefilled2, prompt2, tiers["demotions"],
            tiers["promotions"], tiers["disk_readmits"],
            tiers["host_bytes"], tiers["disk_bytes"], launches, oracle,
            card))
    return rec


def _wait_rows(sched, n, timeout=120):
    """Block until ``n`` sessions hold decode rows (read on the worker in
    one job): the cut that follows lands mid-generation."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if sched._run_job(lambda: len(sched._sessions)) >= n:
            return
        time.sleep(0.001)
    raise AssertionError("%d sessions never started decoding" % n)


def _cut_and_restore(pa, make, prompts, new, label, kv_dtype):
    """Submit ``prompts`` to a scheduler from ``make(name)``,
    ``checkpoint_kv`` it with every sequence mid-generation, let it
    finish (the uninterrupted run), then ``restore_kv`` into a fresh
    scheduler, which finishes from the cut.  -> (record, the
    uninterrupted tokens); each restored sequence must emit the
    uninterrupted run's tokens."""
    from veles_tpu_torch.checkpoint import load_state, open_checkpoint
    tmp = tempfile.mkdtemp(prefix="veles-kvckpt-")
    src = make(label + "-src")
    try:
        futures = [src.submit(p, new) for p in prompts]
        _wait_rows(src, len(prompts))
        t0 = time.perf_counter()
        path = src.checkpoint_kv(tmp)
        save_s = time.perf_counter() - t0
        whole = [f.result(900)["tokens"] for f in futures]
    finally:
        src.close()
    try:
        _, man, _ = open_checkpoint(path)
        saved = load_state(path)["sessions"]
        if len(saved) != len(prompts) or any(
                not 0 < len(s["generated"]) < new for s in saved):
            raise AssertionError("%s: the cut holds %d sessions, not all "
                                 "mid-generation" % (label, len(saved)))
        by_row = {s["row"]: [int(t) for t in s["prompt"]] for s in saved}
        _reset_launches(pa)
        dst = make(label + "-dst")
        try:
            t0 = time.perf_counter()
            restored = dst.restore_kv(path)
            restore_s = time.perf_counter() - t0
            resumed = {row: f.result(900)["tokens"]
                       for row, f in restored.items()}
        finally:
            dst.close()
        launches = _read_launches(pa, label, kv_dtype)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row, tokens in resumed.items():
        if tokens != whole[prompts.index(by_row[row])]:
            raise AssertionError("%s: row %d resumed with other tokens "
                                 "than the uninterrupted run's"
                                 % (label, row))
    unique = {c["digest"]: c["bytes"] for e in man.tensors.values()
              for c in e["chunks"]}
    rec = {"label": label, "kv_dtype": kv_dtype, "sessions": len(saved),
           "checkpoint_bytes": man.total_bytes(),
           "unique_chunk_bytes": sum(unique.values()), "save_s": save_s,
           "restore_s": restore_s,
           "save_gb_s": man.total_bytes() / 1e9 / save_s,
           "restore_gb_s": man.total_bytes() / 1e9 / restore_s,
           "launches": launches}
    return rec, whole


def checkpoint_run(pa, card, kv_dtype):
    """Phase 3c's checkpoint: the 8 turn-1 requests through the README
    server's scheduler, cut mid-generation with ``checkpoint_kv`` and
    finished by a fresh scheduler on the card after ``restore_kv``."""
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype)

    def make(name):
        return DecodeScheduler(model, name=name, kv_dtype=kv_dtype,
                               **README_SERVER)
    rec, _ = _cut_and_restore(pa, make, turn1_prompts(), NEW_TOKENS,
                              kv_dtype + " checkpoint", kv_dtype)
    rec["card"] = card
    _log("e2e %s: %d sessions cut mid-generation; checkpoint %d bytes, "
         "save %.4f s, restore %.4f s; every restored session emitted the "
         "uninterrupted run's tokens; launches after the restore %s [%s]"
         % (rec["label"], rec["sessions"], rec["checkpoint_bytes"],
            rec["save_s"], rec["restore_s"], rec["launches"], card))
    return rec


def migration_run(pa, card, kv_dtype):
    """Phase 3c's migration: a burst of 8 on server A, exported
    mid-generation over ``POST /admin/sessions/export``, imported on
    server B, released on A; every client is answered 307 at A and its
    follow-up with its ``session_id`` completes on B with the oracle's
    tokens, nothing answered twice or lost."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    label = kv_dtype + " migration"
    prompts = turn1_prompts()
    sids = ["m%d" % i for i in range(len(prompts))]
    model_a = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype)
    model_a.step_host_delay = MIGRATE_STEP_DELAY
    model_b = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype)
    a = InferenceServer({"flagship": model_a}, kv_dtype=kv_dtype,
                        enable_admin=True, **README_SERVER)
    b = InferenceServer({"flagship": model_b}, kv_dtype=kv_dtype,
                        enable_admin=True, **README_SERVER)
    first = {}

    def client(i):
        first[sids[i]] = _post_json(
            a.url + "/api/flagship/generate",
            {"prompt": prompts[i], "max_new_tokens": NEW_TOKENS,
             "session_id": sids[i]})
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        _wait_rows(a.registry.get("flagship").scheduler, len(prompts))
        t0 = time.perf_counter()
        status, exp, _ = _post_json(a.url + "/admin/sessions/export", {})
        export_s = time.perf_counter() - t0
        if status != 200 or exp["count"] != len(prompts) or not all(
                s.get("kv_k") for s in exp["sessions"]):
            raise AssertionError("%s: export caught %s of %d sessions "
                                 "mid-generation" % (label, exp.get("count"),
                                                     len(prompts)))
        wire = [len(json.dumps(s)) for s in exp["sessions"]]
        _reset_launches(pa)
        t0 = time.perf_counter()
        status, imp, _ = _post_json(b.url + "/admin/sessions/import",
                                    {"sessions": exp["sessions"]})
        import_s = time.perf_counter() - t0
        if status != 200 or imp["errors"] or \
                sorted(imp["imported"]) != sorted(sids):
            raise AssertionError("%s: import answered %d %s"
                                 % (label, status, imp))
        status, rel, _ = _post_json(a.url + "/admin/sessions/release",
                                    {"session_ids": imp["imported"],
                                     "target": b.url})
        for t in threads:
            t.join(600)
        follow = {}
        for sid, prompt in zip(sids, prompts):
            code, body, headers = first[sid]
            if code != 307 or headers["X-Veles-Migrated"] != sid:
                raise AssertionError("%s: %s was answered %d at the "
                                     "source" % (label, sid, code))
            follow[sid] = _post_json(
                b.url + "/api/flagship/generate",
                {"prompt": prompt, "max_new_tokens": NEW_TOKENS,
                 "session_id": sid}, {"X-Veles-Attach": "1"})
        launches = _read_launches(pa, label, kv_dtype)
        traces = migration_timelines(label, first, sids)
        again = _post_json(a.url + "/admin/sessions/release",
                           {"session_ids": sids})[1]["released"]
        listed_a = _get_json(a.url + "/admin/sessions")["sessions"][
            "flagship"]
        listed_b = _get_json(b.url + "/admin/sessions")["sessions"][
            "flagship"]
    finally:
        a.stop()
        b.stop()
    if any(follow[sid][0] != 200 for sid in sids):
        raise AssertionError("%s: follow-ups answered %s" % (
            label, [follow[sid][0] for sid in sids]))
    if again or listed_a["migrating"] or listed_a["active"] or \
            listed_b["active"] or sorted(listed_b["finished"]) != sorted(
                sids):
        raise AssertionError("%s: a session was answered twice or lost "
                             "(A %s, B %s, second release %s)"
                             % (label, listed_a, listed_b, again))
    got = [follow[sid][1]["tokens"] for sid in sids]
    if kv_dtype == "f32":
        want = _card_oracle([(p, NEW_TOKENS) for p in prompts])
        oracle = "cache-free generate_reference on the card"
    else:
        want = _cpu_tokens(dict(README_MODEL, kv_dtype=kv_dtype), prompts,
                           kv_dtype)
        oracle = "the same model on the CPU"
    _held(label, got, want, oracle)
    rec = {"label": label, "kv_dtype": kv_dtype, "card": card,
           "sessions": len(sids), "export_ms_per_session":
               1e3 * export_s / len(sids),
           "import_ms_per_session": 1e3 * import_s / len(sids),
           "wire_bytes_per_session": statistics.mean(wire),
           "wire_bytes": wire, "launches": launches, "oracle": oracle,
           "flight": traces}
    _log("e2e %s: %d sessions moved mid-generation from server A to B "
         "over /admin/sessions; export %.3f ms and import %.3f ms a "
         "session (HTTP included), %.0f wire bytes a session; every "
         "client answered 307 at A and 200 at B; launches on B %s; tokens "
         "equal %s [%s]"
         % (label, len(sids), rec["export_ms_per_session"],
            rec["import_ms_per_session"], rec["wire_bytes_per_session"],
            launches, oracle, card))
    return rec


def real_pools(torch, dev, kv_dtype, seed, geometry=REAL_POOL,
               on_host=False):
    """(k_pools, v_pools) of 2 stages at ``geometry`` on ``dev``, in the
    flagship's layout, filled from ``seed`` (int8: random bytes and
    positive scales) by ``dev``'s generator, or with ``on_host`` by the
    CPU's and copied (the same values on any device)."""
    nb, bs, h, hd = geometry
    src = torch.device("cpu") if on_host else dev
    gen = torch.Generator(device=src).manual_seed(seed)

    def pool():
        if kv_dtype == "int8":
            made = {"q": torch.randint(-127, 128, (nb, bs, h, hd),
                                       generator=gen, device=src,
                                       dtype=torch.int8),
                    "s": torch.rand((nb, h), generator=gen, device=src)}
            return {key: t.to(dev) for key, t in made.items()}
        return torch.randn((nb, bs, h, hd), generator=gen,
                           device=src).to(dev)
    return (pool(), pool()), (pool(), pool())


def tier_round_trip(torch, dev, kv_dtype, geometry, blocks, store,
                    seed=0, on_host=False):
    """Demote each of ``blocks`` of seeded pools on ``dev``
    (:func:`real_pools`) into ``store`` (gather to the host,
    ``pack_block``, put) and readmit it into another block (get,
    ``unpack_block``, scatter), as the scheduler does.  -> (the wire
    bytes of each block, the pools' leaves on the host afterwards,
    per-step seconds of each block).  The readmitted block must equal
    the demoted one bit for bit."""
    from veles_tpu_torch.serving.decode import (_gather, _host_tensors,
                                                _leaves, _scatter)
    from veles_tpu_torch.serving.sessions import pack_block, unpack_block
    k, v = real_pools(torch, dev, kv_dtype, seed, geometry, on_host)
    nb = geometry[0]
    wires, steps = [], []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for i, block in enumerate(blocks):
        key = b"block-%d" % block
        dst = nb - 1 - i
        t = [time.perf_counter()]
        payload = {"kv_k": _gather(k, block), "kv_v": _gather(v, block)}
        t.append(time.perf_counter())
        data = pack_block(payload)
        t.append(time.perf_counter())
        store.demote(key, data)
        t.append(time.perf_counter())
        tier, got = store.lookup(key)
        t.append(time.perf_counter())
        back = unpack_block(got)
        t.append(time.perf_counter())
        _scatter(k, dst, _host_tensors(k, back["kv_k"], (), "a block"))
        _scatter(v, dst, _host_tensors(v, back["kv_v"], (), "a block"))
        sync()
        t.append(time.perf_counter())
        steps.append([b - a for a, b in zip(t, t[1:])])
        wires.append(data)
        for leaf in _leaves(k) + _leaves(v):
            if not torch.equal(leaf[dst], leaf[block]):
                raise AssertionError("block %d readmitted from the %s tier "
                                     "differs from the demoted one"
                                     % (block, tier))
    host = [leaf.cpu().numpy() for leaf in _leaves(k) + _leaves(v)]
    return wires, host, steps


#: the steps of one block's round trip, as tier_round_trip times them
ROUND_TRIP_STEPS = ("gather", "pack_block", "put", "get", "unpack_block",
                    "scatter")


def _save_load(torch, dev, kv_dtype, tmp):
    """``save_state`` / ``load_state`` of seeded pools at REAL_POOL; the
    loaded leaves must equal the saved ones bit for bit.  Then two of
    the save's steps timed alone on the same pools: the copy to the
    host and the sha256 of its 16 MiB bands."""
    from veles_tpu_torch.checkpoint import load_state, save_state
    from veles_tpu_torch.checkpoint.store import digest_of
    from veles_tpu_torch.serving.decode import _leaves
    k, v = real_pools(torch, dev, kv_dtype, seed=1)
    leaves = _leaves(k) + _leaves(v)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_state(tmp, "pools-" + kv_dtype, {"k": k, "v": v})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_state(path)
    load_s = time.perf_counter() - t0
    got = _leaves(back["k"]) + _leaves(back["v"])
    if len(got) != len(leaves) or not all(
            torch.equal(leaf.cpu(), torch.from_numpy(arr))
            for leaf, arr in zip(leaves, got)):
        raise AssertionError("%s pools restored by load_state differ from "
                             "the saved ones" % kv_dtype)
    shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    host = [leaf.to("cpu", copy=True).numpy() for leaf in leaves]
    copy_s = time.perf_counter() - t0
    band = 16 << 20
    t0 = time.perf_counter()
    for arr in host:
        flat = arr.reshape(-1).view(numpy.uint8)
        for start in range(0, flat.size, band):
            digest_of(flat[start:start + band])
    hash_s = time.perf_counter() - t0
    return {"kv_dtype": kv_dtype, "bytes": nbytes, "save_s": save_s,
            "load_s": load_s, "save_gb_s": nbytes / 1e9 / save_s,
            "load_gb_s": nbytes / 1e9 / load_s, "bitwise": True,
            "copy_to_host_s": copy_s, "sha256_s": hash_s}


def realistic_tiers(torch, pa, card, dev):
    """Phase 3c at phase 2's long-context pool: ``save_state`` /
    ``load_state`` of f32 and int8 pools (bitwise, GB/s); one block's
    demote and readmit through the host and the disk tier, step by step
    (the card's wire bytes must equal the CPU's on a small pool); and a
    ``checkpoint_kv`` / ``restore_kv`` of 8 sessions whose blocks spread
    over the 4096-block pool."""
    from veles_tpu_torch.kvtier import TieredKVStore
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    out = {"geometry": list(REAL_POOL), "card": card, "save_load": [],
           "round_trip": []}
    for kv_dtype in ("f32", "int8"):
        rec = _save_load(torch, dev, kv_dtype,
                         tempfile.mkdtemp(prefix="veles-pools-"))
        out["save_load"].append(rec)
        _log("realistic %s pools (%d bytes): save_state %.3f s = %.2f "
             "GB/s (alone: the copy to the host %.3f s, sha256 %.3f s), "
             "load_state %.3f s = %.2f GB/s, restored bitwise [%s]"
             % (kv_dtype, rec["bytes"], rec["save_s"], rec["save_gb_s"],
                rec["copy_to_host_s"], rec["sha256_s"], rec["load_s"],
                rec["load_gb_s"], card))
        blocks = list(range(1, REAL_POOL[0] - REAL_TIER_BLOCKS,
                            REAL_POOL[0] // REAL_TIER_BLOCKS))
        for tier in ("host", "disk"):
            tmp = tempfile.mkdtemp(prefix="veles-kvtier-")
            store = (TieredKVStore(host_bytes=1 << 34) if tier == "host"
                     else TieredKVStore(disk_dir=tmp))
            wires, _, steps = tier_round_trip(torch, dev, kv_dtype,
                                              REAL_POOL, blocks, store)
            shutil.rmtree(tmp, ignore_errors=True)
            med = {name: 1e3 * statistics.median(s[i] for s in steps)
                   for i, name in enumerate(ROUND_TRIP_STEPS)}
            rec = {"kv_dtype": kv_dtype, "tier": tier,
                   "blocks": len(blocks), "wire_bytes": len(wires[0]),
                   "step_ms_p50": med,
                   "demote_ms_p50": 1e3 * statistics.median(
                       sum(s[:3]) for s in steps),
                   "readmit_ms_p50": 1e3 * statistics.median(
                       sum(s[3:]) for s in steps)}
            out["round_trip"].append(rec)
            _log("realistic %s %s tier: one block (%d wire bytes) demotes "
                 "in %.3f ms and readmits in %.3f ms (p50 of %d; steps "
                 "%s ms), bitwise [%s]"
                 % (kv_dtype, tier, rec["wire_bytes"],
                    rec["demote_ms_p50"], rec["readmit_ms_p50"],
                    len(blocks), {k: round(x, 4) for k, x in med.items()},
                    card))
        # the same round trip on the CPU gives the card's bytes
        small = (64, 16, 8, 128)
        pair = [tier_round_trip(torch, d, kv_dtype, small, [3, 17],
                                TieredKVStore(host_bytes=1 << 30),
                                on_host=True)
                for d in (dev, torch.device("cpu"))]
        if pair[0][0] != pair[1][0] or not all(
                numpy.array_equal(a, b)
                for a, b in zip(pair[0][1], pair[1][1])):
            raise AssertionError("%s: a block's round trip on the card "
                                 "differs from the CPU's" % kv_dtype)
    # checkpoint_kv of 8 sessions over the 4096-block pool (heads 8,
    # head dim 128: d 1024)
    nb, bs, h, hd = REAL_POOL
    model = FlagshipDecodeModel(stages=2, experts=2, d=h * hd, heads=h,
                                hidden=1024, vocab=1024, seed=0)
    rng = numpy.random.RandomState(16)
    prompts = [rng.randint(0, 1024, REAL_PROMPT).tolist()
               for _ in range(REAL_SESSIONS)]

    def make(name):
        return DecodeScheduler(model, name=name, max_batch=REAL_SESSIONS,
                               block_size=bs, max_prompt_len=REAL_PROMPT,
                               max_new_tokens=REAL_NEW, num_blocks=nb)
    rec, _ = _cut_and_restore(pa, make, prompts, REAL_NEW,
                              "realistic checkpoint", "f32")
    out["checkpoint_kv"] = rec
    _log("realistic checkpoint_kv: %d sessions of %d tokens cut "
         "mid-generation over a %d-block pool: %d bytes (%d in distinct "
         "chunks), save %.3f s = %.2f GB/s, "
         "restore %.3f s = %.2f GB/s; every restored session emitted the "
         "uninterrupted run's tokens [%s]"
         % (rec["sessions"], REAL_PROMPT, nb, rec["checkpoint_bytes"],
            rec["unique_chunk_bytes"], rec["save_s"], rec["save_gb_s"],
            rec["restore_s"], rec["restore_gb_s"], card))
    return out


def tiers_phase(torch, pa, card, dev, options):
    """Phase 3c: tiers, checkpoint and migration at the README widths in
    f32 (K1) and int8 (K2 and the append), then the realistic pool.
    ``options``: phase 3b's runs, whose TTFT are printed beside."""
    out = {"tiers": [], "checkpoint": [], "migration": []}
    for kv_dtype in ("f32", "int8"):
        tiers = tier_run(pa, card, kv_dtype)
        hbm = next(r for r in options if r["kv_dtype"] == kv_dtype
                   and r["options"])
        _log("e2e %s: TTFT p50 of turn 2 from the tiers %.1f ms (turn 1 "
             "%.1f ms); phase 3b's turn 2 from HBM %.1f ms (turn 1 %.1f ms, "
             "with speculation and a full-size pool) [%s]"
             % (kv_dtype, tiers["ttft_p50_ms"][1], tiers["ttft_p50_ms"][0],
                hbm["ttft_p50_ms"][1], hbm["ttft_p50_ms"][0], card))
        out["tiers"].append(tiers)
        out["checkpoint"].append(checkpoint_run(pa, card, kv_dtype))
        out["migration"].append(migration_run(pa, card, kv_dtype))
    out["realistic"] = realistic_tiers(torch, pa, card, dev)
    return out


# -- phase 3d: the flight recorder, the classifier route, the fleet -----------

#: the fleet's stand-in models: the toy decoder (tokens with a host
#: oracle) and the per-row sleep classifier
FLEET_TOY = ("toydecode:vocab=64,block=4,max_batch=4,max_prompt=16,"
             "max_new=8,num_blocks=32")
FLEET_SLEEP = "sleep:0.002"
FLEET_BACKOFF = {"base": 0.1, "factor": 2.0, "cap": 2.0, "max_restarts": 10}
#: answers before the SIGKILL, and after the respawn, in the fleet burst
FLEET_ANSWERS = 32
#: the classifier burst: clients, requests a client, rows a request
CLASSIFIER_CLIENTS, CLASSIFIER_REQUESTS, CLASSIFIER_ROWS = 8, 16, (1, 60)
#: a served row against the workflow's own forward of it, of its scale
CLASSIFIER_TOL = 1e-6
#: the profiled MNIST run (apart from the timed ones: the fence costs)
PROFILE_EPOCHS = 2


def burst_timelines(url, answers, label):
    """``GET /api/flagship/requests`` after a burst whose ring was reset
    just before it: one closed timeline a request, each ``ok`` with
    ``first_token`` and a ``retire`` of as many tokens as its answer;
    -> record with the attribution report by phase."""
    from veles_tpu_torch.observability import attribution
    tls = _get_json(url + "/api/flagship/requests")["requests"]
    retired = []
    for tl in tls:
        kinds = [e["kind"] for e in tl["events"]]
        retire = [e for e in tl["events"] if e["kind"] == "retire"]
        if tl["status"] != "ok" or "finished_unix" not in tl or \
                "first_token" not in kinds or len(retire) != 1:
            raise AssertionError("%s: a timeline is not closed ok: %s"
                                 % (label, kinds))
        retired.append(retire[0]["tokens"])
    if sorted(retired) != sorted(len(a["tokens"]) for a in answers):
        raise AssertionError("%s: %d timelines retired %s tokens for %d "
                             "answers" % (label, len(tls), retired,
                                          len(answers)))
    group = ("model", "kv_dtype")
    agg = attribution.aggregate(tls, group_by=group)
    _log("3d %s: %d closed timelines at GET /api/flagship/requests, "
         "attribution by phase:\n%s"
         % (label, len(tls), attribution.render_report(agg, group)))
    return {"timelines": len(tls), "attribution": agg}


def migration_timelines(label, first, sids):
    """Each migrated session keeps its client's trace id: one timeline
    under it holds ``migrate.export`` (server A) before
    ``migrate.import`` (server B) and a ``retire`` on B; -> record."""
    from veles_tpu_torch.observability.flight import RECORDER
    out = {}
    for sid in sids:
        tid = first[sid][2]["X-Trace-Id"]
        tls = RECORDER.snapshot(trace_id=tid)
        kinds = [e["kind"] for e in tls[0]["events"]] if tls else []
        if len(tls) != 1 or "retire" not in kinds or \
                "migrate.export" not in kinds or \
                "migrate.import" not in kinds or \
                kinds.index("migrate.export") > \
                kinds.index("migrate.import") or tls[0]["status"] != "ok":
            raise AssertionError("%s: %s's trace %s is not one migrated "
                                 "timeline: %s" % (label, sid, tid, kinds))
        out[sid] = {"trace_id": tid, "events": len(kinds),
                    "anomalies": tls[0]["anomalies"]}
    _log("3d %s: every session kept its trace id across the move; each "
         "timeline holds migrate.export then migrate.import (%s events)"
         % (label, sorted(v["events"] for v in out.values())))
    return out


def recorder_cost(pa, card, want, device=None):
    """Phase 3's f32 burst on fresh servers with the recorder on, off,
    off, on (``RECORDER.configure(enabled=...)``): tok/s and decode step
    p50 of each, the answers equal to phase 3's; -> record.  ``device``:
    the card unless the CPU is asked for (a rehearsal)."""
    from veles_tpu_torch.observability.flight import RECORDER
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(**README_MODEL, device=device)
    prompts = _prompts()
    runs = []
    try:
        for enabled in (True, False, False, True):
            RECORDER.reset()
            RECORDER.configure(enabled=enabled)
            server = InferenceServer({"flagship": model}, device=device,
                                     **README_SERVER)
            try:
                pa.paged_attention.launches = 0
                answers, seconds = _post_all(server.url, prompts)
                launches = pa.paged_attention.launches
                metrics = _get_json(server.url + "/metrics")["flagship"]
            finally:
                server.stop()
            if [a["tokens"] for a in answers] != want:
                raise AssertionError("recorder %s: answers differ from "
                                     "phase 3's" % enabled)
            if launches <= 0:
                raise AssertionError("the recorder burst ran no K1")
            tokens = sum(len(a["tokens"]) for a in answers)
            runs.append({"recorder": enabled, "seconds": seconds,
                         "tok_s": tokens / seconds,
                         "step_ms_p50": metrics["step_latency"]["p50_ms"],
                         "timelines": RECORDER.stats()["timelines"],
                         "k1_launches": launches})
    finally:
        RECORDER.configure(enabled=True)
    if [r["timelines"] for r in runs] != [len(prompts), 0, 0, len(prompts)]:
        raise AssertionError("the recorder switch did not hold: %s" % runs)
    mean = {on: {key: statistics.mean(r[key] for r in runs
                                      if r["recorder"] == on)
                 for key in ("tok_s", "step_ms_p50")}
            for on in (True, False)}
    _log("3d recorder cost, f32 burst (on, off, off, on): tok/s %s; "
         "decode step p50 ms %s; mean on %.1f tok/s %.3f ms, off %.1f "
         "tok/s %.3f ms; K1 launches %s [%s]"
         % (" ".join("%.1f" % r["tok_s"] for r in runs),
            " ".join("%s" % r["step_ms_p50"] for r in runs),
            mean[True]["tok_s"], mean[True]["step_ms_p50"],
            mean[False]["tok_s"], mean[False]["step_ms_p50"],
            [r["k1_launches"] for r in runs], card))
    return {"runs": runs, "on": mean[True], "off": mean[False],
            "card": card}


def classifier_run(torch, gemm, card, wf):
    """Phase 4's ``precise_gemm=1`` MNIST, trained, served on the card
    through ``POST /api/mnist``: 8 concurrent clients send requests of
    1-60 of its own images; every answer within ``CLASSIFIER_TOL`` of
    its scale of the workflow's own forward of those rows, K4 launched
    by the burst, every bucket warm; -> record."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.serving.scheduler import bucket_sizes, forward_fn
    data = wf.loader.original_data.map_read()
    data = data.reshape(data.shape[0], -1)
    rng = numpy.random.RandomState(21)
    requests = []
    for _ in range(CLASSIFIER_CLIENTS * CLASSIFIER_REQUESTS):
        rows = int(rng.randint(CLASSIFIER_ROWS[0], CLASSIFIER_ROWS[1] + 1))
        lo = int(rng.randint(0, data.shape[0] - rows))
        requests.append((lo, rows))
    dev = wf.fused_step._dev_           # served where it trained
    fwd = forward_fn(wf.forwards)
    params = [f.params for f in wf.forwards]
    with torch.no_grad():
        want = [fwd(params, torch.from_numpy(numpy.ascontiguousarray(
            data[lo:lo + rows])).to(dev)).cpu().numpy()
            for lo, rows in requests]
    server = InferenceServer({"mnist": wf}, device=dev)
    sched = server.registry.get("mnist").scheduler
    answers = [None] * len(requests)
    errors = []

    def client(c):
        for i in range(c, len(requests), CLASSIFIER_CLIENTS):
            lo, rows = requests[i]
            try:
                code, body, _ = _post_json(
                    server.url + "/api/mnist",
                    {"input": data[lo:lo + rows].tolist()})
                if code != 200:
                    raise RuntimeError("answered %d: %s" % (code, body))
                answers[i] = numpy.asarray(body["output"], numpy.float32)
            except Exception as exc:  # noqa: BLE001 — raised below
                errors.append(exc)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLASSIFIER_CLIENTS)]
    try:
        stats = sched.stats()
        gemm.precise_matmul.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        seconds = time.perf_counter() - t0
        launches = gemm.precise_matmul.launches
        metrics = sched.metrics.snapshot()
    finally:
        server.stop()
    if errors or any(a is None for a in answers):
        raise AssertionError("classifier requests failed: %r" % errors[:3])
    errs = [float((numpy.abs(a - w) /
                   numpy.abs(w).max(axis=1, keepdims=True)).max())
            for a, w in zip(answers, want)]
    bitwise = sum(bool(numpy.array_equal(a, w))
                  for a, w in zip(answers, want))
    if max(errs) > CLASSIFIER_TOL:
        raise AssertionError("classifier: a served row is %.3g of its "
                             "scale off its forward (limit %g)"
                             % (max(errs), CLASSIFIER_TOL))
    if launches <= 0:
        raise AssertionError("the classifier burst launched no K4")
    if stats["buckets"] != bucket_sizes(stats["max_batch"]) or \
            stats["executables"] != len(stats["buckets"]) or \
            stats["device"] != str(sched.device):
        raise AssertionError("classifier: not every bucket warm: %s"
                             % stats)
    rows = sum(r for _, r in requests)
    rec = {"card": card, "requests": len(requests), "rows": rows,
           "seconds": seconds, "requests_s": len(requests) / seconds,
           "rows_s": rows / seconds, "max_rel_err": max(errs),
           "bitwise_answers": bitwise, "k4_launches": launches,
           "buckets": stats["buckets"], "batches": metrics["batches"],
           "batch_fill": metrics["batch_fill"],
           "latency": metrics["latency"]}
    _log("3d classifier POST /api/mnist (precise_gemm=1, trained): %d "
         "requests of %d-%d rows from %d clients, %d rows in %.3f s = "
         "%.1f requests/s, %.0f rows/s; max |served - forward| %.3g of "
         "the row's scale (limit %g), %d of %d answers bitwise; %d "
         "batches, fill %s; K4 launches %d; buckets %s warm; latency p50 "
         "%s ms p99 %s ms [%s]"
         % (len(requests), CLASSIFIER_ROWS[0], CLASSIFIER_ROWS[1],
            CLASSIFIER_CLIENTS, rows, seconds, rec["requests_s"],
            rec["rows_s"], max(errs), CLASSIFIER_TOL, bitwise,
            len(requests), metrics["batches"], metrics["batch_fill"],
            launches, stats["buckets"], metrics["latency"]["p50_ms"],
            metrics["latency"]["p99_ms"], card))
    return rec


def _build_dir_state():
    from veles_tpu_torch import _build
    return sorted((p.name, p.stat().st_mtime_ns)
                  for p in _build.BUILD_DIR.glob("*"))


def _cache_counters(fleet):
    """{replica: {model: [compiles, cache_hits]}} over the router's
    merged ``GET /metrics``: the ``nvcc`` runs of each scheduler's
    warmup and the kernel libraries it found in the build cache."""
    out = {}
    for rid, body in fleet.router.merged_metrics()["replicas"].items():
        out[rid] = {model: [stats.get("compiles"), stats.get("cache_hits")]
                    for model, stats in body.items()
                    if isinstance(stats, dict)}
    return out


def fleet_run(card, device=None, cache_dir=None):
    """Two replicas on the card behind the router, serving the toy
    decoder and the sleep classifier, sharing the build cache at
    ``cache_dir`` (when given); a burst, one replica SIGKILLed in the
    middle of it: nothing fails, every token is bitwise the toy's
    ``generate_reference``, the victim respawns ready with the build
    directory unchanged and, with the cache, its schedulers' warmups
    built nothing and found every kernel library in the cache (the
    counters over ``GET /metrics`` before and after the respawn; the
    stand-ins launch no hand kernel, but each replica loads every
    library at its warmup), and ``GET /fleet/requests`` merges the
    router's and the replica's halves of a request under one trace id;
    -> record.  ``device``: the replicas' (the card unless the CPU is
    asked for, a rehearsal)."""
    import signal
    from veles_tpu_torch.fleet import Fleet
    from veles_tpu_torch.serving import ToyDecodeModel
    prompts = [[3, 1, 2], [9, 8, 7, 6], [5, 5, 5], [1, 2, 3, 4, 5]]
    oracle = ToyDecodeModel(vocab=64, device="cpu")
    want = [oracle.generate_reference(p, 6) for p in prompts]
    t0 = time.perf_counter()
    fleet = Fleet({"toy": FLEET_TOY, "m": FLEET_SLEEP}, replicas=2,
                  poll_interval=0.1, backoff=FLEET_BACKOFF, device=device,
                  cache_dir=cache_dir)
    counts = {"ok": 0, "shed": 0, "failed": 0, "mismatch": 0}
    lock = threading.Lock()
    done = threading.Event()
    failures = []

    def client(i):
        decode = i % 2 == 0
        route = "/api/toy/generate" if decode else "/api/m"
        payload = ({"prompt": prompts[i // 2 % 4], "max_new_tokens": 6}
                   if decode else {"input": [[0.5] * 4] * (1 + i % 4)})
        while not done.is_set():
            for _ in range(50):           # a client retries 503
                code, body, _ = _post_json(fleet.url + route, payload,
                                           timeout=120)
                if code != 503:
                    break
                time.sleep(0.05)
            with lock:
                if code == 200:
                    counts["ok"] += 1
                    if decode and body["tokens"] != want[i // 2 % 4]:
                        counts["mismatch"] += 1
                elif code == 429:
                    counts["shed"] += 1
                else:
                    counts["failed"] += 1
                    failures.append((code, body))

    def wait(predicate, timeout, what):
        end = time.monotonic() + timeout
        while not predicate():
            if time.monotonic() > end:
                raise AssertionError("fleet: timed out waiting for " + what)
            time.sleep(0.02)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        fleet.start(ready_timeout=600)
        wait(lambda: fleet.router.ready_count() == 2, 300, "both ready")
        start_s = time.perf_counter() - t0
        victim = fleet.router.replica_ids()[-1]
        built = _build_dir_state()
        counters_before = _cache_counters(fleet)
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        wait(lambda: counts["ok"] >= FLEET_ANSWERS, 300, "the burst")
        fleet.supervisor.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        wait(lambda: fleet.supervisor.describe()[victim]["restarts"] >= 1,
             300, "the supervisor to see the death")
        wait(lambda: fleet.router.ready_count() == 2, 600, "the respawn")
        respawn_s = time.perf_counter() - t_kill
        counters_after = _cache_counters(fleet)
        ok_at = counts["ok"]
        wait(lambda: counts["ok"] >= ok_at + FLEET_ANSWERS, 300,
             "answers after the respawn")
        done.set()
        for t in threads:
            t.join(300)
        burst_s = time.perf_counter() - t_burst
        rebuilt = _build_dir_state() != built
        code, body, headers = _post_json(
            fleet.url + "/api/toy/generate",
            {"prompt": prompts[0], "max_new_tokens": 6})
        tid = headers["X-Trace-Id"]
        frags = _get_json(fleet.url + "/fleet/requests?id=" + tid)[
            "requests"][tid]
        dispatched = {rid: v["dispatched"] for rid, v in
                      fleet.router.merged_metrics()["router"][
                          "replicas"].items()}
        desc = fleet.supervisor.describe()
    finally:
        done.set()
        fleet.stop()
    halves = {tl.get("replica"): [e["kind"] for e in tl["events"]]
              for tl in frags}
    if counts["failed"] or counts["mismatch"] or code != 200 or \
            body["tokens"] != want[0]:
        raise AssertionError("fleet: %s, failures %s" % (counts,
                                                         failures[:3]))
    if rebuilt:
        raise AssertionError("fleet: the respawn built a kernel")
    on_card = fleet.supervisor.device.type == "cuda"
    if cache_dir and on_card and (
            not counters_after.get(victim) or
            any(c != 0 or not h
                for c, h in counters_after[victim].values())):
        raise AssertionError("fleet: the respawned replica's warmup built "
                             "a kernel or found none in the cache: %s"
                             % counters_after)
    replica = [r for r in halves if r != "router"]
    if "router.dispatch" not in halves.get("router", ()) or \
            len(replica) != 1 or \
            not {"queue.enter", "first_token", "retire"} <= set(
                halves[replica[0]]):
        raise AssertionError("fleet: /fleet/requests did not merge one "
                             "trace: %s" % halves)
    rec = {"card": card, "answers": counts, "burst_s": burst_s,
           "respawn_s": respawn_s, "start_s": start_s,
           "restarts": desc[victim]["restarts"], "dispatched": dispatched,
           "trace_halves": sorted(halves), "victim": victim,
           "cache_dir": bool(cache_dir),
           "cache_counters_before": counters_before,
           "cache_counters_after": counters_after}
    _log("3d fleet (2 replicas on %s; %s and %s): started ready in "
         "%.2f s; burst of %d answers (%d decode and classifier clients), "
         "%d shed, 0 failed, every token equal to generate_reference, in "
         "%.2f s; %s SIGKILLed mid-burst, respawned ready in %.2f s "
         "with the build directory unchanged (the stand-ins launch no "
         "hand kernel); build cache %s, [compiles, cache hits] of each "
         "replica's schedulers over /metrics before %s, after the "
         "respawn %s; dispatched %s; trace %s merged from %s [%s]"
         % (fleet.supervisor.device, FLEET_TOY, FLEET_SLEEP, start_s,
            counts["ok"], len(threads),
            counts["shed"], burst_s, victim, respawn_s,
            "shared" if cache_dir else "off", counters_before,
            counters_after, dispatched, tid, sorted(halves), card))
    return rec


def profiler_run(torch, gemm, card, device="cuda"):
    """A separate 2-epoch MNIST run with ``precise_gemm=1`` under
    ``Workflow.attach_profiler`` (its fence costs time, so no timed run
    carries it): the data-wait / host / device shares; -> record."""
    wf = _mnist_workflow(1, device=device, epochs=PROFILE_EPOCHS)
    prof = wf.attach_profiler()
    gemm.precise_matmul.launches = 0
    wf.run()
    wf.fused_step.device.sync()
    launches = gemm.precise_matmul.launches
    summary = prof.summary()
    prof.detach()
    if launches <= 0 or summary["steps"] <= 0 or \
            summary["recompiles"] != 0:
        raise AssertionError("profiled run: %s, K4 launches %d"
                             % (summary, launches))
    _log("3d StepProfiler, MNIST precise_gemm=1, %d epochs: %d steps, %d "
         "examples, %s examples/s; shares %s; data-wait %.4f s, host "
         "%.4f s, device %.4f s; peak card memory %s; K4 launches %d [%s]"
         % (PROFILE_EPOCHS, summary["steps"], summary["examples"],
            summary.get("examples_per_sec"), summary.get("phase_pct"),
            summary["data_wait_s"], summary["host_s"], summary["device_s"],
            summary.get("device_peak_memory_bytes"), launches, card))
    return dict(summary, k4_launches=launches, card=card)


def flight_phase(torch, pa, gemm, card, runs, migrations, served_wf,
                 cache_dir=None):
    """Phase 3d (slice 15); the fleet shares the build cache at
    ``cache_dir``; -> record."""
    rec = {"timelines": {r["label"]: r["flight"] for r in runs},
           "migration_traces": {m["label"]: m["flight"]
                                for m in migrations}}
    rec["recorder_cost"] = recorder_cost(pa, card, runs[0]["answers"])
    rec["classifier"] = classifier_run(torch, gemm, card, served_wf)
    rec["fleet"] = fleet_run(card, cache_dir=cache_dir)
    rec["profiler"] = profiler_run(torch, gemm, card)
    by_label = {r["label"]: r["launches"] for r in runs}
    rec["launches"] = {
        "K1 (f32 burst, timelines)": by_label["f32"]["paged_attention"],
        "K1 (recorder bursts)": sum(r["k1_launches"] for r in
                                    rec["recorder_cost"]["runs"]),
        "K2 (int8-kv burst, timelines)":
            by_label["int8-kv"]["paged_attention"],
        "K3 (int8-weights burst, timelines)":
            by_label["int8-weights"]["quantized_matmul"],
        "K4 (classifier)": rec["classifier"]["k4_launches"],
        "K4 (profiled run)": rec["profiler"]["k4_launches"]}
    if not all(rec["launches"].values()):
        raise AssertionError("phase 3d: a kernel did not launch: %s"
                             % rec["launches"])
    _log("3d launches: %s" % rec["launches"])
    return rec


# -- phase 3e: the autotuner and the build cache (slice 16) -------------------

#: K1/K2's realistic batch (``paged_cases``): B=32 H=8 D=128, 128 blocks
#: of 16 a row
PAGED_REALISTIC = {"batch": 32, "heads": 8, "d": 128, "block_size": 16,
                   "max_blocks": 128}
#: (label, site, ctx) of the sites phase 3e tunes on the card
TUNE_CASES = (
    ("MNIST 784->100", "precise_gemm",
     {"m": 60, "k": 784, "n": 100, "level": 1}),
    ("4096^3", "precise_gemm", {"m": 4096, "k": 4096, "n": 4096,
                                "level": 1}),
    ("realistic f32", "paged_attention",
     dict(PAGED_REALISTIC, quantized=False)),
    ("realistic int8", "paged_attention",
     dict(PAGED_REALISTIC, quantized=True)),
    ("AlexNet LRN1", "lrn", {"rows": 387200, "c": 96, "n": 5}),
    ("B=8 T=2048 H=8 D=64", "flash_attention",
     {"b": 8, "t": 2048, "h": 8, "d": 64, "causal": False}),
    ("phase 3b model and server", "serving.prefill_chunk",
     {"flagship": README_MODEL, "server": README_SERVER,
      "max_prompt_len": README_SERVER["max_prompt_len"],
      "long_prompts": 2, "new_tokens": 4}))
#: the hard cap of one site's tuning subprocess, seconds
TUNE_TIMEOUT = 240
#: MNIST train steps the fresh process takes with the tuned K4 split
RESTART_STEPS = 2


def tune_phase(card, tune_dir, cache_dir, cases=TUNE_CASES,
               device="cuda"):
    """Tune each case's site into ``tune_dir``: its candidates in one
    isolated subprocess (the build cache at ``cache_dir``) under
    ``TUNE_TIMEOUT``; -> [record] with the default's and the winner's
    times.  A site with no gated winner fails the phase."""
    from veles_tpu_torch.autotune import runner, space
    from veles_tpu_torch.autotune.store import TuningStore
    store = TuningStore(tune_dir)
    # the probes measure the plans they are given against the defaults:
    # no tuning directory of their own, the build cache shared
    env = _restart_env(cache_dir, None)
    out = []
    for label, site, ctx in cases:
        ctx = dict(ctx, device=device)
        t0 = time.perf_counter()
        lines = []
        record = runner.tune_site(site, ctx, store=store,
                                  timeout=TUNE_TIMEOUT, env=env,
                                  batch=True, log_fn=lines.append)
        seconds = time.perf_counter() - t0
        if record is None:
            raise AssertionError("3e tune %s %s: no gated winner:\n%s"
                                 % (site, label, "\n".join(lines)))
        rec = {"label": label, "site": site, "card": card,
               "shape_class": record["shape_class"],
               "default": record["default"], "winner": record["config"],
               "default_ms": 1e3 * record["baseline_s"],
               "winner_ms": 1e3 * record["best_s"],
               "speedup": record["speedup"], "gate": record["gate"],
               "candidates": record["candidates_tried"],
               "viable": record["extra"]["viable"],
               "seconds": seconds,
               "ctx": {k: v for k, v in ctx.items() if k != "device"},
               "candidate_lines": lines}
        out.append(rec)
        _log("3e tune %s (%s, %s): %d candidates, %d passed the gate; "
             "default %s %.4f ms, winner %s %.4f ms (same process, in "
             "turns), speedup %.3fx, gate %s; %.1f s [%s]"
             % (site, label, rec["shape_class"], rec["candidates"],
                rec["viable"], json.dumps(rec["default"], sort_keys=True),
                rec["default_ms"], json.dumps(rec["winner"], sort_keys=True),
                rec["winner_ms"], rec["speedup"], rec["gate"], seconds,
                card))
        if record["gate"] != "passed" or \
                not space.site(site).valid(record["config"], ctx):
            raise AssertionError("3e tune %s: a winner off the gate or the "
                                 "space: %s" % (site, record))
    return out


def hold_tuned_plans(torch, tune_dir, dev):
    """Each tuned kernel plan through the ordinary entry points (the
    tuning directory set) against its plain version, at the limits of
    phase 2: K4 within 1e-6 of max(|a| @ |b|) and bit-equal to the
    rule's split; K1/K2 1e-5; LRN 1e-5 of max(1, max|plain|) (the band
    form, if it won, its site's 2e-4); K7-K9 2e-5 and 5e-4 of max(1,
    max|plain|); -> {label: error}."""
    from veles_tpu_torch.autotune import dispatch
    from veles_tpu_torch.config import root
    from veles_tpu_torch.znicz import flash_attention as fa
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz import lrn as lrn_mod
    from veles_tpu_torch.znicz import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def calls():
        for label, (m, k, n) in (("K4 MNIST", (60, 784, 100)),
                                 ("K4 4096^3", (4096, 4096, 4096))):
            a, b = randn(m, k), randn(k, n)
            rule = gemm._precise_launch(a, b, 1, gemm.split_runs(
                "rule", m, n, k, dev))

            def tuned(a=a, b=b, rule=rule, label=label):
                out = gemm.precise_matmul(a, b, 1)
                if not torch.equal(out, rule):
                    raise AssertionError("3e tuned plan %s: not the bits "
                                         "of the rule's split" % label)
                return out
            yield label, tuned, \
                lambda a=a, b=b: gemm.precise_matmul_reference(a, b, 1), \
                float((a.abs() @ b.abs()).max())
        label, (bb, h, d, bs, nb), lengths = paged_cases()[1]
        for quant in (False, True):
            args, kw, _, _ = _paged_case(torch, pa, dev, bb, h, d, bs, nb,
                                         lengths, quant, 21)
            yield ("K2" if quant else "K1") + " realistic", \
                lambda args=args, kw=kw: pa.paged_attention(*args, **kw), \
                lambda args=args, kw=kw: pa.paged_attention_reference(
                    *args, **kw), 1.0
        x = randn(387200, 96)
        impl = dispatch.resolve("lrn", "c96_n5",
                                default={"impl": "kernel"})[0]["impl"]
        form = lrn_mod.lrn_pair if impl == "kernel" else lrn_mod.lrn_mxu
        yield "LRN AlexNet LRN1 (%s)" % impl, lambda: form(x), \
            lambda: lrn_mod.lrn_reference(x), max(1.0, float(x.abs().max()))

    held = {}
    prior = root.common.autotune.get("dir", None)
    try:
        root.common.autotune.dir = tune_dir
        dispatch.reset_default_stores()
        for label, run, plain, scale in calls():
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) / scale
            tol = 1e-6 if label.startswith("K4") else \
                2e-4 if "(band)" in label else 1e-5
            if not err <= tol:
                raise AssertionError("3e tuned plan %s: error %g > %g"
                                     % (label, err, tol))
            held[label] = err
        q, k, v, do = (0.5 * randn(8, 2048, 8, 64) for _ in range(4))
        err, _, _, _ = _flash_check(torch, fa, q, k, v, do, False, None,
                                    "3e tuned B=8 T=2048 H=8 D=64")
        held["K7-K9 B=8 T=2048 H=8 D=64"] = err
        held["flash tiles"] = fa.flash_tiles(q)
    finally:
        root.common.autotune.dir = prior
        dispatch.reset_default_stores()
    _log("3e tuned kernel plans against their plain versions: %s" % held)
    return held


def _cache_state(cache_dir):
    return sorted(os.listdir(cache_dir))


def _restart_env(cache_dir, tune_dir):
    """The environment of a process started against the build cache and
    the tuning directory (``inject_env``'s variables; ``tune_dir`` None:
    none)."""
    env = dict(os.environ)
    env["VELES_COMPILE_CACHE_DIR"] = cache_dir
    env.pop("VELES_AUTOTUNE_DIR", None)
    if tune_dir:
        env["VELES_AUTOTUNE_DIR"] = tune_dir
    return env


def restart_verdict(rec, before, after):
    """The fresh process's record against the warm-restart contract:
    every tuned site resolved ``"tuned"``, no ``nvcc`` ran, the build
    cache missed nothing and its listing is unchanged, the burst's
    tokens equal the oracle's and the MNIST steps hold to the CPU."""
    faults = []
    untuned = {k: v for k, v in rec["sources"].items() if v != "tuned"}
    if untuned:
        faults.append("sites not resolved tuned: %s" % untuned)
    if rec["nvcc_runs"] or rec["cache"]["misses"]:
        faults.append("%d nvcc runs, %d build-cache misses" % (
            rec["nvcc_runs"], rec["cache"]["misses"]))
    if before != after:
        faults.append("the build cache's listing changed: %s -> %s"
                      % (before, after))
    if rec["chunk_source"] != "tuned":
        faults.append("prefill_chunk_tokens='auto' resolved %s"
                      % rec["chunk_source"])
    if rec["mismatched"]:
        faults.append("answers %s differ from the oracle"
                      % rec["mismatched"])
    if not rec["mnist"]["weights_diff"] <= FIRST_EPOCH_WEIGHT_ATOL:
        faults.append("MNIST weights %g from the CPU's"
                      % rec["mnist"]["weights_diff"])
    if not rec["mnist"]["k4_launches"]:
        faults.append("the MNIST steps launched no K4")
    if faults:
        raise AssertionError("3e fresh process: " + "; ".join(faults))


def fresh_restart(cases_json):
    """The fresh process of phase 3e (started with both directories in
    its environment): resolve every tuned case, serve phase 3's f32
    burst with ``prefill_chunk_tokens="auto"`` and take
    ``RESTART_STEPS`` MNIST steps with ``precise_gemm=1``; prints one
    JSON record (``restart_verdict`` holds it)."""
    import torch
    from veles_tpu_torch import _build
    from veles_tpu_torch.autotune import dispatch, space
    from veles_tpu_torch.compilecache import default_cache
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz.samples.flagship import (
        FlagshipDecodeModel, generate_reference)
    cases = json.loads(cases_json)
    t0 = time.perf_counter()
    _build.load_all()                  # every kernel, off the cache
    sources, configs = {}, {}
    for label, site, ctx in cases:
        sp = space.site(site)
        key = "%s %s" % (site, label)
        configs[key] = dispatch.describe(site, sp.shape_class(ctx),
                                         default=sp.default_for(ctx))
        sources[key] = configs[key].pop("config_source")
    model = FlagshipDecodeModel(**README_MODEL)
    server = InferenceServer({"flagship": model},
                             prefill_chunk_tokens="auto", **README_SERVER)
    prompts = _prompts()
    try:
        answers, seconds = _post_all(server.url, prompts)
        stats = server.registry.get("flagship").scheduler.stats()
    finally:
        server.stop()
    got = [a["tokens"] for a in answers]
    want = [generate_reference(model.params, p, NEW_TOKENS,
                               heads=model.heads) for p in prompts]
    card_wf = _mnist_workflow(1)
    gemm.precise_matmul.launches = gemm.precise_matmul.fold_launches = 0
    card_losses = train_steps(card_wf, RESTART_STEPS)
    torch.cuda.synchronize()
    launches = gemm.precise_matmul.launches
    folds = gemm.precise_matmul.fold_launches
    split = gemm.precise_split(60, 100, 784, 1, torch.device("cuda"))
    cpu_wf = _mnist_workflow(1, device="cpu")
    cpu_losses = train_steps(cpu_wf, RESTART_STEPS)
    w_diff = max(float(numpy.abs(c[k] - g[k]).max())
                 for c, g in zip(host_weights(cpu_wf),
                                 host_weights(card_wf)) for k in c)
    rec = {"sources": sources, "configs": configs,
           "nvcc_runs": _build.build.nvcc_runs,
           "cache": default_cache().stats(),
           "chunk_source": stats.get("chunk_source"),
           "chunk_tokens": stats["prefill_chunk_tokens"],
           "tokens": sum(map(len, got)), "burst_s": seconds,
           "mismatched": [i for i, (g, w) in enumerate(zip(got, want))
                          if g != w],
           "mnist": {"steps": RESTART_STEPS, "k4_launches": launches,
                     "k4_fold_launches": folds, "k4_split_runs": split,
                     "card_losses": card_losses, "cpu_losses": cpu_losses,
                     "weights_diff": w_diff},
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)


def restart_check(card, cache_dir, tune_dir, cases=TUNE_CASES):
    """Start the fresh process against both directories under a hard
    cap and hold its record (``restart_verdict``); -> record."""
    before = _cache_state(cache_dir)
    code = ("import sys, chip_smoke; "
            "chip_smoke.fresh_restart(sys.argv[1])")
    argv = [sys.executable, "-c", code, json.dumps(cases)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=900,
                          env=_restart_env(cache_dir, tune_dir),
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError("3e fresh process exit %d:\n%s"
                             % (proc.returncode, proc.stderr[-3000:]))
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    after = _cache_state(cache_dir)
    restart_verdict(rec, before, after)
    rec.update(card=card, process_s=seconds, cache_listing=after)
    _log("3e fresh process (both directories set): every tuned site "
         "resolved tuned (%d), %d nvcc runs, build cache %s (listing "
         "unchanged, %d files); phase 3's f32 burst with "
         "prefill_chunk_tokens='auto' (chunks of %s, %s): %d tokens in "
         "%.3f s, every token equal to generate_reference; MNIST %d "
         "steps with precise_gemm=1 and K4's tuned split (%s runs a "
         "split call; %d launches, %d folded): losses %s, CPU %s, "
         "max|w_card - w_cpu| %.3g (limit %g); %.1f s in the process, "
         "%.1f s with its start [%s]"
         % (len(rec["sources"]), rec["nvcc_runs"], rec["cache"],
            len(after), rec["chunk_tokens"], rec["chunk_source"],
            rec["tokens"], rec["burst_s"], rec["mnist"]["steps"],
            rec["mnist"]["k4_split_runs"], rec["mnist"]["k4_launches"],
            rec["mnist"]["k4_fold_launches"], rec["mnist"]["card_losses"],
            rec["mnist"]["cpu_losses"], rec["mnist"]["weights_diff"],
            FIRST_EPOCH_WEIGHT_ATOL, rec["seconds"], seconds, card))
    return rec


def autotune_phase(torch, card, cache_dir, dev):
    """Phase 3e (slice 16): tune into a fresh tuning directory over the
    build cache the fleet of phase 3d filled, hold the tuned plans,
    restart fresh; -> record."""
    tune_dir = tempfile.mkdtemp(prefix="veles-tune-")
    rec, t0 = {}, time.perf_counter()
    try:
        for name, step in (
                ("tuned", lambda: tune_phase(card, tune_dir, cache_dir)),
                ("held", lambda: hold_tuned_plans(torch, tune_dir, dev)),
                ("restart", lambda: restart_check(card, cache_dir,
                                                  tune_dir))):
            rec[name] = step()
            rec[name + "_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)
    _log("3e steps: tune %.1f s, hold %.1f s, restart %.1f s"
         % (rec["tuned_s"], rec["held_s"], rec["restart_s"]))
    return rec


# -- phase 4: training, MNIST on the unit engine ------------------------------

#: the MNIST gate's settings (the JAX package's tests/test_samples_gates.py)
GATE_ERROR_PT = 1.48
GATE_LOADER = {"minibatch_size": 60, "n_train": None, "n_valid": None}
GATE_DECISION = {"max_epochs": 25, "fail_iterations": 12, "silent": True}
FIRST_EPOCH_WEIGHT_ATOL = 1e-4


def _mnist_workflow(precise, device="cuda", epochs=None, fused=True,
                    **overrides):
    """The gate's workflow with ``root.common.engine.precise_gemm`` set
    to ``precise``, initialized on ``device`` (the card unless the CPU
    is asked for, whatever ``$VELES_BACKEND`` says); ``fused=False``:
    graph mode; ``overrides`` go to ``create_workflow`` (a
    ``snapshotter``, a ``loader_factory``), a ``loader`` dict merged into
    the gate's."""
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
            fused=fused,
            loader=dict(GATE_LOADER, prng=RandomGenerator().seed(3),
                        **overrides.pop("loader", {})),
            decision=decision, **overrides)
    finally:
        root.common.engine.precise_gemm = saved
    wf.initialize(device=Device(backend=device))
    _on(wf, device)
    if [f.precise_gemm for f in wf.forwards] != [precise] * 2:
        raise AssertionError("precise_gemm did not reach the layers")
    return wf


def _epoch_metric(wf):
    """Each class's n_err of the epoch just ended (rmse for MSE)."""
    decision = wf.decision
    return list(decision.epoch_rmse if wf.loss_function == "mse"
                else decision.epoch_n_err)


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
    step_run, decision_run = step.run, decision.run

    def run():
        before = {name: fn.launches for name, fn in counters.items()}
        cls = step.minibatch_class
        step_run()
        rec["steps"][cls] += 1
        for name, fn in counters.items():
            rec["launches"][name][cls] += fn.launches - before[name]
        if cls == TRAIN:     # a device scalar: read at the end, no sync
            rec["train_loss"][-1].append(step.loss)

    def mark_epoch_end():
        rec["epoch_end"].append(time.perf_counter())
        rec["train_loss"].append([])
        if rec["first_epoch"] is None:
            rec["first_epoch"] = {
                "n_err": _epoch_metric(wf),
                "weights": [{k: numpy.array(v)
                             for k, v in f.host_params.items()}
                            for f in wf.forwards]}

    def run_decision():
        # an epoch ends where the decision closes its last minibatch
        ended = bool(decision.last_minibatch) and \
            bool(decision.epoch_ended)
        decision_run()
        if ended:
            mark_epoch_end()

    step.run, decision.run = run, run_decision
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
           "first_epoch": rec["first_epoch"], "workflow": wf}
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


#: the needle task's data by (n, t, d, classes): made once a process
#: (2 GB and ~5 s at the full width) and shared by the loaders, which
#: only read it (no normalization)
_NEEDLE_DATA = {}


def _needle_data(n, t, d, classes):
    """The needle task's (x, labels), made once a process."""
    key = (n, t, d, classes)
    if key not in _NEEDLE_DATA:
        rng = numpy.random.RandomState(3)
        x = rng.uniform(-0.2, 0.2, (n, t, d)).astype(numpy.float32)
        labels = rng.randint(0, classes, n)
        pos = rng.randint(0, t, n)
        rows = numpy.arange(n)
        x[rows, pos, 0] = 2.0                 # the marker
        x[rows, pos, 1 + labels] = 2.0        # the payload class
        _NEEDLE_DATA[key] = x, list(labels.astype(numpy.int32))
    return _NEEDLE_DATA[key]


def _needle_class():
    """The needle task's FullBatchLoader class, made once and bound to
    this module's ``NeedleLoader``, so a pickled workflow names it (the
    module's ``__getattr__`` makes it for a fresh process)."""
    cls = globals().get("NeedleLoader")
    if cls is not None:
        return cls
    from veles_tpu_torch.loader.base import TEST, TRAIN, VALID
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader

    class NeedleLoader(FullBatchLoader):
        hide_from_registry = True

        def __init__(self, workflow, **kwargs):
            self.n, self.t, self.d = (kwargs.pop(k) for k in "ntd")
            self.classes = kwargs.pop("classes")
            n_valid = kwargs.pop("n_valid", None)
            self.n_valid = self.n // 4 if n_valid is None else n_valid
            super().__init__(workflow, **kwargs)

        def load_data(self):
            self.original_data.mem, labels = _needle_data(
                self.n, self.t, self.d, self.classes)
            self.original_labels = list(labels)
            self.class_lengths[TEST] = 0
            self.class_lengths[VALID] = self.n_valid
            self.class_lengths[TRAIN] = self.n - self.n_valid

    NeedleLoader.__qualname__ = "NeedleLoader"   # pickle's lookup name
    globals()["NeedleLoader"] = NeedleLoader
    return NeedleLoader


def __getattr__(name):
    # a fresh process unpickling an attention workflow looks the needle
    # loader up by name before anything made it
    if name == "NeedleLoader":
        return _needle_class()
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def needle_loader(n, t, d, classes, n_valid=None):
    """The needle task of the JAX package's tests/test_attention_unit.py
    as a port FullBatchLoader factory: n sequences of [T, D] uniform
    noise in [-0.2, 0.2], one marked position per sequence (feature 0 =
    2.0) whose payload feature 1 + label is 2.0 too; the first
    ``n_valid`` (default n / 4) validate, the rest train."""
    import functools
    return functools.partial(_needle_class(), n=n, t=t, d=d,
                             classes=classes, n_valid=n_valid)


def attention_workflow(n, t, d, heads, causal=False, window=None,
                       minibatch=ATTN_MINIBATCH, epochs=ATTN_EPOCHS,
                       device="cuda", use_pallas=None, n_valid=None,
                       fused=True, snapshotter=None):
    """``StandardWorkflow([multihead_attention, softmax])`` on the needle
    task, weights from seed 42, initialized on ``device`` (the card
    unless the CPU is asked for); ``fused=False``: graph mode;
    ``snapshotter``: its config."""
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
        decision={"max_epochs": epochs, "silent": True}, fused=fused,
        snapshotter=snapshotter)
    wf.initialize(device=Device(backend=device))
    if wf.forwards[0].device.BACKEND != device:
        raise AssertionError("the attention unit runs on %s, not %s"
                             % (wf.forwards[0].device.BACKEND, device))
    return _on(wf, device)


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
           "first_epoch": rec["first_epoch"], "workflow": wf}
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


#: the unit with one head (head dim 512, K7-K9's wide path): train steps
#: at the full width (T 2048, d_model 512) on ``ATTN_CPU_N`` sequences,
#: held against the CPU
ATTN_WIDE_HEADS, ATTN_WIDE_STEPS = 1, 2


def attention_wide_hold(torch, fa, card):
    """``ATTN_WIDE_STEPS`` train steps of the attention unit at head dim
    512 through K7-K9 on the card, and through the plain versions on the
    CPU (``use_pallas=True`` on both): losses and weights within
    ``steps_agree``'s limits.  The kernels' counts are set to 0 just
    before the card's steps and read just after: each launches once a
    step."""
    label = "attention D=%d (one head)" % ATTN_D
    counters = _flash_counters(fa)
    wfs = {dev: attention_workflow(
        ATTN_CPU_N, ATTN_T, ATTN_D, ATTN_WIDE_HEADS, epochs=1, device=dev,
        use_pallas=True, n_valid=ATTN_CPU_VALID) for dev in ("cuda", "cpu")}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    card_losses = train_steps(wfs["cuda"], ATTN_WIDE_STEPS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    t0 = time.perf_counter()
    cpu_losses = train_steps(wfs["cpu"], ATTN_WIDE_STEPS)
    cpu_s = time.perf_counter() - t0
    loss_diff, w_diff = steps_agree(
        label, card_losses, host_weights(wfs["cuda"]), cpu_losses,
        host_weights(wfs["cpu"]))
    _log("train %s: %d train steps (T=%d, minibatch %d) on the card in "
         "%.3f s (cuBLAS's first calls included), "
         "on the CPU in %.3f s; losses card %s cpu %s; loss rel diff %.3g, "
         "weight rel diff %.3g (limits %g, %g); launches %s [%s]"
         % (label, ATTN_WIDE_STEPS, ATTN_T, ATTN_MINIBATCH, card_s, cpu_s,
            card_losses, cpu_losses, loss_diff, w_diff, STEP_LOSS_RTOL,
            STEP_WEIGHT_RTOL, launches, card))
    want = {name: ATTN_WIDE_STEPS for name in counters}
    if launches != want:
        raise AssertionError("%s: launches %r over %d train steps, want %r"
                             % (label, launches, ATTN_WIDE_STEPS, want))
    return {"label": label, "card": card, "card_losses": card_losses,
            "cpu_losses": cpu_losses, "loss_rel_diff": loss_diff,
            "weight_rel_diff": w_diff, "card_seconds": card_s,
            "cpu_seconds": cpu_s, "launches": launches}


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
    """Refuse a workflow that does not run where it was asked to (the
    fused step's device, or in graph mode the first forward's)."""
    where = (wf.fused_step._dev_ if wf.fused_step is not None
             else wf.forwards[0].device.torch_device)
    if where.type != device:
        raise AssertionError("the workflow runs on %s, not %s"
                             % (where, device))
    return wf


def alexnet_workflow(device="cuda", use_pallas=None, epochs=ALEX_EPOCHS,
                     snapshotter=None, **loader):
    """The AlexNet sample through ``create_workflow``, weights from seed
    42, loader seed 7, initialized on ``device`` (the card unless the CPU
    is asked for); ``loader`` overrides the sample's loader config;
    ``snapshotter``: its config."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import alexnet
    prng.get().seed(42)
    wf = alexnet.create_workflow(
        loader=dict(loader, prng=RandomGenerator().seed(7)),
        layers=_with_lrn_form(root.alexnet.layers, use_pallas),
        decision={"max_epochs": epochs, "silent": True},
        snapshotter=snapshotter)
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


def steps_agree(label, losses, weights, want_losses, want_weights,
                loss_rtol=STEP_LOSS_RTOL, weight_rtol=STEP_WEIGHT_RTOL):
    """Losses within ``loss_rtol``, each parameter tensor within
    ``weight_rtol`` of its largest magnitude; -> (max loss rel diff, max
    weight rel diff)."""
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        want_losses))
    w_diff = _max_rel_diff(weights, want_weights)
    if len(losses) != len(want_losses) or \
            not loss_diff <= loss_rtol or not w_diff <= weight_rtol:
        raise AssertionError("%s: losses %r against %r (rel %g, limit %g),"
                             " weights rel %g (limit %g)"
                             % (label, losses, want_losses, loss_diff,
                                loss_rtol, w_diff, weight_rtol))
    return loss_diff, w_diff


def host_weights(wf):
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def _lrn_counters(lrn_mod):
    return {"K5": lrn_mod.lrn, "K6": lrn_mod.lrn_backward}


def _train_record(torch, wf, counters, label, card, t_init, n_seq_label):
    """Run ``wf`` (fused or graph mode) with its kernels' counts reset;
    -> record of epoch times, train samples/s (median epoch, the first
    apart), losses, launches (total and per train / eval step), the
    best error and the first epoch's state (``first_epoch``, numpy: the
    caller pops it); in graph mode also the launches made inside GD
    units (``gd_launches``)."""
    from veles_tpu_torch.loader import TRAIN, VALID
    graph = wf.fused_step is None
    if graph:
        rec, close = _graph_instrument(wf, counters)
        inside = _gd_launches(wf, counters)
    else:
        rec, close = _instrument(wf, counters), (lambda: None)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf.run()
    close()
    if torch.cuda.is_available():
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
    mse = "best_validation_rmse" in res
    best = "best_validation_rmse" if mse else "best_validation_error_pt"
    out = {"label": label, "card": card, "init_s": t_init,
           "seconds": seconds, "epochs": len(epoch_s), "epoch_s": epoch_s,
           "epoch_s_median_after_first": median_s,
           "train_samples_s_median": n_train / median_s,
           "train_steps": steps[TRAIN], "eval_steps": steps[VALID],
           "launches": launches, "launches_per_train_eval_step": per,
           "mean_train_loss": [statistics.fmean(e) for e in losses],
           best: res[best], "best_epoch": res["best_epoch"]}
    out["first_epoch"] = rec["first_epoch"]
    if graph:
        out["gd_launches"] = inside
    _log("train %s%s: %d train + %d valid %s, minibatch %d; %d epochs in "
         "%.3f s; epoch wall s %s; median after the first %.4f s = %.1f "
         "train %s/s; mean train loss by epoch %s; best validation %s "
         "(epoch %d); launches %s (per train / eval step %s%s); "
         "init %.3f s [%s]"
         % (label, " (graph mode)" if graph else "", n_train,
            wf.loader.class_lengths[VALID], n_seq_label,
            wf.loader.max_minibatch_size, len(epoch_s), seconds,
            " ".join("%.4f" % x for x in epoch_s), median_s,
            out["train_samples_s_median"], n_seq_label,
            " ".join("%.5f" % x for x in out["mean_train_loss"]),
            ("rmse %.6f" if mse else "error %.2f%%") % out[best],
            out["best_epoch"], launches,
            per, "; inside GD units %s" % inside if graph else "", t_init,
            card))
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
    out.pop("first_epoch")
    want = {"K5": (2, 2), "K6": (2, 0)} if use_pallas is None else \
        {"K5": (0, 0), "K6": (0, 0)}
    if out["launches_per_train_eval_step"] != want:
        raise AssertionError("%s: launches per train / eval step %r, want "
                             "%r" % (label,
                                     out["launches_per_train_eval_step"],
                                     want))
    out["workflow"] = wf
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
                     fused=True, **loader):
    """The LRN convnet through the CIFAR sample's ``create_workflow``,
    weights from seed 42, loader seed 7, on ``device`` (the card unless
    the CPU is asked for); ``fused=False``: graph mode."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import cifar
    prng.get().seed(42)
    wf = cifar.create_workflow(
        loader=dict(LRN_NET_LOADER, prng=RandomGenerator().seed(7),
                    **loader),
        layers=_with_lrn_form(LRN_NET_LAYERS, use_pallas),
        decision={"max_epochs": epochs, "silent": True}, fused=fused)
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
    out.pop("first_epoch")
    if not out["best_validation_error_pt"] < LRN_NET_GATE_PT:
        raise AssertionError("the LRN convnet missed its gate: %.2f%% >= "
                             "%.0f%%" % (out["best_validation_error_pt"],
                                         LRN_NET_GATE_PT))
    if out["launches_per_train_eval_step"] != {"K5": (2, 2),
                                               "K6": (2, 0)}:
        raise AssertionError("the LRN convnet's launches per train / eval "
                             "step: %r" % out["launches_per_train_eval_step"])
    out["workflow"] = wf
    return out


def trace_alexnet(torch, card, label, use_pallas):
    """One AlexNet epoch under ``torch.profiler`` with each LRN form (the
    card's busy time of the two compares the forms inside a real step),
    with the top kernels and every device copy named."""
    return _traced(torch, "train " + label, card, lambda: _epoch(
        alexnet_workflow(use_pallas=use_pallas, epochs=1)), top=25)

# -- phase 3f: exported packages (slice 19) -----------------------------------

#: the MNIST bursts: request sizes (cycled), rows in all, client threads
PKG_SIZES = (1, 2, 3, 5, 8)
PKG_ROWS, PKG_CLIENTS, PKG_MAX_BATCH = 64, 8, 16
#: a served answer against the live forward on the card, of the largest
#: |output| of that forward
PKG_TOL = 1e-5
#: AlexNet: requests (sizes cycled), clients, max_batch; the rows held
#: against the port on the CPU and their tolerance (of the largest |CPU
#: output|)
ALEX_PKG_REQUESTS, ALEX_PKG_CLIENTS, ALEX_PKG_MAX_BATCH = 16, 4, 8
ALEX_PKG_CPU_ROWS, ALEX_PKG_CPU_TOL = 4, 1e-4
#: attention: sequences a request (cycled), requests, clients, max_batch
ATTN_PKG_SIZES = (1, 2)
ATTN_PKG_REQUESTS, ATTN_PKG_CLIENTS, ATTN_PKG_MAX_BATCH = 8, 4, 4
#: the fleet: clients, requests of FLEET_PKG_ROWS rows each (a full
#: bucket, so every batch is one request), the replicas' max_batch
FLEET_PKG_CLIENTS, FLEET_PKG_REQUESTS, FLEET_PKG_ROWS = 8, 24, 8


def _plan(sizes, requests=None, rows=None):
    """[(first row, rows)] of consecutive requests, ``sizes`` cycled,
    until ``requests`` requests or ``rows`` rows."""
    out, lo = [], 0
    while (requests is None or len(out) < requests) and \
            (rows is None or lo < rows):
        n = sizes[len(out) % len(sizes)]
        if rows is not None:
            n = min(n, rows - lo)
        out.append((lo, n))
        lo += n
    return out


def _package_rows(wf, n, sample_shape):
    """The first ``n`` samples of ``wf``'s dataset, as the package takes
    them."""
    data = wf.loader.original_data.map_read()[:n]
    return numpy.ascontiguousarray(data, numpy.float32).reshape(
        (n,) + tuple(sample_shape))


def _live_answers(torch, wf, x, plan, params=None):
    """``wf``'s own forward on the card of each request's rows (over
    ``params``, default its live weights)."""
    from veles_tpu_torch.export import forward_fn
    fwd = forward_fn(wf.forwards)
    params = params or [f.params for f in wf.forwards]
    dev = next(t for p in params for t in p.values()).device
    with torch.no_grad():
        return [fwd(params, torch.from_numpy(x[lo:lo + n]).to(dev))
                .cpu().numpy() for lo, n in plan]


def _fp16_rounded(torch, wf):
    """``wf``'s weights rounded to fp16 and promoted back, on the card."""
    return [{k: v.to(torch.float16).to(torch.float32)
             for k, v in f.params.items()} for f in wf.forwards]


def _held_to_live(label, answers, want, tol):
    """max |served - live| over every answer, of the largest |live|;
    -> (that error, rows bitwise equal); raises past ``tol``."""
    scale = max(float(numpy.abs(w).max()) for w in want)
    err = max(float(numpy.abs(a - w).max()) for a, w in zip(answers, want))
    bitwise = sum(int(numpy.all(a.reshape(len(a), -1) ==
                                w.reshape(len(w), -1), axis=1).sum())
                  for a, w in zip(answers, want))
    if not err <= tol * scale:
        raise AssertionError("%s: a served answer is %.3g off the live "
                             "forward, %.3g of its largest |output| "
                             "(limit %g)" % (label, err, err / scale, tol))
    return err / scale, bitwise


def _per_batch(label, launches, batches, per):
    """``per`` launches a dispatched batch, and some batch dispatched."""
    if batches <= 0 or launches != per * batches:
        raise AssertionError("%s: %d launches over %d dispatched batches, "
                             "want %d a batch" % (label, launches, batches,
                                                  per))


def _http_burst(url, x, plan, clients):
    """``plan``'s requests POSTed from ``clients`` threads; -> (outputs
    by request, seconds)."""
    answers = [None] * len(plan)
    errors = []

    def client(c):
        for i in range(c, len(plan), clients):
            lo, n = plan[i]
            try:
                code, body, _ = _post_json(url,
                                           {"input": x[lo:lo + n].tolist()})
                if code != 200:
                    raise RuntimeError("answered %d: %s" % (code, body))
                answers[i] = numpy.asarray(body["output"], numpy.float32)
            except Exception as exc:  # noqa: BLE001 — raised below
                errors.append(exc)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    seconds = time.perf_counter() - t0
    if errors or any(a is None for a in answers):
        raise AssertionError("package requests failed: %r" % errors[:3])
    return answers, seconds


def _engine_precise(precise):
    """Set ``root.common.engine.precise_gemm`` (a rebuilt All2All reads
    it at construction, as a live one does); -> a restore function."""
    from veles_tpu_torch.config import root
    saved = root.common.engine.get("precise_gemm", 0)
    root.common.engine.precise_gemm = precise
    return lambda: setattr(root.common.engine, "precise_gemm", saved)


def _live_precise(wf):
    """The ``precise_gemm`` of ``wf``'s All2All layers (one value)."""
    levels = {f.precise_gemm for f in wf.forwards
              if hasattr(f, "precise_gemm")}
    if len(levels) != 1:
        raise AssertionError("mixed precise_gemm %s" % levels)
    return levels.pop()


def _served(card, label, model, dev, url_route, x, plan, clients, kernel,
            per, want, max_batch, name):
    """``model`` (a package path or loader) behind an InferenceServer on
    ``dev``: ``kernel`` (its name in ``kernel_wrappers()``, its wrapper)
    counted from 0 just before the burst, ``per`` launches a dispatched
    batch, the scheduler's own count the same, every answer within
    ``PKG_TOL`` of ``want``; -> record."""
    from veles_tpu_torch.serving import InferenceServer
    t0 = time.perf_counter()
    server = InferenceServer({name: model}, device=dev,
                             max_batch=max_batch)
    warm_s = time.perf_counter() - t0
    sched = server.registry.get(name).scheduler
    kname, counter = kernel
    try:
        counter.launches = 0
        answers, seconds = _http_burst(server.url + url_route, x, plan,
                                       clients)
        launches = counter.launches
        stats = sched.stats()
        batches = sched.metrics.snapshot()["batches"]
    finally:
        server.stop()
    _per_batch(label, launches, batches, per)
    if stats["kernel_launches"][kname] != launches:
        raise AssertionError("%s: the scheduler counted %s, the wrapper %d"
                             % (label, stats["kernel_launches"], launches))
    err, bitwise = _held_to_live(label, answers, want, PKG_TOL)
    rows = sum(n for _, n in plan)
    return {"label": label, "card": card, "warm_s": warm_s,
            "requests": len(plan), "rows": rows, "seconds": seconds,
            "rows_s": rows / seconds, "batches": batches,
            "launches": {kname: launches}, "max_rel_err": err,
            "bitwise_rows": bitwise, "buckets": stats["buckets"]}


def package_mnist_part(torch, gemm, card, wf, tmp, dev):
    """(a) Phase 4's MNIST (``precise_gemm=1``) exported at fp32 and
    fp16, each served through ``InferenceServer``: 8 threads send 64
    rows in requests of 1, 2, 3, 5 and 8; K4 2 a dispatched batch;
    fp32 answers within ``PKG_TOL`` of the live forward, fp16 answers of
    the live forward over the fp16-rounded weights."""
    from veles_tpu_torch.export import PackageLoader, export_model
    t_part = time.perf_counter()
    precise = _live_precise(wf)
    if precise != 1:
        raise AssertionError("phase 4's MNIST has precise_gemm=%d" % precise)
    plan = _plan(PKG_SIZES, rows=PKG_ROWS)
    out = {"runs": []}
    for precision in (32, 16):
        path = os.path.join(tmp, "mnist%d.zip" % precision)
        t0 = time.perf_counter()
        export_model(wf, path, precision=precision)
        export_s = time.perf_counter() - t0
        x = _package_rows(wf, PKG_ROWS, PackageLoader(path).sample_shape)
        want = _live_answers(torch, wf, x, plan, None if precision == 32
                             else _fp16_rounded(torch, wf))
        restore = _engine_precise(precise)
        try:
            rec = _served(card, "3f MNIST fp%d" % precision, path, dev,
                          "/api/mnist", x, plan, PKG_CLIENTS,
                          ("precise_matmul", gemm.precise_matmul), 2, want,
                          PKG_MAX_BATCH, "mnist")
        finally:
            restore()
        rec.update(precision=precision, export_s=export_s,
                   package_bytes=os.path.getsize(path))
        out["runs"].append(rec)
        out["fp%d" % precision] = path
        _log("3f (a) MNIST package fp%d (precise_gemm=1): %d bytes, "
             "export %.3f s, server up and warm %.3f s; %d requests of "
             "%s rows from %d threads, %d rows in %.3f s = %.0f rows/s; "
             "%d batches, K4 %d launches = 2 a batch; max |served - live| "
             "%.3g of the largest |output| (limit %g), %d of %d rows "
             "bitwise%s [%s]"
             % (precision, rec["package_bytes"], export_s, rec["warm_s"],
                rec["requests"], "/".join(map(str, PKG_SIZES)),
                PKG_CLIENTS, rec["rows"], rec["seconds"], rec["rows_s"],
                rec["batches"], rec["launches"]["precise_matmul"],
                rec["max_rel_err"], PKG_TOL, rec["bitwise_rows"],
                rec["rows"], "" if precision == 32 else
                " (live over fp16-rounded weights)", card))
    out["seconds"] = time.perf_counter() - t_part
    _log("3f (a) MNIST: %.1f s" % out["seconds"])
    return out


def package_alexnet_part(torch, lrn_mod, card, wf, tmp, dev):
    """(b) Phase 4c's AlexNet (published widths, ``use_pallas`` unset)
    exported at fp32 and served on ``POST /api/alexnet`` (max_batch 8,
    16 requests of 1-8 images from 4 threads): K5 2 a dispatched batch,
    answers within ``PKG_TOL`` of the live forward; 4 images through the
    server within ``ALEX_PKG_CPU_TOL`` of the same package on the CPU."""
    from veles_tpu_torch.export import PackageLoader, export_model
    t_part = time.perf_counter()
    precise = _live_precise(wf)
    path = os.path.join(tmp, "alexnet.zip")
    t0 = time.perf_counter()
    export_model(wf, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = PackageLoader(path)
    load_s = time.perf_counter() - t0
    plan = _plan(PKG_SIZES, requests=ALEX_PKG_REQUESTS)
    images = sum(n for _, n in plan)
    x = _package_rows(wf, images, loader.sample_shape)
    want = _live_answers(torch, wf, x, plan)
    restore = _engine_precise(precise)
    try:
        rec = _served(card, "3f AlexNet", loader, dev, "/api/alexnet", x,
                      plan, ALEX_PKG_CLIENTS, ("lrn_fwd", lrn_mod.lrn), 2,
                      want, ALEX_PKG_MAX_BATCH, "alexnet")
        cpu_rows = x[:ALEX_PKG_CPU_ROWS]
        cpu = PackageLoader(path).run(cpu_rows, device="cpu")
        card_rows, _ = _http_burst_server(loader, dev, cpu_rows)
    finally:
        restore()
    cpu_err = float(numpy.abs(card_rows - cpu).max() /
                    numpy.abs(cpu).max())
    if not cpu_err <= ALEX_PKG_CPU_TOL:
        raise AssertionError("3f AlexNet: the card's answers are %.3g of "
                             "the largest |output| off the CPU's (limit "
                             "%g)" % (cpu_err, ALEX_PKG_CPU_TOL))
    rec.update(precision=32, export_s=export_s, load_s=load_s,
               package_bytes=os.path.getsize(path),
               parameters=int(sum(a.size for u in loader.arrays.values()
                                  for a in u.values())),
               images_s=rec["rows_s"], cpu_rows=ALEX_PKG_CPU_ROWS,
               cpu_rel_err=cpu_err)
    rec["seconds_part"] = time.perf_counter() - t_part
    _log("3f (b) AlexNet package (%d parameters, %d bytes): export %.3f "
         "s, load %.3f s, server up and warm (buckets %s) %.3f s; %d "
         "requests of 1-8 images from %d threads, %d images in %.3f s = "
         "%.1f images/s; %d batches, K5 %d launches = 2 a batch; max "
         "|served - live| %.3g of the largest |output| (limit %g), %d of "
         "%d rows bitwise; %d images card vs CPU %.3g (limit %g); %.1f s "
         "[%s]"
         % (rec["parameters"], rec["package_bytes"], export_s, load_s,
            rec["buckets"], rec["warm_s"], rec["requests"],
            ALEX_PKG_CLIENTS, images, rec["seconds"], rec["images_s"],
            rec["batches"], rec["launches"]["lrn_fwd"], rec["max_rel_err"],
            PKG_TOL, rec["bitwise_rows"], images, ALEX_PKG_CPU_ROWS,
            cpu_err, ALEX_PKG_CPU_TOL, rec["seconds_part"], card))
    return rec


def _http_burst_server(model, dev, x):
    """One request of ``x`` to a fresh server over ``model`` on ``dev``;
    -> (its output, seconds)."""
    from veles_tpu_torch.serving import InferenceServer
    server = InferenceServer({"m": model}, device=dev, max_batch=len(x))
    try:
        answers, seconds = _http_burst(server.url + "/api/m", x,
                                       [(0, len(x))], 1)
    finally:
        server.stop()
    return answers[0], seconds


def package_attention_part(torch, fa, card, wf, tmp, dev):
    """(c) Phase 4b's attention net (d_model 512, 8 heads, T=2048, no
    mask) exported at fp32 and served through the server's registry
    entry in-process (a sequence is 1M floats: JSON would time the
    encoder), 8 requests of 1-2 sequences from 4 threads, max_batch 4:
    K7 once a dispatched batch, answers within ``PKG_TOL`` of the live
    forward."""
    from veles_tpu_torch.export import PackageLoader, export_model
    from veles_tpu_torch.serving import InferenceServer
    t_part = time.perf_counter()
    path = os.path.join(tmp, "attention.zip")
    t0 = time.perf_counter()
    export_model(wf, path)
    export_s = time.perf_counter() - t0
    plan = _plan(ATTN_PKG_SIZES, requests=ATTN_PKG_REQUESTS)
    rows = sum(n for _, n in plan)
    x = _package_rows(wf, rows, PackageLoader(path).sample_shape)
    want = _live_answers(torch, wf, x, plan)
    restore = _engine_precise(_live_precise(wf))
    try:
        t0 = time.perf_counter()
        server = InferenceServer({"attention": path}, device=dev,
                                 max_batch=ATTN_PKG_MAX_BATCH)
        warm_s = time.perf_counter() - t0
    finally:
        restore()
    entry = server.registry.get("attention")
    answers = [None] * len(plan)
    errors = []

    def client(c):
        for i in range(c, len(plan), ATTN_PKG_CLIENTS):
            lo, n = plan[i]
            try:
                answers[i] = entry.infer(x[lo:lo + n], timeout=600)[1]
            except Exception as exc:  # noqa: BLE001 — raised below
                errors.append(exc)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(ATTN_PKG_CLIENTS)]
    try:
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        seconds = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
        stats = entry.scheduler.stats()
        batches = entry.scheduler.metrics.snapshot()["batches"]
    finally:
        server.stop()
    if errors or any(a is None for a in answers):
        raise AssertionError("3f attention: requests failed: %r"
                             % errors[:3])
    _per_batch("3f attention", launches, batches, 1)
    if stats["kernel_launches"]["flash_attention_fwd"] != launches:
        raise AssertionError("3f attention: the scheduler counted %s"
                             % stats["kernel_launches"])
    err, bitwise = _held_to_live("3f attention", answers, want, PKG_TOL)
    rec = {"label": "3f attention", "card": card, "export_s": export_s,
           "package_bytes": os.path.getsize(path), "warm_s": warm_s,
           "requests": len(plan), "rows": rows, "seconds": seconds,
           "sequences_s": rows / seconds, "batches": batches,
           "launches": {"flash_attention_fwd": launches},
           "max_rel_err": err, "bitwise_rows": bitwise,
           "buckets": stats["buckets"],
           "seconds_part": time.perf_counter() - t_part}
    t, d = x.shape[1:]
    heads = wf.forwards[0].heads
    rec.update(t=t, d_model=d, heads=heads)
    _log("3f (c) attention package (T=%d, d_model %d, %d heads; %d "
         "bytes): export %.3f s, warm (buckets %s) %.3f s; %d requests of "
         "1-2 sequences from %d threads, %d sequences in %.3f s = %.1f "
         "sequences/s; %d batches, K7 %d launches = 1 a batch; max "
         "|served - live| %.3g of the largest |output| (limit %g), %d of "
         "%d rows bitwise; %.1f s [%s]"
         % (t, d, heads, rec["package_bytes"], export_s, rec["buckets"],
            warm_s, len(plan), ATTN_PKG_CLIENTS, rows, seconds,
            rec["sequences_s"],
            batches, launches, err, PKG_TOL, bitwise, rows,
            rec["seconds_part"], card))
    return rec


def package_fleet_part(card, wf, tmp, dev):
    """(d) Phase 4d's LRN convnet exported and served by a fleet of two
    replicas on the card (``--model lrn=<package> --device cuda``) over
    a fresh shared build cache, filled by this process before the
    replicas start (each replica's warmup then builds nothing): 8
    threads send 24 requests of 8 images (one full bucket each) through
    the router; every answer bitwise the in-process card answer of the
    same package and rows; each replica's K5 count over HTTP more than 0
    and 2 a dispatched batch."""
    from veles_tpu_torch import _build
    from veles_tpu_torch.compilecache import CompileCache
    from veles_tpu_torch.export import PackageLoader, export_model
    from veles_tpu_torch.fleet import Fleet
    from veles_tpu_torch.serving import BucketScheduler
    t_part = time.perf_counter()
    path = os.path.join(tmp, "lrn_convnet.zip")
    export_model(wf, path)
    plan = [(i * FLEET_PKG_ROWS, FLEET_PKG_ROWS)
            for i in range(FLEET_PKG_REQUESTS)]
    x = _package_rows(wf, FLEET_PKG_ROWS * FLEET_PKG_REQUESTS,
                      PackageLoader(path).sample_shape)
    restore = _engine_precise(0)      # the replicas' own default
    try:
        sched = BucketScheduler(path, max_batch=FLEET_PKG_ROWS,
                                name="in-process", device=dev)
    finally:
        restore()
    try:
        want = [sched.infer(x[lo:lo + n], timeout=600) for lo, n in plan]
    finally:
        sched.close()
    cache_dir = tempfile.mkdtemp(prefix="veles-pkg-fleet-cache-", dir=tmp)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        _build.build(cache=CompileCache(cache_dir))
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = Fleet({"lrn": path}, replicas=2, max_batch=FLEET_PKG_ROWS,
                  poll_interval=0.1, backoff=FLEET_BACKOFF,
                  device=dev.type, cache_dir=cache_dir)
    try:
        fleet.start(ready_timeout=600)
        start_s = time.perf_counter() - t0
        answers, seconds = _http_burst(fleet.url + "/api/lrn", x, plan,
                                       FLEET_PKG_CLIENTS)
        merged = fleet.router.merged_metrics()["replicas"]
    finally:
        fleet.stop()
    per_replica = {}
    for rid, body in merged.items():
        stats = body["lrn"]
        k5 = stats["kernel_launches"]["lrn_fwd"]
        per_replica[rid] = {"batches": stats["batches"], "k5": k5,
                            "compiles": stats["compiles"],
                            "cache_hits": stats["cache_hits"]}
        _per_batch("3f fleet replica %s" % rid, k5, stats["batches"], 2)
    if sum(r["batches"] for r in per_replica.values()) != len(plan):
        raise AssertionError("3f fleet: %s batches for %d requests"
                             % (per_replica, len(plan)))
    diff = max(float(numpy.abs(a - w).max())
               for a, w in zip(answers, want))
    if diff != 0.0:
        raise AssertionError("3f fleet: an answer is %.3g off the "
                             "in-process card answer" % diff)
    if dev.type == "cuda" and any(r["compiles"] for r in
                                  per_replica.values()):
        raise AssertionError("3f fleet: a replica built a kernel over the "
                             "filled cache: %s" % per_replica)
    rec = {"label": "3f fleet", "card": card, "start_s": start_s,
           "cache_fill_s": fill_s,
           "requests": len(plan), "rows": len(plan) * FLEET_PKG_ROWS,
           "seconds": seconds,
           "rows_s": len(plan) * FLEET_PKG_ROWS / seconds,
           "replicas": per_replica, "max_abs_diff": diff,
           "launches": {"lrn_fwd": sum(r["k5"]
                                       for r in per_replica.values())},
           "seconds_part": time.perf_counter() - t_part}
    _log("3f (d) fleet of 2 replicas (--model lrn=<LRN convnet package> "
         "--device %s, a fresh shared build cache filled in %.2f s): up "
         "and ready in %.2f s; %d requests of %d images from %d threads "
         "through the router "
         "in %.3f s = %.1f images/s, every answer bitwise the in-process "
         "card answer; per replica over HTTP (batches, K5, compiles, "
         "cache hits) %s; %.1f s [%s]"
         % (dev.type, fill_s, start_s, len(plan), FLEET_PKG_ROWS,
            FLEET_PKG_CLIENTS,
            seconds, rec["rows_s"], per_replica, rec["seconds_part"], card))
    return rec


def package_restful_part(torch, gemm, card, wf, path, dev):
    """(e) ``RESTfulAPI`` over (a)'s fp32 MNIST package: ``POST /api``
    held like (a)."""
    from veles_tpu_torch.export import PackageLoader
    from veles_tpu_torch.restful_api import RESTfulAPI
    t_part = time.perf_counter()
    plan = _plan(PKG_SIZES, rows=PKG_ROWS)
    x = _package_rows(wf, PKG_ROWS, PackageLoader(path).sample_shape)
    want = _live_answers(torch, wf, x, plan)
    restore = _engine_precise(_live_precise(wf))
    try:
        t0 = time.perf_counter()
        api = RESTfulAPI(path, device=dev, max_batch=PKG_MAX_BATCH)
        warm_s = time.perf_counter() - t0
    finally:
        restore()
    try:
        gemm.precise_matmul.launches = 0
        answers, seconds = _http_burst(api.url + "/api", x, plan,
                                       PKG_CLIENTS)
        launches = gemm.precise_matmul.launches
        stats = api.stats()
        batches = api.server.registry.get(
            "default").scheduler.metrics.snapshot()["batches"]
    finally:
        api.stop()
    _per_batch("3f RESTfulAPI", launches, batches, 2)
    err, bitwise = _held_to_live("3f RESTfulAPI", answers, want, PKG_TOL)
    rec = {"label": "3f RESTfulAPI", "card": card, "warm_s": warm_s,
           "requests": len(plan), "rows": PKG_ROWS, "seconds": seconds,
           "rows_s": PKG_ROWS / seconds, "batches": batches,
           "launches": {"precise_matmul": launches},
           "scheduler_launches": stats["kernel_launches"]["precise_matmul"],
           "max_rel_err": err, "bitwise_rows": bitwise,
           "seconds_part": time.perf_counter() - t_part}
    _log("3f (e) RESTfulAPI over the fp32 MNIST package, POST /api: "
         "warm %.3f s; %d requests from %d threads, %d rows in %.3f s = "
         "%.0f rows/s; %d batches, K4 %d launches = 2 a batch; max "
         "|served - live| %.3g of the largest |output| (limit %g), %d of "
         "%d rows bitwise; %.1f s [%s]"
         % (warm_s, len(plan), PKG_CLIENTS, PKG_ROWS, seconds,
            rec["rows_s"], batches, launches, err, PKG_TOL, bitwise,
            PKG_ROWS, rec["seconds_part"], card))
    return rec


def package_phase(torch, gemm, lrn_mod, fa, card, workflows, dev):
    """Phase 3f (slice 19): phases 4-4d's trained workflows exported and
    served (``workflows``: "mnist", "alexnet", "attention", "lrn");
    -> record with each part and the kernels' launches."""
    tmp = tempfile.mkdtemp(prefix="veles-packages-")
    try:
        rec = {"mnist": package_mnist_part(torch, gemm, card,
                                           workflows["mnist"], tmp, dev)}
        rec["alexnet"] = package_alexnet_part(
            torch, lrn_mod, card, workflows["alexnet"], tmp, dev)
        rec["attention"] = package_attention_part(
            torch, fa, card, workflows["attention"], tmp, dev)
        rec["fleet"] = package_fleet_part(card, workflows["lrn"], tmp, dev)
        rec["restful"] = package_restful_part(
            torch, gemm, card, workflows["mnist"], rec["mnist"]["fp32"],
            dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = {
        "precise_matmul_l1": sum(
            r["launches"]["precise_matmul"] for r in
            rec["mnist"]["runs"] + [rec["restful"]]),
        "lrn_fwd": rec["alexnet"]["launches"]["lrn_fwd"] +
        rec["fleet"]["launches"]["lrn_fwd"],
        "flash_attention_fwd":
            rec["attention"]["launches"]["flash_attention_fwd"]}
    _log("3f launches: %s" % rec["launches"])
    return rec


# -- phase 4e: graph mode (slice 17) ------------------------------------------

#: graph MNIST's best validation error against phase 4's fused
#: ``precise_gemm=1`` run, in percentage points
GRAPH_MNIST_ERROR_PP = 0.2
#: fused against graph mode on the card: the JAX tests' own limits
#: (tests/test_standard_workflow.py: weights 2e-4, best rmse 1e-3)
GRAPH_FUSED_WEIGHT_ATOL = 2e-4
GRAPH_FUSED_RMSE_ATOL = 1e-3
#: the LRN convnet's first train steps whose dropout masks are held card
#: against CPU, on a cut dataset (widths untouched)
GRAPH_MASK_STEPS = 2
GRAPH_MASK_LOADER = {"n_train": 300, "n_valid": 100}
#: the MSE regression workflow of tests/test_standard_workflow.py:133-178
#: (x in [-1, 1)^6 -> tanh(x W) + noise, 150 train + 50 valid, minibatch
#: 40, tanh 16 -> linear 3, lr 0.1, momentum 0.9, weights seed 13), with
#: every All2All forward on K4
MSE_GD = {"learning_rate": 0.1, "gradient_moment": 0.9}
MSE_LAYERS = (
    {"type": "all2all_tanh",
     "->": {"output_sample_shape": 16, "precise_gemm": 1}, "<-": MSE_GD},
    {"type": "all2all", "->": {"output_sample_shape": 3, "precise_gemm": 1},
     "<-": MSE_GD})
MSE_EPOCHS = 3


def _graph_loss(wf):
    """Graph mode's loss of the minibatch just evaluated, a device
    scalar, as the fused step defines it: the softmax evaluator's; for
    MSE, whose evaluator keeps no loss, half the squared error summed
    over a sample's features, averaged over the valid samples
    (``EvaluatorMSE.loss_from_output``), from their mean squared
    errors."""
    ev = wf.evaluator
    if wf.loss_function == "mse":
        return (ev.mse.devmem ** 2).mean() * (0.5 * ev.err_output.devmem[0]
                                              .numel())
    return ev.loss


def _graph_instrument(wf, counters):
    """``_instrument`` for graph mode; -> (record, close).  A graph step
    is everything from one loader run to the next (the forwards, the
    evaluator, the decision, the GD units), so each loader run closes the
    step before it and ``close()`` (after ``wf.run``) the last.  An
    epoch ends once its last step's GD units ran: its time, n_err and
    (the first's) weights are taken there."""
    from veles_tpu_torch.loader import TRAIN, VALID
    rec = {"epoch_end": [], "first_epoch": None,
           "steps": {TRAIN: 0, VALID: 0}, "train_loss": [[]],
           "launches": {name: {TRAIN: 0, VALID: 0} for name in counters}}
    loader, decision = wf.loader, wf.decision
    loader_run = loader.run
    open_step = {}

    def close():
        if not open_step:
            return
        cls = open_step["cls"]
        rec["steps"][cls] += 1
        for name, fn in counters.items():
            rec["launches"][name][cls] += \
                fn.launches - open_step["launches"][name]
        if cls == TRAIN:     # a device scalar: read at the end, no sync
            rec["train_loss"][-1].append(_graph_loss(wf))
        if open_step["epoch_ended"]:
            rec["epoch_end"].append(time.perf_counter())
            rec["train_loss"].append([])
            if rec["first_epoch"] is None:
                rec["first_epoch"] = {
                    "n_err": _epoch_metric(wf),
                    "weights": host_weights(wf)}
        open_step.clear()

    def run():
        close()
        loader_run()
        open_step.update(
            cls=loader.minibatch_class, epoch_ended=bool(loader.epoch_ended),
            launches={name: fn.launches for name, fn in counters.items()})

    loader.run = run
    return rec, close


def _gd_launches(wf, counters):
    """Count the launches of ``counters`` made inside the GD units' runs
    (-> a live {name: count})."""
    inside = {name: 0 for name in counters}
    for gd in wf.gds:
        def run(gd_run=gd.run):
            before = {name: fn.launches for name, fn in counters.items()}
            gd_run()
            for name, fn in counters.items():
                inside[name] += fn.launches - before[name]
        gd.run = run
    return inside


def _want_launches(label, out, want):
    """Refuse per train / eval step launches other than ``want``."""
    if out["launches_per_train_eval_step"] != want:
        raise AssertionError("%s (graph mode): launches per train / eval "
                             "step %r, want %r" % (
                                 label, out["launches_per_train_eval_step"],
                                 want))


def _max_diff(a, b):
    return max(float(numpy.abs(x[k] - y[k]).max())
               for x, y in zip(a, b) for k in y)


def _max_rel_diff(a, b):
    """max over the tensors of ``b`` of |a - b| against max|b|."""
    return max(float(numpy.abs(x[k] - y[k]).max()) /
               float(numpy.abs(y[k]).max()) for x, y in zip(a, b) for k in y)


def graph_mnist_run(torch, gemm, card, fused_run):
    """(a) MNIST at the gate's settings in graph mode with
    ``precise_gemm=1`` on the card: K4 once per All2All forward of every
    train and eval step and never inside a GD unit; the first epoch held
    against graph mode on the CPU; the best validation error within
    ``GRAPH_MNIST_ERROR_PP`` of phase 4's fused run (``fused_run``)."""
    t0 = time.perf_counter()
    wf = _mnist_workflow(1, fused=False)
    init_s = time.perf_counter() - t0
    out = _train_record(torch, wf, {"k4": gemm.precise_matmul},
                        "MNIST precise_gemm=1", card, init_s, "images")
    n_fc = len(wf.forwards)
    _want_launches("MNIST", out, {"k4": (n_fc, n_fc)})
    if out["gd_launches"]["k4"]:
        raise AssertionError("graph MNIST: %d K4 launches inside GD units"
                             % out["gd_launches"]["k4"])
    gap = abs(out["best_validation_error_pt"] -
              fused_run["best_validation_error_pt"])
    out["fused_best_validation_error_pt"] = \
        fused_run["best_validation_error_pt"]
    out["fused_train_images_s_median"] = fused_run["train_images_s_median"]
    _log("train MNIST precise_gemm=1: graph mode %.1f train images/s "
         "(median epoch after the first) beside fused %.1f (phase 4's "
         "median epoch); best validation error graph %.2f%% fused %.2f%% "
         "(limit %.1f points apart) [%s]"
         % (out["train_samples_s_median"],
            fused_run["train_images_s_median"],
            out["best_validation_error_pt"],
            fused_run["best_validation_error_pt"], GRAPH_MNIST_ERROR_PP,
            card))
    if not gap <= GRAPH_MNIST_ERROR_PP:
        raise AssertionError("graph MNIST's best validation error is %.2f "
                             "points from the fused run's" % gap)
    cpu = _mnist_workflow(1, device="cpu", epochs=1, fused=False)
    rec, close = _graph_instrument(cpu, {"k4": gemm.precise_matmul})
    t0 = time.perf_counter()
    cpu.run()
    close()
    out["first_epoch_vs_cpu"] = _first_epochs_agree(
        "MNIST precise_gemm=1 graph mode", out.pop("first_epoch"),
        rec["first_epoch"], time.perf_counter() - t0)
    return out


def graph_train_steps(wf, n):
    """Run graph mode's units by hand through the first ``n`` train
    minibatches (validation minibatches are served and skipped); ->
    (losses, the dropout layers' keys after each step)."""
    from veles_tpu_torch.loader import TRAIN
    losses, keys = [], []
    for _ in range(n):
        while True:
            wf.loader.run()
            if wf.loader.minibatch_class == TRAIN:
                break
        for fwd in wf.forwards:
            fwd.run()
        wf.evaluator.run()
        for gd in reversed(wf.gds):
            gd.run()
        losses.append(float(_graph_loss(wf)))
        keys.append([f.last_key for f in wf.forwards if f.stochastic])
    return losses, keys


def graph_lrn_net_run(torch, lrn_mod, card):
    """(b) The LRN convnet of phase 4d in graph mode: K5 once per LRN
    forward, K6 once per LRN backward on train steps, the gate; then the
    first ``GRAPH_MASK_STEPS`` train steps on the card and on the CPU:
    each dropout mask drawn on the card equal to the CPU's bit for bit,
    losses and weights within ``steps_agree``'s limits."""
    t0 = time.perf_counter()
    wf = lrn_net_workflow(fused=False)
    init_s = time.perf_counter() - t0
    out = _train_record(torch, wf, _lrn_counters(lrn_mod), "LRN convnet",
                        card, init_s, "images")
    out.pop("first_epoch")
    _want_launches("the LRN convnet", out, {"K5": (2, 2), "K6": (2, 0)})
    if not out["best_validation_error_pt"] < LRN_NET_GATE_PT:
        raise AssertionError("the LRN convnet missed its gate in graph "
                             "mode: %.2f%%" % out["best_validation_error_pt"])
    steps = {}
    for dev in ("cuda", "cpu"):
        net = lrn_net_workflow(dev, fused=False, **GRAPH_MASK_LOADER)
        t0 = time.perf_counter()
        losses, keys = graph_train_steps(net, GRAPH_MASK_STEPS)
        steps[dev] = (net, losses, keys, time.perf_counter() - t0)
    (card_wf, card_losses, card_keys, _), (cpu_wf, cpu_losses, cpu_keys,
                                           cpu_s) = steps["cuda"], \
        steps["cpu"]
    loss_diff, w_diff = steps_agree("LRN convnet graph mode", card_losses,
                                    host_weights(card_wf), cpu_losses,
                                    host_weights(cpu_wf))
    drop = [f for f in card_wf.forwards if f.stochastic]
    if card_keys != cpu_keys or len(drop) != 1:
        raise AssertionError("graph mode's dropout keys differ: card %r "
                             "cpu %r" % (card_keys, cpu_keys))
    masks = 0
    shape = tuple(drop[0].output.shape)
    for (key,) in card_keys:
        on_card = drop[0].mask(key, shape, "cuda").cpu()
        if not torch.equal(on_card, drop[0].mask(key, shape, "cpu")):
            raise AssertionError("a graph-mode dropout mask on the card "
                                 "differs from the CPU's")
        masks += 1
    out["first_steps_vs_cpu"] = {
        "steps": GRAPH_MASK_STEPS, "card_losses": card_losses,
        "cpu_losses": cpu_losses, "loss_rel_diff": loss_diff,
        "weight_rel_diff": w_diff, "dropout_masks_equal": masks,
        "cpu_seconds": cpu_s}
    _log("train LRN convnet graph mode: first %d train steps card vs CPU: "
         "losses card %s cpu %s (rel diff %.3g), weights rel diff %.3g; "
         "%d dropout masks equal bit for bit; CPU %.3f s"
         % (GRAPH_MASK_STEPS, card_losses, cpu_losses, loss_diff, w_diff,
            masks, cpu_s))
    return out


def graph_attention_run(torch, fa, card, label, causal, window):
    """(c) The attention unit at phase 4b's full width in graph mode:
    K7, K8 and K9 once each a train step (the forward's run launches K7,
    the GD unit's K8 and K9 on the kept graph), K7 once an eval step;
    then the first epoch cut to ``ATTN_CPU_N`` sequences (``use_pallas=
    True``) in graph mode on the card, on the CPU and in fused mode on
    the card: n_err within 1 and weights within 1e-4 against the CPU,
    weights within ``GRAPH_FUSED_WEIGHT_ATOL`` against fused mode."""
    t0 = time.perf_counter()
    wf = attention_workflow(ATTN_N, ATTN_T, ATTN_D, ATTN_HEADS, causal,
                            window, fused=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counters = _flash_counters(fa)
    out = _train_record(torch, wf, counters, label, card, init_s,
                        "sequences")
    out.pop("first_epoch")
    _want_launches(label, out, {"K7": (1, 1), "K8": (1, 0), "K9": (1, 0)})
    first = {}
    for device, fused in (("cuda", False), ("cpu", False), ("cuda", True)):
        cut = attention_workflow(ATTN_CPU_N, ATTN_T, ATTN_D, ATTN_HEADS,
                                 causal, window, epochs=1, device=device,
                                 use_pallas=True, n_valid=ATTN_CPU_VALID,
                                 fused=fused)
        t0 = time.perf_counter()
        if fused:
            rec = _instrument(cut, counters)
            cut.run()
        else:
            rec, close = _graph_instrument(cut, counters)
            cut.run()
            close()
        first[device, fused] = (rec["first_epoch"],
                                time.perf_counter() - t0)
    out["first_epoch_vs_cpu"] = _first_epochs_agree(
        label + " graph mode (%d sequences)" % ATTN_CPU_N,
        first["cuda", False][0], first["cpu", False][0],
        first["cpu", False][1])
    fused_diff = _max_diff(first["cuda", False][0]["weights"],
                           first["cuda", True][0]["weights"])
    out["first_epoch_vs_fused_max_weight_diff"] = fused_diff
    _log("train %s: first epoch (%d sequences) graph against fused mode on "
         "the card: max|w_graph - w_fused| = %.3g (limit %g); n_err graph "
         "%s fused %s" % (label, ATTN_CPU_N, fused_diff,
                          GRAPH_FUSED_WEIGHT_ATOL,
                          first["cuda", False][0]["n_err"],
                          first["cuda", True][0]["n_err"]))
    if not fused_diff <= GRAPH_FUSED_WEIGHT_ATOL:
        raise AssertionError("%s: graph and fused mode's first epochs "
                             "differ on the card" % label)
    return out


def regression_loader():
    """The MSE regression data of the JAX package's
    tests/test_standard_workflow.py as a port FullBatchLoaderMSE."""
    from veles_tpu_torch.loader import TEST, TRAIN, VALID
    from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE

    class RegressionLoader(FullBatchLoaderMSE):
        def load_data(self):
            rng = numpy.random.RandomState(11)
            x = rng.uniform(-1, 1, (200, 6)).astype(numpy.float32)
            w = rng.standard_normal((6, 3)).astype(numpy.float32)
            t = numpy.tanh(x @ w) + 0.05 * rng.standard_normal(
                (200, 3)).astype(numpy.float32)
            self.original_data.mem = x
            self.original_targets.mem = t.astype(numpy.float32)
            self.class_lengths[TEST] = 0
            self.class_lengths[VALID] = 50
            self.class_lengths[TRAIN] = 150

    return RegressionLoader


def mse_workflow(fused, device="cuda", epochs=MSE_EPOCHS):
    """The MSE regression ``StandardWorkflow`` (``MSE_LAYERS``, weights
    seed 13, loader seed 5) on ``device``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    prng.get().seed(13)
    wf = StandardWorkflow(
        None, name="std_mse", loader_factory=regression_loader(),
        loader={"minibatch_size": 40, "prng": RandomGenerator().seed(5)},
        layers=[dict(layer) for layer in MSE_LAYERS], loss_function="mse",
        decision={"max_epochs": epochs, "silent": True}, fused=fused)
    wf.initialize(device=Device(backend=device))
    return _on(wf, device)


def graph_mse_run(torch, gemm, card):
    """(d) The MSE regression workflow in graph and in fused mode on the
    card, ``precise_gemm=1``: weights within ``GRAPH_FUSED_WEIGHT_ATOL``,
    best rmse within ``GRAPH_FUSED_RMSE_ATOL``."""
    runs = {}
    for fused in (False, True):
        wf = mse_workflow(fused)
        gemm.precise_matmul.launches = 0
        t0 = time.perf_counter()
        wf.run()
        torch.cuda.synchronize()
        runs[fused] = {"seconds": time.perf_counter() - t0,
                       "best_rmse": wf.decision.best_rmse,
                       "k4_launches": gemm.precise_matmul.launches,
                       "weights": host_weights(wf)}
    w_diff = _max_diff(runs[False]["weights"], runs[True]["weights"])
    rmse_diff = abs(runs[False]["best_rmse"] - runs[True]["best_rmse"])
    out = {"label": "MSE regression", "card": card,
           "graph_best_rmse": runs[False]["best_rmse"],
           "fused_best_rmse": runs[True]["best_rmse"],
           "max_weight_diff": w_diff,
           "graph_seconds": runs[False]["seconds"],
           "fused_seconds": runs[True]["seconds"],
           "graph_k4_launches": runs[False]["k4_launches"],
           "fused_k4_launches": runs[True]["k4_launches"]}
    _log("train MSE regression (precise_gemm=1, %d epochs): best rmse graph "
         "%.6f fused %.6f (limit %g apart); max|w_graph - w_fused| = %.3g "
         "(limit %g); K4 launches graph %d fused %d; %.3f / %.3f s [%s]"
         % (MSE_EPOCHS, out["graph_best_rmse"], out["fused_best_rmse"],
            GRAPH_FUSED_RMSE_ATOL, w_diff, GRAPH_FUSED_WEIGHT_ATOL,
            out["graph_k4_launches"], out["fused_k4_launches"],
            out["graph_seconds"], out["fused_seconds"], card))
    if not (w_diff <= GRAPH_FUSED_WEIGHT_ATOL and
            rmse_diff <= GRAPH_FUSED_RMSE_ATOL):
        raise AssertionError("MSE: graph and fused mode differ on the card")
    if not (out["graph_k4_launches"] and out["fused_k4_launches"]):
        raise AssertionError("MSE: a run launched no K4")
    return out


#: the loader's two paths in graph mode on the card: train steps of the
#: full-width attention unit (no mask) on ``LOADER_PATH_N`` sequences,
#: the host path (``force_numpy``) and the device gather in turns
LOADER_PATH_N, LOADER_PATH_STEPS = 96, 8


def loader_paths_run(torch, card):
    """(e) ``LOADER_PATH_STEPS`` graph-mode train steps of the attention
    unit at full width with the loader's host path (``fill_minibatch``:
    a 33.5 MB minibatch gathered on the host and uploaded) and with its
    device gather, in turns (host, device, device, host); -> record of
    each path's train sequences/s."""
    wf = attention_workflow(LOADER_PATH_N, ATTN_T, ATTN_D, ATTN_HEADS,
                            fused=False)
    graph_train_steps(wf, 2)          # cuBLAS's and the kernels' first calls
    seconds = {"host": [], "device": []}
    for host in (True, False, False, True):
        wf.loader.force_numpy = host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph_train_steps(wf, LOADER_PATH_STEPS)
        torch.cuda.synchronize()
        seconds["host" if host else "device"].append(
            time.perf_counter() - t0)
    rate = {path: LOADER_PATH_STEPS * ATTN_MINIBATCH / statistics.fmean(t)
            for path, t in seconds.items()}
    _log("train attention graph mode, the loader's paths: %d train steps "
         "(minibatch %d of [%d, %d]) in turns host %s s, device %s s: "
         "%.1f train sequences/s on the host path, %.1f with the device "
         "gather [%s]" % (LOADER_PATH_STEPS, ATTN_MINIBATCH, ATTN_T, ATTN_D,
                          " ".join("%.4f" % t for t in seconds["host"]),
                          " ".join("%.4f" % t for t in seconds["device"]),
                          rate["host"], rate["device"], card))
    return {"label": "loader paths", "card": card, "seconds": seconds,
            "train_seq_s": rate}


def graph_phase(torch, gemm, lrn_mod, fa, card, fused_mnist):
    """Phase 4e: (a)-(d), each part's wall time printed; -> record."""
    out, seconds = {}, {}
    parts = (
        ("mnist", lambda: graph_mnist_run(torch, gemm, card, fused_mnist)),
        ("lrn_convnet", lambda: graph_lrn_net_run(torch, lrn_mod, card)),
        ("attention", lambda: [graph_attention_run(torch, fa, card, *config)
                               for config in ATTN_CONFIGS]),
        ("mse", lambda: graph_mse_run(torch, gemm, card)),
        ("loader_paths", lambda: loader_paths_run(torch, card)))
    for name, part in parts:
        t0 = time.perf_counter()
        out[name] = part()
        seconds[name] = time.perf_counter() - t0
        _log("phase 4e %s: %.1f s" % (name, seconds[name]))
    out["part_seconds"] = seconds
    return out


def trace_graph_train(torch, card):
    """One graph-mode MNIST epoch (``precise_gemm=1``) under
    ``torch.profiler``."""
    return _traced(torch, "train graph precise_gemm=1", card,
                   lambda: _epoch(_mnist_workflow(1, epochs=1, fused=False)))


# -- phase 4f: snapshots and sharded data (slice 20) --------------------------

#: (a) MNIST: epochs before the snapshot, and in all
SNAP_MNIST_EPOCHS = (3, 6)
#: (b) AlexNet at its published widths on 512 + 128 images, minibatch 128
SNAP_ALEX_LOADER = {"n_train": 512, "n_valid": 128, "minibatch_size": 128}
#: (c) the full-width attention net on 16 + 8 sequences, minibatch 8
SNAP_ATTN_N, SNAP_ATTN_VALID = 24, 8
#: (b) losses (relative) and parameters (of each tensor's largest
#: magnitude): cuDNN's f32 algorithms may differ between processes
SNAP_ALEX_RTOL = 1e-4
#: (d) rows a shard; the window holds a third of the data
SNAP_SHARD_ROWS = 1000
SNAP_CHILD_TIMEOUT = 600
#: where the phase trains and resumes (a rehearsal sets "cpu")
SNAP_DEVICE = "cuda"
#: the kernels line's names of the counters
SNAP_LINE_NAMES = {"K4": "precise_matmul_l1", "K5": "lrn_fwd",
                   "K6": "lrn_bwd", "K7": "flash_attention_fwd",
                   "K8": "flash_attention_dq", "K9": "flash_attention_dkv"}


def _snap_counters(kind):
    """The kernel wrappers (each with its ``launches`` count) of a
    part: "k4", "lrn" or "flash"."""
    from veles_tpu_torch.znicz import flash_attention as fa
    from veles_tpu_torch.znicz import gemm
    from veles_tpu_torch.znicz import lrn as lrn_mod
    if kind == "k4":
        return {"K4": gemm.precise_matmul}
    return _lrn_counters(lrn_mod) if kind == "lrn" else _flash_counters(fa)


def _transient(fn):
    """Mark an instrumentation wrapper installed over a unit's method
    transient: a snapshot drops it (``Pickleable.__getstate__``)."""
    fn.transient_ = True
    return fn


def _snap_instrument(wf, counters, masks=False):
    """Steps and launches of each class, the fused step's train losses,
    the shard window's largest fill and (``masks``) every dropout keep
    mask drawn, through transient wrappers, so the workflow still
    snapshots; -> (record, close).  A step is everything from one
    loader run to the next; ``close()`` ends the last."""
    from veles_tpu_torch.loader import TRAIN, VALID
    from veles_tpu_torch.znicz.dropout import DropoutForward
    rec = {"steps": {TRAIN: 0, VALID: 0},
           "launches": {n: {TRAIN: 0, VALID: 0} for n in counters},
           "losses": [], "masks": [], "window_max": 0}
    loader, step = wf.loader, {}
    loader_run = loader.run

    def close():
        if step:
            cls = step.pop("cls")
            rec["steps"][cls] += 1
            for name, fn in counters.items():
                rec["launches"][name][cls] += fn.launches - step[name]
            step.clear()

    def run():
        close()
        loader_run()
        rec["window_max"] = max(rec["window_max"],
                                getattr(loader, "window_used_bytes", 0))
        step.update({n: fn.launches for n, fn in counters.items()},
                    cls=loader.minibatch_class)

    loader.run = _transient(run)
    fused = wf.fused_step
    if fused is not None:
        fused_run = fused.run

        def step_run():
            fused_run()
            if fused.minibatch_class == TRAIN:  # a device scalar: no sync
                rec["losses"].append(fused.loss)

        fused.run = _transient(step_run)
    for fwd in wf.forwards if masks else ():
        if isinstance(fwd, DropoutForward):
            def record(params, x, key, fwd=fwd, apply_train=fwd.apply_train):
                rec["masks"].append(fwd.mask(key, x.shape, x.device))
                return apply_train(params, x, key)

            fwd.apply_train = _transient(record)
    return rec, close


def _snap_summary(rec, wf):
    """A JSON-able record of a run instrumented by ``_snap_instrument``:
    [train, eval] steps and launches, losses, the masks' sha256, the
    decision's per-class n_err, the loader's epoch."""
    import hashlib
    from veles_tpu_torch.loader import TRAIN, VALID
    return {"steps": [rec["steps"][TRAIN], rec["steps"][VALID]],
            "launches": {n: [c[TRAIN], c[VALID]]
                         for n, c in rec["launches"].items()},
            "losses": [float(x) for x in rec["losses"]],
            "masks": [hashlib.sha256(m.cpu().numpy().tobytes()).hexdigest()
                      for m in rec["masks"]],
            "window_max": rec["window_max"],
            "epoch_n_err": list(wf.decision.epoch_n_err),
            "epoch_n_err_pt": list(wf.decision.epoch_n_err_pt),
            "best_n_err": wf.decision.best_n_err,
            "epoch_number": wf.loader.epoch_number}


def resume_child(spec_path):
    """The fresh process of phase 4f: for each job of the spec, restore
    its snapshot, run it to ``max_epochs`` on its device with the
    kernels' counts from 0, write its weights (``.npz``) and a record
    (JSON).  Imports only the port."""
    import torch
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.snapshotter import restore
    with open(spec_path) as f:
        spec = json.load(f)
    out = []
    for job in spec["jobs"]:
        counters = _snap_counters(job["counters"])
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        wf = restore(job["path"])
        restore_s = time.perf_counter() - t0
        wf.decision.max_epochs = job["max_epochs"]
        if job.get("interval"):
            wf.snapshotter.interval = job["interval"]
        wf.initialize(device=Device(backend=job["device"]))
        rec, close = _snap_instrument(wf, counters, job.get("masks"))
        t0 = time.perf_counter()
        wf.run()
        close()
        if job["device"] == "cuda":
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        numpy.savez(job["weights"], **{
            "%d.%s" % (i, k): v for i, layer in enumerate(host_weights(wf))
            for k, v in layer.items()})
        summary = _snap_summary(rec, wf)
        summary.update(
            label=job["label"], restore_s=restore_s, run_s=run_s,
            restored=wf.restored_from_snapshot,
            device=str(wf.forwards[0].weights.devmem.device),
            cuda_visible=torch.cuda.is_available(),
            launches_total={n: fn.launches for n, fn in counters.items()},
            foreign=sorted(m for m in sys.modules if m.split(".")[0] in
                           ("jax", "jaxlib", "veles_tpu")))
        out.append(summary)
        del wf
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    return 0


def _run_child(jobs, tmp, label, env=None):
    """Run ``jobs`` in one fresh process (``--resume-child``); -> (its
    records with their weights, wall seconds)."""
    spec = os.path.join(tmp, "child-%s.json" % re.sub(r"\W+", "-", label))
    with open(spec, "w") as f:
        json.dump({"jobs": jobs, "result": spec + ".out"}, f)
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, here, "--resume-child", spec],
        cwd=os.path.dirname(here), env=env, capture_output=True, text=True,
        timeout=SNAP_CHILD_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("%s: the fresh process exited %d:\n%s"
                             % (label, proc.returncode, proc.stderr[-6000:]))
    with open(spec + ".out") as f:
        out = json.load(f)
    for job, res in zip(jobs, out, strict=True):
        if res["foreign"]:
            raise AssertionError("%s: the fresh process imported %s"
                                 % (label, res["foreign"]))
        if not res["restored"]:
            raise AssertionError("%s: not a restored workflow" % label)
        with numpy.load(job["weights"]) as z:
            layers = {}
            for key in z.files:
                i, name = key.split(".", 1)
                layers.setdefault(int(i), {})[name] = z[key]
        res["weights"] = [layers.get(i, {}) for i in range(max(layers) + 1)]
    return out, wall


def _snap_ref(torch, wf, counters, masks=False):
    """Run an uninterrupted (or snapshotting) workflow with its kernels'
    counts from 0; -> its summary with weights and wall seconds."""
    rec, close = _snap_instrument(wf, counters, masks)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf.run()
    close()
    if SNAP_DEVICE == "cuda":
        torch.cuda.synchronize()
    out = _snap_summary(rec, wf)
    out.update(run_s=time.perf_counter() - t0, weights=host_weights(wf),
               launches_total={n: fn.launches for n, fn in counters.items()})
    return out


def _per_step(label, res, want):
    """Refuse launches of each class other than ``want`` ({name: (per
    train step, per eval step)}) a step."""
    train, evals = res["steps"]
    for name, (per_train, per_eval) in want.items():
        got = res["launches"][name]
        if got != [per_train * train, per_eval * evals] or not train:
            raise AssertionError(
                "%s: %s launched %r over %d train + %d eval steps, want %d "
                "and %d a step" % (label, name, got, train, evals,
                                   per_train, per_eval))


def _bitwise(label, got, want):
    """Refuse any parameter that is not the reference's bit for bit."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for name in w:
            if not numpy.array_equal(g[name], w[name]):
                raise AssertionError(
                    "%s: layer %d %s differs, max |diff| %g" % (
                        label, i, name,
                        float(numpy.abs(g[name] - w[name]).max())))


def _add_launches(total, *records):
    for rec in records:
        for name, n in rec["launches_total"].items():
            total[SNAP_LINE_NAMES[name]] = \
                total.get(SNAP_LINE_NAMES[name], 0) + n


def snap_mnist_part(torch, card, tmp, total):
    """(a) MNIST at the gate's settings with ``precise_gemm=1``: 6
    epochs uninterrupted, and 3 with ``SnapshotterToFile`` (async, gz)
    restored in a fresh process to 6, fused and graph mode; the card's
    fused snapshot also restored on the CPU (CUDA hidden)."""
    first, last = SNAP_MNIST_EPOCHS
    counters = _snap_counters("k4")
    refs, jobs, parts = {}, [], {}
    for fused in (True, False):
        mode = "fused" if fused else "graph"
        refs[mode] = _snap_ref(torch, _mnist_workflow(
            1, SNAP_DEVICE, epochs=last, fused=fused), counters)
        d = os.path.join(tmp, "mnist-" + mode)
        parts[mode] = _snap_ref(torch, _mnist_workflow(
            1, SNAP_DEVICE, epochs=first, fused=fused, snapshotter={
                "prefix": "mnist", "directory": d, "time_interval": 0,
                "compression": "gz", "async_write": True}), counters)
        jobs.append({"label": "mnist " + mode, "max_epochs": last,
                     "path": os.path.join(d, "mnist_current"),
                     "device": SNAP_DEVICE, "counters": "k4",
                     "weights": os.path.join(tmp, "mnist-%s.npz" % mode)})
    resumed, wall = _run_child(jobs, tmp, "mnist")
    cpu_job = dict(jobs[0], label="mnist fused on the CPU", device="cpu",
                   weights=os.path.join(tmp, "mnist-cpu.npz"))
    (cpu,), cpu_wall = _run_child([cpu_job], tmp, "mnist cpu", env=dict(
        os.environ, CUDA_VISIBLE_DEVICES=""))
    _add_launches(total, *refs.values(), *parts.values(), *resumed, cpu)
    out = {"card": card, "fresh_process_s": wall, "cpu_process_s": cpu_wall}
    for (mode, ref), res in zip(refs.items(), resumed):
        label = "4f(a) mnist %s" % mode
        if not res["device"].startswith(SNAP_DEVICE):
            raise AssertionError("%s: resumed on %s" % (label, res["device"]))
        _bitwise(label, res["weights"], ref["weights"])
        if res["epoch_n_err_pt"] != ref["epoch_n_err_pt"] or \
                res["epoch_number"] != ref["epoch_number"]:
            raise AssertionError("%s: epoch_n_err_pt %r epoch %d, want %r "
                                 "epoch %d" % (label, res["epoch_n_err_pt"],
                                               res["epoch_number"],
                                               ref["epoch_n_err_pt"],
                                               ref["epoch_number"]))
        _per_step(label, res, {"K4": (5, 2) if mode == "fused" else (2, 2)})
        out[mode] = {k: res[k] for k in ("steps", "launches", "restore_s",
                                         "run_s", "epoch_n_err_pt")}
        out[mode]["uninterrupted_s"] = ref["run_s"]
        _log("4f(a) mnist %s: resumed from epoch %d of %d in a fresh "
             "process: weights, bias and epoch_n_err_pt %s bit for bit the "
             "uninterrupted run's; K4 %s over [train, eval] steps %s; "
             "restore %.4f s, run %.3f s (uninterrupted %.3f s) [%s]"
             % (mode, first, last, res["epoch_n_err_pt"],
                res["launches"]["K4"], res["steps"], res["restore_s"],
                res["run_s"], ref["run_s"], card))
    card_fused = resumed[0]
    n_diff = max(abs(a - b) for a, b in zip(cpu["epoch_n_err"],
                                            card_fused["epoch_n_err"]))
    w_diff = _max_diff(cpu["weights"], card_fused["weights"])
    _log("4f(a) mnist: the card's snapshot resumed on the CPU (CUDA hidden, "
         "K4 launches %d): n_err %s against the card's %s, max|w_cpu - "
         "w_card| = %.3g (limit %g), %.3f s" % (
             cpu["launches_total"]["K4"], cpu["epoch_n_err"],
             card_fused["epoch_n_err"], w_diff, FIRST_EPOCH_WEIGHT_ATOL,
             cpu["run_s"]))
    if cpu["cuda_visible"] or not cpu["device"] == "cpu" or \
            cpu["launches_total"]["K4"] or n_diff > 1 or \
            not w_diff <= FIRST_EPOCH_WEIGHT_ATOL:
        raise AssertionError("4f(a): the CPU resume differs from the card's")
    out["cpu"] = {"epoch_n_err": cpu["epoch_n_err"], "max_weight_diff": w_diff,
                  "run_s": cpu["run_s"]}
    out["fullbatch_3_epochs"] = parts["fused"]
    out["uninterrupted_fused"] = refs["fused"]
    return out


def snap_alexnet_part(torch, card, tmp, total):
    """(b) AlexNet at its published widths: 2 epochs uninterrupted, and
    1 with ``SnapshotterToShards`` (default chunk) shot at its end and
    restored in a fresh process for the second."""
    from veles_tpu_torch.mutable import Bool
    counters = _snap_counters("lrn")
    ref = _snap_ref(torch, alexnet_workflow(SNAP_DEVICE, epochs=2,
                                            **SNAP_ALEX_LOADER),
                    counters, masks=True)
    d = os.path.join(tmp, "alexnet")
    part = alexnet_workflow(SNAP_DEVICE, epochs=1, snapshotter={
        "prefix": "alexnet", "directory": d, "time_interval": 0,
        "format": "shards", "interval": 2}, **SNAP_ALEX_LOADER)
    first = _snap_ref(torch, part, counters)
    snap = part.snapshotter
    snap.skip = Bool(False)
    snap.run()                 # the 2nd call: a shot of epoch 1's end
    if not snap.flush(timeout=300):
        raise AssertionError("4f(b): the writer did not drain: %r"
                             % snap._writer_.take_failure())
    from veles_tpu_torch.checkpoint import open_checkpoint
    stats = dict(snap._last_write_stats_)
    chunks = len(os.listdir(os.path.join(d, "chunks")))
    n_params = sum(v.size for layer in first["weights"]
                   for v in layer.values())
    data_shape = list(part.loader.original_data.shape)
    data_bytes = part.loader.original_data.nbytes
    _, man, _ = open_checkpoint(snap.destination)
    if not stats["bytes_total"] >= 2 * 4 * n_params or \
            data_shape in [e["shape"] for e in man.tensors.values()]:
        raise AssertionError("4f(b): a checkpoint of %d bytes for %d "
                             "parameters and their momentum, tensors %s"
                             % (stats["bytes_total"], n_params,
                                sorted(e["shape"]
                                       for e in man.tensors.values())))
    shot = {"bytes_total": stats["bytes_total"],
            "bytes_written": stats["bytes_written"], "chunks": chunks,
            "stall_s": snap.last_stall_s, "save_s": snap.last_write_s,
            "params": n_params}
    del part, snap
    torch.cuda.empty_cache()
    (res,), wall = _run_child([{
        "label": "alexnet", "max_epochs": 2, "device": SNAP_DEVICE,
        "path": os.path.join(d, "alexnet_current"), "counters": "lrn",
        "masks": True, "interval": 10 ** 9,
        "weights": os.path.join(tmp, "alexnet.npz")}], tmp, "alexnet")
    _add_launches(total, ref, first, res)
    label = "4f(b) alexnet"
    _per_step(label, res, {"K5": (2, 2), "K6": (2, 0)})
    n = len(res["masks"])
    if not n or res["masks"] != ref["masks"][-n:]:
        raise AssertionError("%s: %d dropout masks, %d equal to the "
                             "uninterrupted run's last" % (
                                 label, n, sum(a == b for a, b in zip(
                                     res["masks"], ref["masks"][-n:]))))
    loss_diff, w_diff = steps_agree(
        label, res["losses"], res["weights"],
        ref["losses"][-len(res["losses"]):], ref["weights"])
    _log("4f(b) alexnet: epoch 2 resumed in a fresh process: %d dropout "
         "masks bit for bit, losses within %.3g relative, parameters within "
         "%.3g of their largest magnitude (limits %g); K5 / K6 %s / %s over "
         "[train, eval] steps %s; checkpoint %d bytes (%d new) in %d chunks "
         "(%d parameters and their momentum; the %d bytes of data not in "
         "it), capture stall %.4f s, writer save %.3f s, restore %.3f s, "
         "epoch run %.3f s, process %.1f s [%s]" % (
             n, loss_diff, w_diff, SNAP_ALEX_RTOL, res["launches"]["K5"],
             res["launches"]["K6"], res["steps"], stats["bytes_total"],
             stats["bytes_written"], chunks, n_params, data_bytes,
             shot["stall_s"], shot["save_s"], res["restore_s"], res["run_s"],
             wall, card))
    shot.update(restore_s=res["restore_s"], run_s=res["run_s"],
                fresh_process_s=wall, masks=n, loss_rel_diff=loss_diff,
                weight_rel_diff=w_diff, steps=res["steps"],
                launches=res["launches"])
    return shot


def snap_attention_part(torch, card, tmp, total):
    """(c) Phase 4b's full-width attention net (no mask) on 16 + 8
    sequences: 2 epochs uninterrupted, and 1 with ``SnapshotterToDB``
    (SQLite) shot at its end and restored in a fresh process for the
    second: weights bit for bit."""
    from veles_tpu_torch.mutable import Bool
    counters = _snap_counters("flash")

    def make(epochs, snapshotter=None):
        return attention_workflow(SNAP_ATTN_N, ATTN_T, ATTN_D, ATTN_HEADS,
                                  n_valid=SNAP_ATTN_VALID, epochs=epochs,
                                  device=SNAP_DEVICE,
                                  snapshotter=snapshotter)

    ref = _snap_ref(torch, make(2), counters)
    db = os.path.join(tmp, "attention", "snapshots.sqlite3")
    part = make(1, {"prefix": "attention", "format": "db", "database": db,
                    "time_interval": 0, "interval": 2})
    first = _snap_ref(torch, part, counters)
    part.snapshotter.skip = Bool(False)
    part.snapshotter.run()
    if not part.snapshotter.flush(timeout=300):
        raise AssertionError("4f(c): the writer did not drain: %r"
                             % part.snapshotter._writer_.take_failure())
    path = part.snapshotter.destination
    del part
    (res,), wall = _run_child([{
        "label": "attention", "max_epochs": 2, "device": SNAP_DEVICE,
        "path": path, "counters": "flash", "interval": 10 ** 9,
        "weights": os.path.join(tmp, "attention.npz")}], tmp, "attention")
    _add_launches(total, ref, first, res)
    label = "4f(c) attention"
    _bitwise(label, res["weights"], ref["weights"])
    _per_step(label, res, {"K7": (1, 1), "K8": (1, 0), "K9": (1, 0)})
    _log("4f(c) attention: epoch 2 resumed from %s in a fresh process: "
         "weights bit for bit the uninterrupted run's; K7 / K8 / K9 %s / %s "
         "/ %s over [train, eval] steps %s; restore %.3f s, run %.3f s, "
         "process %.1f s [%s]" % (
             path.split("#")[0], res["launches"]["K7"], res["launches"]["K8"],
             res["launches"]["K9"], res["steps"], res["restore_s"],
             res["run_s"], wall, card))
    return {"steps": res["steps"], "launches": res["launches"],
            "restore_s": res["restore_s"], "run_s": res["run_s"],
            "fresh_process_s": wall}


def snap_shards_part(torch, card, tmp, total, fullbatch, uninterrupted):
    """(d) (a)'s fused ``precise_gemm=1`` MNIST for 3 epochs fed by a
    ``ShardedBatchLoader`` (the digits written by ``write_shards`` in
    shards of 1000 rows, a window of a third of the data, global
    shuffle): weights bit for bit the FullBatchLoader run's."""
    from veles_tpu_torch.loader import ShardedBatchLoader, write_shards
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.samples.mnist import MnistLoader
    probe = MnistLoader(Workflow(name="probe"), **GATE_LOADER)
    probe.load_data()
    data = numpy.asarray(probe.original_data.mem)
    path = os.path.join(tmp, "digits")
    write_shards(path, data, labels=probe.original_labels,
                 class_lengths=list(probe.class_lengths),
                 rows_per_shard=SNAP_SHARD_ROWS)
    budget = data.nbytes // 3
    first = SNAP_MNIST_EPOCHS[0]
    wf = _mnist_workflow(1, SNAP_DEVICE, epochs=first,
                         loader_factory=ShardedBatchLoader,
                         loader={"path": path, "window_bytes": budget,
                                 "shuffle_mode": "global"})
    if wf.fused_step._use_gather_:
        raise AssertionError("4f(d): the step gathers from a dataset")
    res = _snap_ref(torch, wf, _snap_counters("k4"))
    _add_launches(total, res)
    label = "4f(d) sharded mnist"
    _bitwise(label, res["weights"], fullbatch["weights"])
    _per_step(label, res, {"K4": (5, 2)})
    loads = wf.loader.shard_loads
    if not res["window_max"] <= budget or not loads > 0:
        raise AssertionError("%s: window %d of %d bytes, %d shard loads"
                             % (label, res["window_max"], budget, loads))
    rows = sum(wf.loader.class_lengths)
    rate = rows * first / res["run_s"]
    full_rate = rows * SNAP_MNIST_EPOCHS[1] / uninterrupted["run_s"]
    _log("4f(d) sharded mnist: %d epochs, weights bit for bit the "
         "FullBatchLoader run's; %d shards of %d rows, window at most %d of "
         "%d bytes, %d shard loads; K4 %s over [train, eval] steps %s; "
         "%.0f images/s (train + valid served) against %.0f with the "
         "FullBatchLoader [%s]" % (
             first, len(os.listdir(path)) - 2, SNAP_SHARD_ROWS,
             res["window_max"], budget, loads, res["launches"]["K4"],
             res["steps"], rate, full_rate, card))
    return {"window_max": res["window_max"], "window_bytes": budget,
            "shard_loads": loads, "images_s": rate,
            "fullbatch_images_s": full_rate, "steps": res["steps"],
            "launches": res["launches"], "run_s": res["run_s"]}


def snapshot_phase(torch, card):
    """Phase 4f: (a)-(d); -> record with the launches of every run of
    the phase (the fresh processes' too) under the kernels line's
    names."""
    tmp = tempfile.mkdtemp(prefix="veles-snapshots-")
    total, out = {}, {}
    try:
        t0 = time.perf_counter()
        mnist = snap_mnist_part(torch, card, tmp, total)
        out["shards"] = snap_shards_part(
            torch, card, tmp, total, mnist.pop("fullbatch_3_epochs"),
            mnist.pop("uninterrupted_fused"))
        out["mnist"] = mnist
        out["seconds_mnist_shards"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["alexnet"] = snap_alexnet_part(torch, card, tmp, total)
        out["seconds_alexnet"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["attention"] = snap_attention_part(torch, card, tmp, total)
        out["seconds_attention"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = total
    return out


# -- phase 4g: the structural conv units and the two conv samples (slice 21) -

#: STL-10 at its published widths on its synthetic twin's defaults (96x96x3,
#: 5000 train + 800 valid images, minibatch 50), ``precise_gemm=1``; the
#: epochs cut from the sample's 100
STL10_EPOCHS = 5
#: the JAX gate (tests/test_samples_gates.py::test_stl10_sample_trains):
#: best validation error under this, in percent
STL10_GATE_PT = 50.0
#: graph against fused mode on the card: each epoch's mean train loss,
#: against the largest of fused mode's.  Not the weights: 1e-7 apart
#: after a step, the modes' parameters drift to ~1e-3 of their scale over
#: STL-10's first epoch (100 steps through max pooling and strict RELU;
#: 9.7e-4 on the CPU), while its mean train loss stays 5.9e-6 apart
CONV_MODES_LOSS_RTOL = 1e-4
#: K4 launches a (train, eval) step.  Fused: the all2all and softmax
#: forwards, both weight gradients and both input gradients (pooling and
#: conv layers sit below the all2all), 6 and 2.  Graph mode: the two
#: forwards (the GD units multiply with ``torch.matmul``), 2 and 2
STL10_K4 = {True: (6, 2), False: (2, 2)}
#: VideoAE at its published widths (32x32x1 frames, 480 train + 120
#: valid, minibatch 50) for the sample's 15 epochs
VIDEO_AE_EPOCHS = 15
#: the JAX gate (tests/test_mcdnnic_samples.py::test_video_ae_
#: reconstructs): best validation rmse under this fraction of the
#: targets' standard deviation
VIDEO_AE_GATE = 0.5
#: the first train steps held card against CPU in each mode; STL-10 on
#: the JAX gate test's 300 + 100 images (widths untouched)
CONV_HOLD_STEPS = 2
CONV_HOLD_LOADER = {"stl10": {"n_train": 300, "n_valid": 100},
                    "video_ae": {}}
#: card against CPU: each step's loss relative, each parameter tensor
#: against its largest magnitude (cuDNN's f32 algorithms are not the
#: CPU's summation order)
CONV_LOSS_RTOL = 1e-5
CONV_WEIGHT_RTOL = 1e-4


#: STL-10's synthetic twins made in this process, by their arguments
_STL10_TWINS = {}


@contextlib.contextmanager
def stl10_twins_shared():
    """Within the block the STL-10 sample makes each synthetic twin once
    in the process (its loader copies what it reads), as the needle
    loader's data is made once."""
    from veles_tpu_torch.znicz.samples import stl10
    make = stl10._synthetic_stl10

    def twin(*args):
        if args not in _STL10_TWINS:
            _STL10_TWINS[args] = make(*args)
        return _STL10_TWINS[args]

    stl10._synthetic_stl10 = twin
    try:
        yield
    finally:
        stl10._synthetic_stl10 = make


def conv_sample_workflow(name, device="cuda", fused=True, epochs=1,
                         precise=0, **loader):
    """The ``stl10`` or ``video_ae`` sample through ``create_workflow``
    with ``root.common.engine.precise_gemm`` set to ``precise``, weights
    from seed 42, loader seed 3, initialized on ``device`` (the card
    unless the CPU is asked for); ``loader`` overrides the sample's
    loader config."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import stl10, video_ae
    mod = {"stl10": stl10, "video_ae": video_ae}[name]
    prng.get().seed(42)
    saved = root.common.engine.get("precise_gemm", 0)
    root.common.engine.precise_gemm = precise
    try:
        wf = mod.create_workflow(
            fused=fused, loader=dict(loader, prng=RandomGenerator().seed(3)),
            decision={"max_epochs": epochs, "silent": True})
    finally:
        root.common.engine.precise_gemm = saved
    wf.initialize(device=Device(backend=device))
    return _on(wf, device)


def conv_hold(name, fused, precise, devices=("cuda", "cpu")):
    """The first ``CONV_HOLD_STEPS`` train steps of the sample ``name`` in
    one mode on ``devices[0]`` and by the port on ``devices[1]`` from the
    same seeds: losses and weights within ``CONV_LOSS_RTOL`` and
    ``CONV_WEIGHT_RTOL``; -> record."""
    runs = {}
    for device in devices:
        wf = conv_sample_workflow(name, device, fused, precise=precise,
                                  **CONV_HOLD_LOADER[name])
        t0 = time.perf_counter()
        losses = (train_steps(wf, CONV_HOLD_STEPS) if fused else
                  graph_train_steps(wf, CONV_HOLD_STEPS)[0])
        runs[device] = (losses, host_weights(wf),
                        time.perf_counter() - t0)
    (card_losses, card_w, _), (cpu_losses, cpu_w, cpu_s) = \
        runs[devices[0]], runs[devices[1]]
    label = "%s %s first steps, card vs CPU" % (
        name, "fused" if fused else "graph mode")
    loss_diff, w_diff = steps_agree(label, card_losses, card_w, cpu_losses,
                                    cpu_w, CONV_LOSS_RTOL, CONV_WEIGHT_RTOL)
    _log("train %s: losses card %s cpu %s (max rel diff %.3g, limit %g); "
         "max|w_card - w_cpu| / max|w_cpu| = %.3g (limit %g); CPU steps "
         "%.3f s" % (label, card_losses, cpu_losses, loss_diff,
                     CONV_LOSS_RTOL, w_diff, CONV_WEIGHT_RTOL, cpu_s))
    return {"steps": CONV_HOLD_STEPS, "losses_card": card_losses,
            "losses_cpu": cpu_losses, "max_loss_rel_diff": loss_diff,
            "max_weight_rel_diff": w_diff, "cpu_seconds": cpu_s}


def stl10_run(torch, card, fused, counters, device="cuda",
              epochs=STL10_EPOCHS, **loader):
    """STL-10 with ``precise_gemm=1`` in one mode; -> ``_train_record``'s
    record (its ``first_epoch`` for the caller to pop).  K4 (``counters["k4"]``) must launch ``STL10_K4[fused]`` a
    train / eval step (never inside a GD unit), and the best validation
    error must pass the gate."""
    t0 = time.perf_counter()
    wf = conv_sample_workflow("stl10", device, fused, epochs, precise=1,
                              **loader)
    init_s = time.perf_counter() - t0
    if [f.precise_gemm for f in wf.forwards[-2:]] != [1, 1]:
        raise AssertionError("precise_gemm did not reach STL-10's "
                             "all2all and softmax")
    out = _train_record(torch, wf, counters, "STL-10 precise_gemm=1", card,
                        init_s, "images")
    if not fused:
        if out.pop("gd_launches")["k4"]:
            raise AssertionError("STL-10 graph mode: K4 launched inside a "
                                 "GD unit")
    want = {"k4": STL10_K4[fused]}
    if out["launches_per_train_eval_step"] != want:
        raise AssertionError("STL-10 %s: K4 launches per train / eval step "
                             "%r, want %r" % (
                                 "fused" if fused else "graph mode",
                                 out["launches_per_train_eval_step"], want))
    if not out["best_validation_error_pt"] < STL10_GATE_PT:
        raise AssertionError("STL-10 missed its gate: %.2f%%"
                             % out["best_validation_error_pt"])
    return out


def video_ae_run(torch, card, fused, counters, device="cuda",
                 epochs=VIDEO_AE_EPOCHS, **loader):
    """VideoAE in one mode; -> ``_train_record``'s record (its
    ``first_epoch`` for the caller to pop) with the targets' standard
    deviation.  It launches no hand kernel (its conv
    and deconv run on cuDNN, ``counters`` must stay 0), and its best
    validation rmse must pass the gate."""
    t0 = time.perf_counter()
    wf = conv_sample_workflow("video_ae", device, fused, epochs, **loader)
    init_s = time.perf_counter() - t0
    if [type(f).MAPPING for f in wf.forwards] != [
            "conv_tanh", "max_pooling", "depooling", "deconv"]:
        raise AssertionError("VideoAE's layers are %r" % wf.forwards)
    out = _train_record(torch, wf, counters, "VideoAE", card, init_s,
                        "frames")
    out.pop("gd_launches", None)
    floor = float(wf.loader.original_targets.map_read().std())
    out["targets_std"] = floor
    if any(out["launches"].values()):
        raise AssertionError("VideoAE launched a hand kernel: %r"
                             % out["launches"])
    if not out["best_validation_rmse"] < VIDEO_AE_GATE * floor:
        raise AssertionError("VideoAE missed its gate: rmse %.6f, targets' "
                             "std %.6f" % (out["best_validation_rmse"],
                                           floor))
    return out


def modes_agree(label, runs):
    """Graph mode's mean train loss of each epoch (``runs[False]``)
    against fused mode's (``runs[True]``) on the card, within
    ``CONV_MODES_LOSS_RTOL`` of fused mode's largest; pops both runs'
    ``first_epoch`` (its weights' distance is logged); -> record."""
    fused, graph = runs[True], runs[False]
    first_f, first_g = fused.pop("first_epoch"), graph.pop("first_epoch")
    loss_f, loss_g = fused["mean_train_loss"], graph["mean_train_loss"]
    scale = max(abs(x) for x in loss_f)
    diff = max(abs(a - b) for a, b in zip(loss_g, loss_f)) / scale
    w_diff = _max_rel_diff(first_g["weights"], first_f["weights"])
    _log("train %s: graph against fused mode: mean train loss "
         "by epoch graph %s fused %s, max diff %.3g of the largest (limit "
         "%g); first epoch's weights max|w_graph - w_fused| / max|w_fused| "
         "= %.3g, its metric graph %s fused %s"
         % (label, loss_g, loss_f, diff, CONV_MODES_LOSS_RTOL, w_diff,
            first_g["n_err"], first_f["n_err"]))
    if len(loss_g) != len(loss_f) or not diff <= CONV_MODES_LOSS_RTOL:
        raise AssertionError("%s: graph mode's mean train losses %r are %.3g "
                             "of their scale from fused mode's %r"
                             % (label, loss_g, diff, loss_f))
    return {"max_loss_diff_of_scale": diff,
            "first_epoch_max_weight_rel_diff": w_diff}


def conv_phase(torch, gemm, card):
    """Phase 4g: STL-10 (K4) and VideoAE at their published widths, fused
    and graph mode, each held against its gate, graph against fused mode
    and its first steps against the CPU; -> record with the launches of
    the phase's runs under the kernels line's names."""
    counters = {"k4": gemm.precise_matmul}
    out = {}
    t0 = time.perf_counter()
    with stl10_twins_shared():
        stl = {fused: stl10_run(torch, card, fused, counters)
               for fused in (True, False)}
        modes = modes_agree("STL-10 precise_gemm=1", stl)
        _log("train STL-10 precise_gemm=1: train images/s fused %.1f graph "
             "%.1f (median epoch after the first) [%s]"
             % (stl[True]["train_samples_s_median"],
                stl[False]["train_samples_s_median"], card))
        out["stl10"] = {"fused": stl[True], "graph": stl[False],
                        "graph_vs_fused": modes,
                        "hold_fused": conv_hold("stl10", True, 1),
                        "hold_graph": conv_hold("stl10", False, 1),
                        "seconds": time.perf_counter() - t0}
    _log("phase 4g STL-10: %.1f s" % out["stl10"]["seconds"])
    t0 = time.perf_counter()
    vae = {fused: video_ae_run(torch, card, fused, counters)
           for fused in (True, False)}
    out["video_ae"] = {"fused": vae[True], "graph": vae[False],
                       "graph_vs_fused": modes_agree("VideoAE", vae),
                       "hold_fused": conv_hold("video_ae", True, 0),
                       "hold_graph": conv_hold("video_ae", False, 0),
                       "seconds": time.perf_counter() - t0}
    _log("phase 4g VideoAE: %.1f s" % out["video_ae"]["seconds"])
    out["launches"] = {"precise_matmul_l1": sum(
        run["launches"]["k4"] for run in stl.values())}
    return out


def trace_stl10(torch, card):
    """One fused STL-10 epoch (``precise_gemm=1``) under
    ``torch.profiler``, on the twin phase 4g made."""
    with stl10_twins_shared():
        return _traced(torch, "train STL-10 precise_gemm=1", card,
                       lambda: _epoch(conv_sample_workflow("stl10",
                                                           precise=1)))


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


#: the int8-kv burst before the append kernel: PERF.md section 5's traced
#: launches and TTFT p50 range (its runs with the vectorized passes)
PASSES_INT8_KV = {"traced_launches": 23792, "ttft_p50_ms": (130.3, 171.0)}


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
    if run["kv_dtype"] == "int8":
        _log("serving %s through the append kernel: %d append launches, "
             "TTFT p50 %.1f ms, traced burst %d launches; with the "
             "vectorized passes (PERF.md section 5) TTFT p50 %.1f-%.1f ms "
             "and %d launches [%s]"
             % (run["label"], run["launches"]["kv_append_int8"],
                run["ttft_p50_ms"], run["traced_launches"],
                *PASSES_INT8_KV["ttft_p50_ms"],
                PASSES_INT8_KV["traced_launches"], run["card"]))


def trace_options_run(torch, card, kv_dtype):
    """Phase 3b's two turns once more under ``torch.profiler``, through
    the scheduler directly, with ``OPTIONS_SERVER``."""
    from veles_tpu_torch.serving import DecodeScheduler
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel

    def turns():
        model = FlagshipDecodeModel(**README_MODEL, kv_dtype=kv_dtype)
        sched = DecodeScheduler(model, name="trace-options-" + kv_dtype,
                                kv_dtype=kv_dtype, **README_SERVER,
                                **OPTIONS_SERVER)
        return (lambda: _scheduler_turns(sched, turn1_prompts()),
                sched.close)
    return _traced(torch, "%s options" % kv_dtype, card, turns)


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
    # the int8-KV append's (both index types)
    rows = [(t, c) for t, c, k in by_kernel if "kv_append_int8_kernel" in k]
    rec["append_ms"] = sum(t for t, _ in rows) / 1e3
    rec["append_launches"] = sum(c for _, c in rows)
    if rec["append_launches"]:
        _log("trace %s: the int8-KV append %.3f ms over %d launches [%s]"
             % (label, rec["append_ms"], rec["append_launches"], card))
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
    "kv_append_int8": (
        "append", "csrc/kv_append.cu",
        "none: not a TPU kernel; the JAX package's int8 append is "
        "veles_tpu/znicz/samples/flagship.py:330 (_append_kv's "
        "fori_loop)"),
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
        "kv_append_int8":
            by_label["int8-kv"]["launches"]["kv_append_int8"],
    }
    if by_label["f32"]["launches"]["quantized_matmul"]:
        raise AssertionError("the f32 model launched the quantized GEMM")
    if any(r["launches"]["kv_append_int8"] for r in runs
           if r["kv_dtype"] == "f32"):
        raise AssertionError("f32 pools launched the int8 append")
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
    ("lrn", ("device_ms", "bitwise")),
    ("kv_append", ("device_ms", "bitwise")))


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
    parser.add_argument("--resume-child", metavar="SPEC",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.resume_child:
        return resume_child(args.resume_child)
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
    kernels.update(append_phase(torch, pa, dev))
    phase_done("2 kernels")
    runs = [e2e_run(pa, gemm, card, label, kv, wd)
            for label, kv, wd in CONFIGS]
    launches = serving_launches(runs)
    record["e2e"] = runs
    phase_done("3 serving")
    options = options_phase(pa, card)
    for run in options:
        launches["paged_attention_" + run["kv_dtype"]] += \
            run["launches"]["paged_attention"]
        launches["kv_append_int8"] += run["launches"]["kv_append_int8"]
    record["e2e_options"] = options
    phase_done("3b serving with prefix caching, chunks and speculation")
    tiers = tiers_phase(torch, pa, card, dev, options)
    for run in (tiers["tiers"] + tiers["checkpoint"] + tiers["migration"]
                + [tiers["realistic"]["checkpoint_kv"]]):
        launches["paged_attention_" + run["kv_dtype"]] += \
            run["launches"]["paged_attention"]
        launches["kv_append_int8"] += run["launches"]["kv_append_int8"]
    record["e2e_tiers"] = tiers
    phase_done("3c tiers, checkpoints and session migration")
    train = [train_run(torch, gemm, card, precise) for precise in (0, 1, 2)]
    record["first_epoch_vs_cpu"] = first_epoch_on_the_cpu(train[1], gemm)
    served_wf = train[1]["workflow"]
    for run in train:
        run.pop("first_epoch")
        run.pop("workflow")
        if run["precise_gemm"]:
            launches["precise_matmul_l%d" % run["precise_gemm"]] = \
                run["k4_launches"]
    record["training"] = train
    phase_done("4 MNIST training")
    cache_dir = tempfile.mkdtemp(prefix="veles-build-cache-")
    try:
        record["flight"] = flight_phase(torch, pa, gemm, card, runs,
                                        tiers["migration"], served_wf,
                                        cache_dir=cache_dir)
        phase_done("3d flight recorder, classifier route, fleet, profiler")
        record["autotune"] = autotune_phase(torch, card, cache_dir, dev)
        phase_done("3e autotuner and build cache")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    served = {"mnist": served_wf}
    del served_wf
    attention = [attention_run(torch, fa, card, *config)
                 for config in ATTN_CONFIGS]
    record["attention_first_epoch_vs_cpu"] = [
        attention_first_epoch_vs_cpu(fa, *config)
        for config in ATTN_CONFIGS]
    record["attention_small"] = attention_small_run(torch, fa, card)
    record["attention_wide"] = attention_wide_hold(torch, fa, card)
    served["attention"] = attention[0]["workflow"]
    for run in attention:
        run.pop("first_epoch")
        run.pop("workflow")
    for name, kid in (("flash_attention_fwd", "K7"),
                      ("flash_attention_dq", "K8"),
                      ("flash_attention_dkv", "K9")):
        launches[name] = sum(run["launches"][kid] for run in attention) + \
            record["attention_wide"]["launches"][kid]
    record["attention"] = attention
    phase_done("4b attention training")
    alexnet = [alexnet_run(torch, lrn_mod, card, *config)
               for config in ALEX_CONFIGS]
    served["alexnet"] = alexnet[0]["workflow"]
    for run in alexnet:
        run.pop("workflow")
    record["alexnet"] = alexnet
    record["alexnet_first_steps_vs_cpu"] = alexnet_hold(torch, lrn_mod)
    phase_done("4c AlexNet training")
    lrn_net = lrn_net_run(torch, lrn_mod, card)
    served["lrn"] = lrn_net.pop("workflow")
    record["lrn_convnet"] = lrn_net
    for name, kid in (("lrn_fwd", "K5"), ("lrn_bwd", "K6")):
        launches[name] = alexnet[0]["launches"][kid] + \
            lrn_net["launches"][kid]
    phase_done("4d LRN convnet training")
    packages = package_phase(torch, gemm, lrn_mod, fa, card, served, dev)
    del served
    record["packages"] = packages
    for name, n in packages["launches"].items():
        launches[name] += n
    phase_done("3f exported packages")
    graph = graph_phase(torch, gemm, lrn_mod, fa, card, train[1])
    record["graph_mode"] = graph
    launches["precise_matmul_l1"] += graph["mnist"]["launches"]["k4"]
    for name, kid in (("lrn_fwd", "K5"), ("lrn_bwd", "K6")):
        launches[name] += graph["lrn_convnet"]["launches"][kid]
    for name, kid in (("flash_attention_fwd", "K7"),
                      ("flash_attention_dq", "K8"),
                      ("flash_attention_dkv", "K9")):
        launches[name] += sum(run["launches"][kid]
                              for run in graph["attention"])
    phase_done("4e graph mode")
    snaps = snapshot_phase(torch, card)
    record["snapshots"] = snaps
    for name, n in snaps["launches"].items():
        launches[name] += n
    phase_done("4f snapshots and shards")
    conv = conv_phase(torch, gemm, card)
    record["conv_samples"] = conv
    for name, n in conv["launches"].items():
        launches[name] += n
    phase_done("4g STL-10 and VideoAE")
    line = kernels_line(kernels, k4, launches)
    record["kernels"] = line["kernels"]
    record["traces"] = (
        [trace_run(torch, card, *config) for config in CONFIGS] +
        [trace_train(torch, card, precise) for precise in (0, 1)] +
        [trace_attention(torch, card, *config) for config in ATTN_CONFIGS] +
        [trace_alexnet(torch, card, *config) for config in ALEX_CONFIGS] +
        [trace_options_run(torch, card, kv) for kv in ("f32", "int8")] +
        [trace_graph_train(torch, card), trace_stl10(torch, card)])
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
