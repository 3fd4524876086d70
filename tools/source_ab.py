#!/usr/bin/env python3
"""Time the kernels of one CUDA source of the port in several copies, in
turns on one card: the working tree's ``veles_tpu_torch/csrc/<kernel>.cu``
against each copy named on the command line.

    git show HEAD~1:veles_tpu_torch/csrc/kv_append.cu > build/append_parent.cu
    python3 tools/source_ab.py kv_append build/append_parent.cu
    python3 tools/source_ab.py flash_attention build/flash_parent.cu
    python3 tools/source_ab.py lrn build/lrn_parent.cu
    python3 tools/source_ab.py paged_attention --plan _CTAS_PER_SM=8

Each source is built with the port's nvcc flags (``-Xptxas -v``: ptxas's
registers and spills are printed) into ``build/source_ab/``, one nvcc
for each, all started together, and called through the C interface the
tree's wrapper uses.  Each build is held against the plain version,
then timed, in the order first, ..., last, last, ..., first: the mean
of 20 calls (LRN: 50) between CUDA events and the profiler's device
time a call, beside the bound ``chip_smoke.py`` gives the same call and
the card's name and power limit.  The cases, each kernel's:

- ``paged_attention`` (K1 f32, K2 int8): chip_smoke's ``paged_cases``
  (the main path's shape, the realistic one, the long context), within
  1e-5 of ``paged_attention_reference``.  ``--plan NAME=VALUE[,...]``
  adds a variant of the tree's build whose plan is made with those
  constants of ``veles_tpu_torch/znicz/paged_attention.py`` changed.
- ``lrn`` (K5, K6): how many of chip_smoke's ``LRN_SHAPES`` and
  ``LRN_SMALL`` cases each build gives the plain versions' bits (a
  knocked-out copy need not), then the times at ``LRN_SHAPES``.
- ``flash_attention`` (K7-K9): chip_smoke's main path (B=8 T=2048 H=8
  D=64, its three masks) and its realistic shapes (D = 512 included),
  out and lse within 2e-5, each gradient within 5e-4 of max(1,
  max|plain|); a build that returns an error is "refused".
- ``kv_append``: chip_smoke's append cases (the README prefill, the
  verify span, the 2048-write prefill, the same with a scale that grows
  on every write, its first 512 and 1024 writes) and decode steps of
  16 and 32 rows at the README widths, the pool and scales bitwise
  equal to
  ``kv_append_int8_reference`` (the trash block aside).

Imports nothing of JAX.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from veles_tpu_torch import _build  # noqa: E402
from veles_tpu_torch.znicz import flash_attention as fa  # noqa: E402
from veles_tpu_torch.znicz import lrn  # noqa: E402
from veles_tpu_torch.znicz import paged_attention as pa  # noqa: E402

OUT = ROOT / "build" / "source_ab"
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def build(sources):
    """{name: ctypes library}, one nvcc for each source, all started
    together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / ("lib%s.so" % name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("nvcc failed on %s:\n%s" % (name, log))
        for fn, regs, stores, loads in chip_smoke.ptxas_report(log):
            print("ptxas %s: %s: %d registers, %d + %d bytes spilled"
                  % (name, fn, regs, stores, loads))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _check(code, what):
    if code:
        raise RuntimeError("%s: launch failed (%d)" % (what, code))


def time_turns(label, calls, bound=None, iters=20, **device):
    """Each call of ``calls`` ({build: call}) timed in the order first,
    ..., last, last, ..., first."""
    for name in list(calls) + list(calls)[::-1]:
        run = calls[name]
        ms = chip_smoke._cuda_ms(torch, run, iters=iters)
        dev_ms = chip_smoke._device_ms(torch, run, iters=iters, **device)
        line = "%s %s: event %.4f ms, device %.4f ms" % (label, name, ms,
                                                         dev_ms)
        if bound is not None:
            line += ", bound %.5f ms (%.1f %% of it)" % (
                bound, 100 * bound / dev_ms)
        print(line, flush=True)


# -- K1/K2: paged decode attention --------------------------------------------

def _plan(b, h, d, bs, nb, quant, knobs):
    """The tree's plan with ``knobs`` (module constants) set for the
    call."""
    saved = {k: getattr(pa, k) for k in knobs}
    try:
        for k, v in knobs.items():
            setattr(pa, k, v)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return pa.paged_attention_plan(b, h, d, bs, nb, sms, quantized=quant)
    finally:
        for k, v in saved.items():
            setattr(pa, k, v)


def paged_call(lib, knobs, args, kw):
    """-> (call, plan): one K1/K2 call of ``lib`` on the inputs (both
    launches of a split one) and the plan it takes."""
    q, kp, vp, table, lens = args
    b, h, d = q.shape
    bs, nb = kp.shape[1], table.shape[1]
    quant = kp.dtype == torch.int8
    out = torch.empty_like(q)
    plan = _plan(b, h, d, bs, nb, quant, knobs)
    ws = torch.empty(b * h * plan.split * (d + 2), device=q.device) \
        if plan.split > 1 else None
    ptrs = [q, kp, vp, table, lens]
    if quant:
        ptrs += [kw["k_scales"], kw["v_scales"]]
    ptrs = [t.data_ptr() for t in ptrs] + [
        out.data_ptr(), ws.data_ptr() if ws is not None else None]
    ints = [b, h, d, bs, nb] + list(plan)
    fn = lib.vt_paged_attention_int8 if quant else lib.vt_paged_attention_f32
    fn.argtypes = [_P] * len(ptrs) + [_I] * len(ints) + [_F, _P]
    tail = [1.0 / d ** 0.5, _build.stream_ptr(q.device)]

    def run():
        _check(fn(*ptrs, *ints, *tail), "paged attention")
        return out
    run.keep = (out, ws)   # the buffers behind the pointers
    return run, plan


def paged_ab(libs, dev, plans):
    variants = {name: (name, {}) for name in libs}
    variants.update(("tree[%s]" % spec, ("tree", knobs))
                    for spec, knobs in plans.items())
    for label, shape, lengths in chip_smoke.paged_cases():
        for quant in (False, True):
            kid = "K2" if quant else "K1"
            inputs, kw, nbytes, flops = chip_smoke._paged_case(
                torch, pa, dev, *shape, lengths, quant, seed=2)
            ref = pa.paged_attention_reference(*inputs, **kw)
            calls = {}
            for name, (src, knobs) in variants.items():
                run, plan = paged_call(libs[src], knobs, inputs, kw)
                err = float((run() - ref).abs().max())
                torch.cuda.synchronize()
                if not err <= 1e-5:
                    raise SystemExit("%s %s %s: max|kernel - plain| = %g "
                                     "> 1e-5" % (label, kid, name, err))
                print("%s %s %s: split %d (%d blocks) tile %d, max|kernel - "
                      "plain| = %.3g" % ((label, kid, name) + tuple(plan)
                                         + (err,)))
                calls[name] = run
            del ref
            time_turns("%s %s" % (label, kid), calls,
                       chip_smoke._bound(nbytes, flops)[0], per_launch=True)
            del inputs, kw, calls
            torch.cuda.empty_cache()


# -- K5/K6: LRN ---------------------------------------------------------------

def lrn_calls(lib, x, g, y, dx, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """(K5 call, K6 call) of one build on x, g into y, dx."""
    fwd, bwd = lib.vt_lrn_fwd, lib.vt_lrn_bwd
    fwd.argtypes = [_P, _P, _L, _I, _I, _F, _F, _F, _P]
    bwd.argtypes = [_P, _P, _P, _L, _I, _I] + [_F] * 5 + [_P]
    c = x.shape[-1]
    rows = x.numel() // c
    stream = _build.stream_ptr(x.device)

    def k5():
        _check(fwd(x.data_ptr(), y.data_ptr(), rows, c, n, alpha / n, k,
                   beta, stream), "K5")

    def k6():
        _check(bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, n,
                   alpha / n, k, -beta, -beta - 1.0,
                   2.0 * beta * (alpha / n), stream), "K6")
    return k5, k6


def lrn_ab(libs, dev, _):
    cases = [(shape, chip_smoke.LRN_PARAMS)
             for _, shape in chip_smoke.LRN_SHAPES]
    cases += list(chip_smoke.LRN_SMALL)
    equal = {name: 0 for name in libs}
    for i, (shape, params) in enumerate(cases):
        x, g = chip_smoke._lrn_inputs(torch, dev, shape, 300 + i)
        want = (lrn.lrn_reference(x, *params),
                lrn.lrn_backward_reference(x, g, *params))
        for name, lib in libs.items():
            got = torch.empty_like(x), torch.empty_like(x)
            for call in lrn_calls(lib, x, g, *got, *params):
                call()
            torch.cuda.synchronize()
            equal[name] += all(map(torch.equal, got, want))
    for name, count in equal.items():
        print("%s: bitwise equal to the plain versions in %d of %d cases"
              % (name, count, len(cases)))
    for label, shape in chip_smoke.LRN_SHAPES:
        x, g = chip_smoke._lrn_inputs(torch, dev, shape, 5)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        for i, kid in enumerate(("K5", "K6")):
            time_turns("%s %s" % (label, kid),
                       {name: lrn_calls(lib, x, g, y, dx)[i]
                        for name, lib in libs.items()},
                       iters=50, per_launch=True)


# -- K7-K9: flash attention ---------------------------------------------------

def _view(x):
    return [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)]


def flash_calls(lib, q, k, v, do, lse, delta, causal, window):
    """{kernel name: call} of one build on the inputs, or None where the
    build refuses them."""
    b, t, h, d = q.shape
    fwd, dq, dkv = lib.vt_flash_fwd, lib.vt_flash_dq, lib.vt_flash_dkv
    view = [_P, _L, _L, _L]
    tail_t = [_I] * 4 + [_F, _I, _I, _P]
    fwd.argtypes = view * 3 + [_P, _P] + tail_t
    dq.argtypes = view * 4 + [_P, _P, _P] + tail_t
    dkv.argtypes = view * 4 + [_P] * 4 + tail_t
    tail = [b, t, h, d, 1.0 / d ** 0.5, int(causal), int(window or 0),
            _build.stream_ptr(q.device)]
    out = torch.empty_like(q.contiguous())
    lse_out = torch.empty_like(lse)
    g = [torch.empty_like(out) for _ in range(3)]
    args = _view(q) + _view(k) + _view(v)
    bwd = args + _view(do) + [lse.data_ptr(), delta.data_ptr()]
    calls = {
        "flash_attention_fwd": lambda: _check(fwd(
            *args, out.data_ptr(), lse_out.data_ptr(), *tail), "K7")
        or (out, lse_out),
        "flash_attention_dq": lambda: _check(dq(
            *bwd, g[0].data_ptr(), *tail), "K8") or (g[0],),
        "flash_attention_dkv": lambda: _check(dkv(
            *bwd, g[1].data_ptr(), g[2].data_ptr(), *tail), "K9")
        or (g[1], g[2])}
    try:
        calls["flash_attention_fwd"]()
    except RuntimeError:
        return None
    return calls


def flash_ab(libs, dev, _):
    cases = ([(chip_smoke.FLASH_MAIN, c, w)
              for c, w in chip_smoke.FLASH_MASKS]
             + list(chip_smoke.FLASH_REALISTIC))
    for i, (shape, causal, window) in enumerate(cases):
        b, t, h, d = shape
        q, k, v, do = chip_smoke._flash_inputs(torch, dev, b, t, h, d,
                                               300 + i)
        kw = dict(causal=causal, window=window)
        ref_out, lse = fa.flash_fwd_reference(q, k, v, **kw)
        delta = fa.flash_delta(do, ref_out)
        refs = {"flash_attention_fwd": (ref_out, lse),
                "flash_attention_dq": (fa.flash_dq_reference(
                    q, k, v, do, lse, delta, **kw),),
                "flash_attention_dkv": fa.flash_dkv_reference(
                    q, k, v, do, lse, delta, **kw)}
        vis = chip_smoke._visible(t, causal, window) * b * h
        flops = {"flash_attention_fwd": 4 * vis * d,
                 "flash_attention_dq": 6 * vis * d,
                 "flash_attention_dkv": 8 * vis * d}
        label = "B=%d T=%d H=%d D=%d causal=%s window=%s" % (
            b, t, h, d, causal, window)
        builds = {}
        for name, lib in libs.items():
            calls = flash_calls(lib, q, k, v, do, lse, delta, causal, window)
            if calls is None:
                print("%s %s: refused" % (label, name))
                continue
            for kname, run in calls.items():
                for got, want in zip(run(), refs[kname]):
                    torch.cuda.synchronize()
                    e = float((got - want).abs().max())
                    limit = 2e-5 if kname.endswith("fwd") else \
                        5e-4 * max(1.0, float(want.abs().max()))
                    if not e <= limit:
                        raise SystemExit("%s %s %s: max|kernel - plain| = "
                                         "%g > %g" % (label, name, kname, e,
                                                      limit))
            builds[name] = calls
        del refs, ref_out
        for kname in flops:
            # the 3xTF32 bound: three TF32 products a useful one
            time_turns("%s %s" % (label, kname),
                       {name: calls[kname] for name, calls in builds.items()},
                       3 * flops[kname] / chip_smoke.TF32_FLOPS * 1e3,
                       launches=1)
        del builds, q, k, v, do, lse, delta
        torch.cuda.empty_cache()


# -- the int8-KV append -------------------------------------------------------

def append_call(lib, q, s, blk, off, vals):
    n = blk.numel()
    _, bs, h, d = q.shape
    fn = (lib.vt_kv_append_int8_i32 if blk.dtype == torch.int32
          else lib.vt_kv_append_int8_i64)
    fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    blk, off = blk.reshape(-1), off.reshape(-1)
    vals = vals.reshape(n, h, d)
    return lambda: _check(fn(q.data_ptr(), s.data_ptr(), blk.data_ptr(),
                             off.data_ptr(), vals.data_ptr(), n, bs, h, d,
                             _build.stream_ptr(q.device)), "append")


def append_cases():
    """chip_smoke's append cases, the 2048-write prefill again with a
    scale that grows on every write, its first 512 and 1024 writes, and
    decode steps of 16 (the README server's batch) and 32 rows at the
    README widths, one position a row in a block of its own: (label,
    shape, blk, off, growing)."""
    cases = [c + (False,) for c in chip_smoke.append_cases()]
    label, shape, blk, off, _ = cases[-1]
    cases.append(("growing", shape, blk, off, True))
    cases += [("realistic, first %d" % n, shape, blk[:n], off[:n], False)
              for n in (512, 1024)]
    rng = numpy.random.RandomState(12)
    for rows in (16, 32):
        blk = (1 + rng.permutation(2 * rows)[:rows])[:, None]
        cases.append(("decode [%d, 1]" % rows, (2 * rows + 1, 16, 4, 16),
                      blk, rng.randint(1, 16, (rows, 1)), False))
    return cases


def append_ab(libs, dev, _):
    for i, (label, shape, blk, off, growing) in enumerate(append_cases()):
        q, s, tblk, toff, vals = chip_smoke.append_inputs(
            torch, dev, shape, blk, off, 20 + i, growing=growing)
        rq, rs = q.clone(), s.clone()
        pa.kv_append_int8_reference(rq, rs, tblk, toff, vals)
        _, bs, h, d = shape
        blocks = len(set(blk.reshape(-1).tolist()) - {0})
        nbytes = (blocks * 2 * (bs * h * d + h * 4) + vals.numel() * 4
                  + 2 * blk.size * 8)
        calls = {}
        for name, lib in libs.items():
            kq, ks = q.clone(), s.clone()
            append_call(lib, kq, ks, tblk, toff, vals)()
            torch.cuda.synchronize()
            bitwise = torch.equal(kq[1:], rq[1:]) and torch.equal(ks[1:],
                                                                  rs[1:])
            print("%s %s: bitwise=%s" % (label, name, bitwise))
            if not bitwise:
                raise SystemExit("%s %s differs from the plain version"
                                 % (label, name))
            calls[name] = append_call(lib, kq, ks, tblk, toff, vals)
        time_turns("%s (%d writes %r, %d blocks of [%d, %d, %d])"
                   % (label, blk.size, list(blk.shape), blocks, bs, h, d),
                   calls, chip_smoke._bound(nbytes, 0)[0], launches=1)


KERNELS = {"paged_attention": paged_ab, "lrn": lrn_ab,
           "flash_attention": flash_ab, "kv_append": append_ab}


def main():
    args = sys.argv[1:]
    if not args or args[0] not in KERNELS:
        raise SystemExit("usage: source_ab.py %s [COPY.cu ...] "
                         "[--plan NAME=VALUE[,...]]" % "|".join(KERNELS))
    if not torch.cuda.is_available():
        raise SystemExit("source_ab: torch sees no CUDA device")
    kernel = args.pop(0)
    sources = {"tree": ROOT / "veles_tpu_torch" / "csrc" / (kernel + ".cu")}
    plans = {}
    while args:
        arg = args.pop(0)
        if arg == "--plan":
            if kernel != "paged_attention":
                raise SystemExit("--plan: paged_attention only")
            spec = args.pop(0)
            plans[spec] = {k: int(v) for k, v in
                           (kv.split("=") for kv in spec.split(","))}
        else:
            sources[Path(arg).stem] = Path(arg).resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke._card_line())
    libs = build(sources)
    KERNELS[kernel](libs, torch.device("cuda"), plans)
    print(chip_smoke._card_line())


if __name__ == "__main__":
    main()
