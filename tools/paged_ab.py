#!/usr/bin/env python3
"""Time the paged decode attention kernels (K1 f32, K2 int8) of several
copies of their source in turns on one card: the working tree's
``veles_tpu_torch/csrc/paged_attention.cu`` against each copy named on
the command line.

    git show 9002191:veles_tpu_torch/csrc/paged_attention.cu \\
        > build/paged_parent.cu
    python3 tools/paged_ab.py build/paged_parent.cu
    python3 tools/paged_ab.py --plan _CTAS_PER_SM=8 --plan _TILE_BYTES=16384

Each source is built with the port's nvcc flags (``-Xptxas -v``: ptxas's
registers and spills are printed) into ``build/paged_ab/``, one nvcc for
each, all started together.  A source with the dense-score-row C
interface (one CTA a (row, head), the score row in shared memory,
``vt_paged_attention_smem_bytes``, as at commit 9002191) is called that
way, and a shape whose score row passes 227 KB is "refused" for it; any
other source takes the tree's interface and ``paged_attention_plan``.  Each
``--plan [SOURCE:]NAME=VALUE[,NAME=VALUE]`` adds a variant of the tree's
build (or of the copy named SOURCE, its file's stem) whose plan is made
with those constants of ``veles_tpu_torch/znicz/paged_attention.py``
changed.

Each build and variant is held against the plain version
(``paged_attention_reference``, ``max|kernel - plain| <= 1e-5``) at
chip_smoke's ``PAGED_CASES`` (the main path's shape, the realistic one
and the long context), then timed there in the order first, ..., last,
last, ..., first: the mean of 20 calls between CUDA events and the
profiler's device time a call (each kernel's mean a launch, the merge's
added where the call splits), beside
the card's name and power limit.  Imports nothing of JAX.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from veles_tpu_torch import _build  # noqa: E402
from veles_tpu_torch.znicz import paged_attention as pa  # noqa: E402

OUT = ROOT / "build" / "paged_ab"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: shared memory one CTA of the card may use (H100: 227 KB)
MAX_SMEM = 232448


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


def call(lib, knobs, args, kw):
    """-> (call, plan): one K1/K2 call of ``lib`` on the inputs (both
    launches of a split one) and the plan it takes (None for the first
    version's interface), or (None, "refused") where the build cannot
    take them."""
    q, kp, vp, table, lens = args
    b, h, d = q.shape
    bs, nb = kp.shape[1], table.shape[1]
    quant = kp.dtype == torch.int8
    out = torch.empty_like(q)
    ptrs = [q, kp, vp, table, lens]
    if quant:
        ptrs += [kw["k_scales"], kw["v_scales"]]
    ptrs = [t.data_ptr() for t in ptrs] + [out.data_ptr()]
    ints = [b, h, d, bs, nb]
    fn = lib.vt_paged_attention_int8 if quant else lib.vt_paged_attention_f32
    plan = ws = None
    if hasattr(lib, "vt_paged_attention_smem_bytes"):
        smem = lib.vt_paged_attention_smem_bytes
        smem.argtypes, smem.restype = [_I] * 3, ctypes.c_size_t
        if smem(d, nb, bs) > MAX_SMEM:
            return None, "refused"
    else:
        plan = _plan(b, h, d, bs, nb, quant, knobs)
        ws = torch.empty(b * h * plan.split * (d + 2), device=q.device) \
            if plan.split > 1 else None
        ptrs.append(ws.data_ptr() if ws is not None else None)
        ints += list(plan)
    fn.argtypes = [_P] * len(ptrs) + [_I] * len(ints) + [_F, _P]
    fn.restype = _I
    tail = [1.0 / d ** 0.5, _build.stream_ptr(q.device)]

    def run():
        code = fn(*ptrs, *ints, *tail)
        if code:
            raise RuntimeError("paged attention launch failed (%d)" % code)
        return out
    run.keep = (out, ws)   # the buffers behind the pointers
    return run, plan


def main():
    args = sys.argv[1:]
    if not torch.cuda.is_available():
        raise SystemExit("paged_ab: torch sees no CUDA device")
    variants = {"tree": ("tree", {})}
    sources = {"tree": ROOT / "veles_tpu_torch" / "csrc" /
               "paged_attention.cu"}
    while args:
        arg = args.pop(0)
        if arg == "--plan":
            spec = args.pop(0)
            src, _, knob_spec = spec.rpartition(":")
            src = src or "tree"
            knobs = {k: int(v) for k, v in
                     (kv.split("=") for kv in knob_spec.split(","))}
            variants["%s[%s]" % (src, knob_spec)] = (src, knobs)
        else:
            name = Path(arg).stem
            sources[name] = Path(arg).resolve()
            variants[name] = (name, {})
    dev = torch.device("cuda")
    print(chip_smoke._card_line())
    libs = build(sources)
    for label, shape, lengths in chip_smoke.paged_cases():
        for quant in (False, True):
            kid = "K2" if quant else "K1"
            inputs, kw, nbytes, flops = chip_smoke._paged_case(
                torch, pa, dev, *shape, lengths, quant, seed=2)
            ref = pa.paged_attention_reference(*inputs, **kw)
            bound = chip_smoke._bound(nbytes, flops)[0]
            calls = {}
            for name, (src, knobs) in variants.items():
                run, plan = call(libs[src], knobs, inputs, kw)
                if run is None:
                    print("%s %s %s: refused" % (label, kid, name))
                    continue
                note = ("one CTA a (row, head)" if plan is None else
                        "split %d (%d blocks) tile %d"
                        % tuple(plan))
                err = float((run() - ref).abs().max())
                torch.cuda.synchronize()
                if not err <= 1e-5:
                    raise SystemExit("%s %s %s: max|kernel - plain| = %g "
                                     "> 1e-5" % (label, kid, name, err))
                print("%s %s %s: %s, max|kernel - plain| = %.3g"
                      % (label, kid, name, note, err))
                calls[name] = run
            del ref
            order = list(calls) + list(calls)[::-1]
            for name in order:
                run = calls[name]
                ms = chip_smoke._cuda_ms(torch, run)
                dev_ms = chip_smoke._device_ms(torch, run, per_launch=True)
                print("%s %s %s: event %.4f ms, device %.4f ms, bound %.4f "
                      "ms (%.1f %% of it)" % (label, kid, name, ms, dev_ms,
                                              bound, 100 * bound / dev_ms))
            del inputs, kw, calls
            torch.cuda.empty_cache()
    print(chip_smoke._card_line())


if __name__ == "__main__":
    main()
