#!/usr/bin/env python3
"""Run the port's flash attention (K7-K9), compensated GEMM (K4) and
int8-KV append kernels on the CPU, through ``cuda_runtime.h`` here,
against their plain versions.

    python3 tools/cuda_emu/check.py flash [CASE ...]   # "(B, T, H, D, causal, window[, tiles])"
    python3 tools/cuda_emu/check.py precise [--quick]
    python3 tools/cuda_emu/check.py append [--quick]

Each ``csrc/<kernel>.cu`` is turned into C++ for the stand-in (its
``asm`` helpers for ``mma.sync`` and ``cp.async`` swapped for the
header's, ``extern __shared__`` arrays pointed at the block's dynamic
shared memory, ``<<<...>>>`` launches made calls of ``emu::launch``),
built with g++ (``-std=c++20 -pthread``) into ``build/cuda_emu/`` and
called through its C entries.  ``flash``: out and lse within 2e-5 and
each gradient within 5e-4 of max(1, max|plain|), at head dims that take
the resident tiles (with the plans' own streamed tiles, and at head dim
64 the other instantiation the autotune sites may pick: ``tiles`` as
K7's, K8's and K9's tile) and the wide path; ``precise``: every split
of K into runs (none, the kernel's rule, and each run count) bitwise
equal to the unsplit call and within 1e-6 of the plain version's scale,
at each level and both operand layouts (``--quick``: the first case at
level 1); ``append``: the pool and scales
bitwise equal to ``kv_append_int8_reference`` (the trash block aside)
at chip_smoke's README prefill and verify span, runs of growing scale
from mid-block at block sizes 16-64 and head dims 16-256, a reopen
mid-call, padding into the trash block, ragged head dims, misaligned
values, a decode step of more runs than a CTA has warps and a
2048-write prefill (``--quick``: ``QUICK_APPEND``'s three).  Tiny
shapes only: one host thread a CUDA thread.  Exit code 1 on any
disagreement.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from veles_tpu_torch.znicz import flash_attention as fa  # noqa: E402
from veles_tpu_torch.znicz import paged_attention as pa  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "cuda_emu"
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: the bodies of the .cu helpers that hold inline PTX
BODIES = {"mma_tf32": "{ emu_mma(d, a, b); }",
          "cp_async16": "{ emu_cp(dst, src, bytes, 16); }",
          "cp_async4": "{ emu_cp(dst, src, bytes, 4); }",
          "cp_async_commit": "{}",
          "cp_async_wait": "{}"}


def _replace_body(src, name, body):
    m = re.search(r"\b%s\(" % name, src)
    if not m:
        return src
    i = src.index("{", m.end())
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[:i] + body + src[j + 1:]
    raise ValueError("unbalanced braces after %s" % name)


def translate(src):
    """A .cu source as C++ for the stand-in."""
    for name, body in BODIES.items():
        src = _replace_body(src, name, body)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?"
                 r"(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem());", src)
    return re.sub(r"([\w:]+(?:<[^<>;]*?>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  lambda m: "emu::launch([&] { %s(%s); }, %s);"
                  % (m.group(1), m.group(3), m.group(2)), src, flags=re.S)


def build(kernel):
    OUT.mkdir(parents=True, exist_ok=True)
    cpp = OUT / (kernel + ".cpp")
    lib = OUT / ("lib%s.so" % kernel)
    cpp.write_text(translate((ROOT / "veles_tpu_torch" / "csrc" /
                              (kernel + ".cu")).read_text()))
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-shared",
                    "-fPIC", "-I", str(HERE), "-o", str(lib), str(cpp)],
                   check=True)
    return ctypes.CDLL(str(lib))


# -- flash attention ----------------------------------------------------------

FLASH_CASES = [(1, 7, 1, 16, False, None), (1, 70, 1, 64, True, 20),
               (1, 70, 2, 300, True, None), (1, 100, 1, 257, True, 30),
               (2, 40, 1, 320, False, None), (1, 65, 1, 512, True, None),
               (2, 33, 2, 384, True, 1),
               (1, 70, 1, 64, True, 20, (64, 16, 16)),
               (2, 100, 1, 48, False, None, (64, 16, 16))]


def _view(x):
    return [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)]


def flash_case(lib, b, t, h, d, causal, window, tiles=(0, 0, 0), *, seed):
    rng = numpy.random.RandomState(seed)
    qkv = torch.tensor(rng.standard_normal((b, t, 3 * h * d)) * 0.5,
                       dtype=torch.float32)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.tensor(rng.standard_normal((b, t, h, d)) * 0.5,
                      dtype=torch.float32)
    kw = dict(causal=causal, window=window)
    head = [b, t, h, d, 1.0 / d ** 0.5, int(causal), int(window or 0)]
    out, dq, dk, dv = (torch.full(q.shape, float("nan")) for _ in range(4))
    lse = torch.full((b * h, t), float("nan"))
    codes = [lib.vt_flash_fwd(*_view(q), *_view(k), *_view(v),
                              out.data_ptr(), lse.data_ptr(), *head,
                              tiles[0], None)]
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = fa.flash_delta(do, ref_out)
    bwd = _view(q) + _view(k) + _view(v) + _view(do) + [
        ref_lse.data_ptr(), delta.data_ptr()]
    codes.append(lib.vt_flash_dq(*bwd, dq.data_ptr(), *head, tiles[1],
                                 None))
    codes.append(lib.vt_flash_dkv(*bwd, dk.data_ptr(), dv.data_ptr(),
                                  *head, tiles[2], None))
    label = (b, t, h, d, causal, window) + ((tiles,) if any(tiles) else ())
    if any(codes):
        print(label, "launch failed", codes)
        return False
    ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta,
                                            **kw)

    def rel(a, r):
        return float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
    errs = dict(out=float((out - ref_out).abs().max()),
                lse=float((lse - ref_lse).abs().max()),
                dq=rel(dq, fa.flash_dq_reference(q, k, v, do, ref_lse,
                                                 delta, **kw)),
                dk=rel(dk, ref_dk), dv=rel(dv, ref_dv))
    ok = max(errs["out"], errs["lse"]) <= 2e-5 and \
        max(errs["dq"], errs["dk"], errs["dv"]) <= 5e-4
    print(label, "ok" if ok else "FAILED",
          {name: "%.2g" % e for name, e in errs.items()}, flush=True)
    return ok


def flash(cases):
    lib = build("flash_attention")
    view, tail = [_P, _L, _L, _L], [_I] * 4 + [_F, _I, _I, _I, _P]
    lib.vt_flash_fwd.argtypes = view * 3 + [_P, _P] + tail
    lib.vt_flash_dq.argtypes = view * 4 + [_P, _P, _P] + tail
    lib.vt_flash_dkv.argtypes = view * 4 + [_P] * 4 + tail
    cases = [eval(c) for c in cases] or FLASH_CASES
    return all([flash_case(lib, *c, seed=i) for i, c in enumerate(cases)])


# -- the compensated GEMM -----------------------------------------------------

#: (M, K, N, transposed a): K spans 3 and 4 tiles of 256, ragged M and N
PRECISE_CASES = [(20, 700, 30, False), (9, 1000, 12, True)]


def precise(quick=False):
    from veles_tpu_torch.znicz import gemm
    lib = build("precise_matmul")
    lib.vt_precise_matmul.argtypes = [_P] * 4 + [_I] * 3 + [_L] * 4 + \
        [_I, _I, _P]
    ok = True
    for i, (m, k, n, at) in enumerate(PRECISE_CASES[:1] if quick
                                      else PRECISE_CASES):
        rng = numpy.random.RandomState(i)
        a = torch.tensor(rng.standard_normal((k, m) if at else (m, k)),
                         dtype=torch.float32)
        a = a.t() if at else a
        b = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32)
        tiles = -(-k // 256)
        rule = lib.vt_precise_matmul_split(m, n, k, 132)
        for level in (1,) if quick else (0, 1, 2):
            outs = {}
            for split in sorted({0, rule, *range(1, tiles + 1)}):
                out = torch.full((m, n), float("nan"))
                ws = torch.empty(max(split and tiles, 1) * m * n)
                code = lib.vt_precise_matmul(
                    a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    ws.data_ptr() if split else None, m, n, k,
                    a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                    level, split, None)
                outs[split] = out if code == 0 else None
            want = gemm.precise_matmul_reference(a, b, level)
            scale = max(1.0, float(want.abs().max()))
            good = all(o is not None and torch.equal(o, outs[0])
                       for o in outs.values()) and \
                float((outs[0] - want).abs().max()) <= 1e-6 * scale
            ok &= good
            print((m, k, n, at), "level", level, "splits", sorted(outs),
                  "bitwise" if good else "FAILED", flush=True)
    return ok


# -- the int8-KV append -------------------------------------------------------

def append_case(lib, label, q, s, blk, off, vals):
    n = blk.numel()
    _, bs, h, d = q.shape
    kq, ks, rq, rs = q.clone(), s.clone(), q.clone(), s.clone()
    fn = (lib.vt_kv_append_int8_i32 if blk.dtype == torch.int32
          else lib.vt_kv_append_int8_i64)
    flat_blk = blk.reshape(-1).contiguous()
    flat_off = off.reshape(-1).to(blk.dtype).contiguous()
    code = fn(kq.data_ptr(), ks.data_ptr(), flat_blk.data_ptr(),
              flat_off.data_ptr(), vals.data_ptr(), n, bs, h, d, None)
    pa.kv_append_int8_reference(rq, rs, blk, off, vals)
    ok = code == 0 and torch.equal(kq[1:], rq[1:]) and \
        torch.equal(ks[1:], rs[1:])
    print(label, "bitwise" if ok else "FAILED (code %d)" % code, flush=True)
    return ok, kq, ks


def _pool(rng, nb, bs, h, d):
    return (torch.tensor(rng.randint(-127, 128, (nb, bs, h, d)),
                         dtype=torch.int8),
            torch.tensor(rng.uniform(0, 0.05, (nb, h)), dtype=torch.float32))


def _append_cases(rng):
    """(label, pool shape, blk, off, growing) with numpy indices."""
    out = [(label, shape, blk, off, False)
           for label, shape, blk, off in chip_smoke.append_cases()
           if label != "realistic"]
    for bs in (16, 32, 64):
        for d in (16, 128, 256):
            pos = 5 + numpy.arange(2 * bs + 7)
            out.append(("growing from offset 5, bs=%d d=%d" % (bs, d),
                        (9, bs, 2, d), numpy.array([6, 2, 8])[pos // bs],
                        pos % bs, True))
    pos = numpy.arange(24)
    out.append(("[2, 24]: a reopen mid-call, trash padding", (9, 16, 4, 16),
                numpy.stack([numpy.array([3, 5])[(pos + 8) // 16],
                             numpy.where(pos < 19, numpy.array([7, 2])[
                                 numpy.minimum(pos // 16, 1)], 0)]),
                numpy.stack([(pos + 8) % 16, pos % 16]), False))
    blk = 1 + numpy.arange(32)[:, None]
    blk[3] = 0
    out.append(("decode step [32, 1]", (36, 16, 4, 16), blk,
                rng.randint(0, 16, (32, 1)), False))
    pos = numpy.arange(2048)
    blk = (1 + rng.permutation(140)[:128])[pos // 16]
    blk[2000:] = 0
    out.append(("2048-write prefill", (141, 16, 2, 16), blk, pos % 16,
                False))
    return out


#: a few cases for a quick run: a run that grows its scale from
#: mid-block, a reopen mid-call with trash padding, and a decode step
#: whose warps take two runs each
QUICK_APPEND = ("growing from offset 5, bs=16 d=16",
                "[2, 24]: a reopen mid-call, trash padding",
                "decode step [32, 1]")


def append(labels=None):
    """Every append case, or only those named in ``labels``; -> whether
    all were bitwise equal to the plain version."""
    lib = build("kv_append")
    for sym in (lib.vt_kv_append_int8_i32, lib.vt_kv_append_int8_i64):
        sym.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    rng = numpy.random.RandomState(0)
    ok = True
    for label, shape, blk, off, growing in _append_cases(rng):
        if labels is not None and label not in labels:
            continue
        vals = torch.tensor(rng.standard_normal(blk.shape + shape[2:]),
                            dtype=torch.float32)
        if growing:
            vals *= torch.arange(1, blk.size + 1).reshape(
                blk.shape + (1, 1)).float() ** 2
        for dtype in (torch.int64, torch.int32):
            q, s = _pool(rng, *shape)
            tblk, toff = (torch.tensor(x).to(dtype) for x in (blk, off))
            good, kq, ks = append_case(lib, "%s, %s" % (label, dtype), q, s,
                                       tblk, toff, vals)
            again, _, _ = append_case(lib, "  a second call", kq, ks, tblk,
                                      toff, vals * 3)
            ok &= good and again
    if labels is not None:
        return ok
    blk = torch.tensor([1] * 8 + [2] * 3)
    off = torch.tensor(list(range(8)) + list(range(3)))
    for d in (12, 5):           # 4-byte and 1-byte lanes
        q, s = _pool(rng, 5, 8, 3, d)
        vals = torch.tensor(rng.standard_normal((11, 3, d)),
                            dtype=torch.float32)
        ok &= append_case(lib, "head dim %d" % d, q, s, blk, off, vals)[0]
    buf = torch.tensor(rng.standard_normal(11 * 3 * 16 + 1),
                       dtype=torch.float32)
    q, s = _pool(rng, 5, 8, 3, 16)
    ok &= append_case(lib, "values 4 bytes past an aligned address", q, s,
                      blk, off, buf[1:].view(11, 3, 16))[0]
    return ok


def main():
    args = sys.argv[1:]
    if not args or args[0] not in ("flash", "precise", "append"):
        raise SystemExit(__doc__.split("\n\n")[1])
    if args[0] == "flash":
        ok = flash(args[1:])
    elif args[0] == "precise":
        ok = precise("--quick" in args[1:])
    else:
        ok = append(QUICK_APPEND if "--quick" in args[1:] else None)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
