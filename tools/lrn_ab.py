#!/usr/bin/env python3
"""Time the LRN kernels (K5, K6) of several copies of their source in
turns on one card: the working tree's ``veles_tpu_torch/csrc/lrn.cu``
against each copy named on the command line.

    git show HEAD~1:veles_tpu_torch/csrc/lrn.cu > build/lrn_parent.cu
    sed 's/powf(/__powf(/' veles_tpu_torch/csrc/lrn.cu > build/lrn_fast.cu
    python3 tools/lrn_ab.py build/lrn_parent.cu build/lrn_fast.cu

Each source is built with the port's nvcc flags (``-Xptxas -v``: ptxas's
registers and spills are printed) into ``build/lrn_ab/``.  Each is held
against the plain versions (``lrn_reference``, ``lrn_backward_reference``)
at chip_smoke's ``LRN_SHAPES`` and ``LRN_SMALL`` cases and whether it
gives their bits is printed (a knocked-out copy need not).  Then each is
timed at ``LRN_SHAPES``, in the order first, ..., last, last, ..., first:
the mean of 50 launches between CUDA events and the profiler's device
time a launch, both printed for each turn, beside the card's name and
power limit.  Imports nothing of JAX.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from veles_tpu_torch import _build  # noqa: E402
from veles_tpu_torch.znicz import lrn  # noqa: E402

OUT = ROOT / "build" / "lrn_ab"
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def build(sources):
    """{name: (forward entry, backward entry)}, one nvcc for each source,
    all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / ("lib%s.so" % name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("nvcc failed on %s:\n%s" % (name, log))
        for fn, regs, stores, loads in chip_smoke.ptxas_report(log):
            print("ptxas %s: %s: %d registers, %d + %d bytes spilled"
                  % (name, fn, regs, stores, loads))
        so = ctypes.CDLL(str(lib))
        fwd, bwd = so.vt_lrn_fwd, so.vt_lrn_bwd
        fwd.argtypes = [_P, _P, _L, _I, _I, _F, _F, _F, _P]
        bwd.argtypes = [_P, _P, _P, _L, _I, _I] + [_F] * 5 + [_P]
        fwd.restype = bwd.restype = _I
        entries[name] = (fwd, bwd)
    return entries


def calls(entry, x, g, y, dx, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """(K5 call, K6 call) of one build on x, g into y, dx."""
    fwd, bwd = entry
    c = x.shape[-1]
    rows = x.numel() // c
    stream = _build.stream_ptr(x.device)

    def k5():
        if fwd(x.data_ptr(), y.data_ptr(), rows, c, n, alpha / n, k, beta,
               stream):
            raise RuntimeError("K5 launch failed")

    def k6():
        if bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, n,
               alpha / n, k, -beta, -beta - 1.0, 2.0 * beta * (alpha / n),
               stream):
            raise RuntimeError("K6 launch failed")
    return k5, k6


def bitwise(entries, dev):
    cases = [(shape, chip_smoke.LRN_PARAMS)
             for _, shape in chip_smoke.LRN_SHAPES]
    cases += list(chip_smoke.LRN_SMALL)
    equal = {name: 0 for name in entries}
    for i, (shape, params) in enumerate(cases):
        x, g = chip_smoke._lrn_inputs(torch, dev, shape, 300 + i)
        want = (lrn.lrn_reference(x, *params),
                lrn.lrn_backward_reference(x, g, *params))
        for name, entry in entries.items():
            got = torch.empty_like(x), torch.empty_like(x)
            for call in calls(entry, x, g, *got, *params):
                call()
            torch.cuda.synchronize()
            equal[name] += all(map(torch.equal, got, want))
    for name, count in equal.items():
        print("%s: bitwise equal to the plain versions in %d of %d cases"
              % (name, count, len(cases)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("lrn_ab: torch sees no CUDA device")
    sources = {"tree": ROOT / "veles_tpu_torch" / "csrc" / "lrn.cu"}
    sources.update((Path(p).stem, Path(p).resolve()) for p in sys.argv[1:])
    dev = torch.device("cuda")
    print(chip_smoke._card_line())
    entries = build(sources)
    bitwise(entries, dev)
    order = list(entries) + list(entries)[::-1]
    for label, shape in chip_smoke.LRN_SHAPES:
        x, g = chip_smoke._lrn_inputs(torch, dev, shape, 5)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        for name in order:
            for kid, call in zip(("K5", "K6"),
                                 calls(entries[name], x, g, y, dx)):
                print("%s %s %s: event %.4f ms, device %.4f ms"
                      % (label, kid, name,
                         chip_smoke._cuda_ms(torch, call, iters=50),
                         chip_smoke._device_ms(torch, call, iters=50,
                                               per_launch=True)))
    print(chip_smoke._card_line())


if __name__ == "__main__":
    main()
