"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Every ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), under ``build/veles_tpu_torch/`` at the root of the checkout.
The file name carries a digest of the source and the flags, so an edited
source rebuilds and an unchanged one loads what is already there.  A
build writes to a temporary name and renames it into place, so
processes building at once never load half a library.

Nothing builds at import time: :func:`library` builds on first use, and
:func:`build` starts one ``nvcc`` for each source, all at once.

Each C entry returns ``cudaGetLastError()`` after its launch; the
wrappers pass the code to :func:`check`, which raises on anything but 0.
The stream is PyTorch's current one, passed as a ``c_void_p``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "library",
           "function", "check", "stream_ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "veles_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}
_fns = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def _target(name):
    src = CSRC / (name + ".cu")
    if not src.exists():
        raise FileNotFoundError("no kernel source %s" % src)
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, digest[:16]))


def build(names=None, verbose=False):
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` process each, all started together.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills).
    Returns ``{name: (library path, compiler output or "")}``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        src, lib = _target(name)
        if lib.exists() and not verbose:
            out[name] = (lib, "")
            continue
        tmp = lib.with_name("%s.%d.tmp" % (lib.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                        else []) + ["-o", str(tmp),
                                                    str(src)]
        running.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def library(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = build([name])[name][0]
                lib = _libs[name] = ctypes.CDLL(str(path))
                lib.vt_error_string.argtypes = [ctypes.c_int]
                lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def function(name, symbol, argtypes, restype=ctypes.c_int):
    """``library(name).<symbol>`` with its argument and return types
    declared (pointers and the stream as ``c_void_p``)."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[key] = fn
    return fn


def check(name, code, what):
    """Raise if a C entry of ``csrc/<name>.cu`` returned a CUDA error."""
    if code:
        msg = library(name).vt_error_string(int(code))
        raise RuntimeError("%s failed: CUDA error %d (%s)"
                           % (what, code, msg.decode() if msg else "?"))


def stream_ptr(device):
    """PyTorch's current CUDA stream on ``device`` as a ``c_void_p``."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
