"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Every ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), under ``build/veles_tpu_torch/`` at the root of the checkout.
The file name carries a digest of the source and the flags, so an edited
source rebuilds and an unchanged one loads what is already there.  A
build writes to a temporary name and renames it into place, so
processes building at once never load half a library.

Nothing builds at import time: :func:`library` builds on first use, and
:func:`build` starts one ``nvcc`` for each source, all at once.  With a
build cache configured (``root.common.compile_cache.dir`` or
``$VELES_COMPILE_CACHE_DIR``; :mod:`.compilecache`) the libraries are
built into and loaded from its store instead, keyed by source and
toolchain, so a process started against a warm cache runs no ``nvcc``;
a cached library that fails to load is quarantined and rebuilt.
``build.nvcc_runs`` counts the ``nvcc`` processes this process started
(the builds, ``build.compiles``, and a version query where the toolkit
has no ``version.json``).

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
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "library",
           "load_all", "function", "check", "stream_ptr"]

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


def _resolve_cache(cache):
    """``cache`` itself, or the configured build cache (None: off)."""
    if cache is None:
        from .compilecache import default_cache
        cache = default_cache()
    return cache or None


def build(names=None, verbose=False, cache=None):
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` process each, all started together.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills).
    ``cache``: a :class:`~.compilecache.CompileCache` to build into and
    load from (default: the configured one; ``False`` or none
    configured: ``build/veles_tpu_torch/``).  Returns ``{name: (library
    path, compiler output or "")}``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    cache = _resolve_cache(cache)
    if cache is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        src, lib = _target(name)
        key = None
        if cache is not None:
            key = cache.key_for(name, src.read_bytes(), NVCC_FLAGS)
            found = None if verbose else cache.lookup(key, name)
            if found is not None:
                out[name] = (Path(found), "")
                _keys[name] = (cache, key)
                continue
            tmp = Path(cache.store.tmp_path(key))
        elif lib.exists() and not verbose:
            out[name] = (lib, "")
            continue
        else:
            tmp = lib.with_name("%s.%d.tmp" % (lib.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                        else []) + ["-o", str(tmp),
                                                    str(src)]
        build.nvcc_runs += 1
        build.compiles += 1
        running.append((name, lib, key, tmp, time.perf_counter(),
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True)))
    failed = []
    for name, lib, key, tmp, t0, proc in running:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        if cache is not None:
            lib = Path(cache.persist(key, str(tmp), name,
                                     time.perf_counter() - t0))
            _keys[name] = (cache, key)
        else:
            os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


#: ``nvcc`` processes started by this process (builds and, where the
#: toolkit has no version.json, one version query)
build.nvcc_runs = 0
#: of those, the builds
build.compiles = 0

#: name -> (cache, key) of the libraries the build cache gave this
#: process, for quarantine when one fails to load
_keys = {}


def _load(name, cache=None, path=None):
    if path is None:
        path = build([name], cache=cache)[name][0]
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        entry = _keys.pop(name, None)
        if entry is None:
            raise
        owner, key = entry
        owner.quarantine(key, name, exc)
        return ctypes.CDLL(str(build([name], cache=owner)[name][0]))


def library(name, cache=None, path=None):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first
    use (through ``cache``, default the configured build cache) unless
    ``path`` names the library :func:`build` just gave."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _load(name, cache, path)
                lib.vt_error_string.argtypes = [ctypes.c_int]
                lib.vt_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def load_all(cache=None):
    """Build (or fetch from ``cache``) and load every kernel library
    now: one ``nvcc`` per missing source, all started together.  A
    scheduler warming up against a build cache calls this, so its
    kernels come from that cache and a warm restart builds nothing."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    missing = [n for n in names if n not in _libs]
    if missing:
        built = build(missing, cache=cache)
        for name in missing:
            library(name, cache=cache, path=built[name][0])
    return names


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
