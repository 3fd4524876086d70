"""Cache keys: fingerprint a build so stale entries MISS.

The port's counterpart of ``veles_tpu/compilecache/keys.py``.  A built
kernel library is only reusable by a process whose toolchain would have
produced the same binary, so :func:`cache_key` hashes the CUDA source
together with the compiler's version line and flags.  The JAX key hashed
StableHLO text; a library with a plain C interface depends on nothing
else (the flags fix the card's architecture, ``sm_90a``).

:func:`environment_fingerprint` is the wider string the tuning store
keys its records on: a measured winner holds only for the card, the
library versions and the kernel sources it was measured with.  Any
drift gives a different key: a clean miss and a fresh build or tune,
never a load of a wrong library or a stale plan.

Neither runs ``nvcc`` when the toolkit's ``version.json`` names the
compiler's version.  Without one, ``nvcc --version`` is asked once a
process, and a build cache's directory remembers the answer for the
binary (``nvcc_versions.json``), so a process started against a cache
that a process before it filled runs no ``nvcc`` at all.
"""

import hashlib
import json
import os
import subprocess

import torch

from .. import _build

_nvcc_line = []

#: the file in a build cache's directory that remembers each compiler's
#: version line, keyed by the binary's path, size and mtime
VERSIONS_FILE = "nvcc_versions.json"


def _versions_path():
    from .cache import resolve_config
    directory = resolve_config()[0]
    return os.path.join(directory, VERSIONS_FILE) if directory else None


def _read_nvcc_line():
    try:
        nvcc = os.path.realpath(_build._nvcc())
    except RuntimeError:
        return "none"
    root = os.path.dirname(os.path.dirname(nvcc))
    try:
        with open(os.path.join(root, "version.json")) as f:
            version = json.load(f)["cuda_nvcc"]["version"]
        return "cuda_nvcc %s" % version
    except (OSError, ValueError, KeyError, TypeError):
        pass
    # no version.json: ask nvcc once per binary and build cache
    st = os.stat(nvcc)
    ident = "%s:%d:%d" % (nvcc, st.st_size, st.st_mtime_ns)
    memo_path = _versions_path()
    memo = {}
    if memo_path:
        try:
            with open(memo_path) as f:
                memo = json.load(f)
            if ident in memo:
                return memo[ident]
        except (OSError, ValueError):
            memo = {}
    _build.build.nvcc_runs += 1
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    line = lines[-1] if lines else "unknown"
    if memo_path and lines:
        memo[ident] = line
        tmp = memo_path + ".tmp.%d" % os.getpid()
        try:
            os.makedirs(os.path.dirname(memo_path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(memo, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, memo_path)
        except OSError:
            pass                    # a read-only cache: ask again later
    return line


def nvcc_version_line():
    """The compiler's version, ``"none"`` where there is no ``nvcc``
    (memoized: the toolkit does not change under a running process)."""
    if not _nvcc_line:
        _nvcc_line.append(_read_nvcc_line())
    return _nvcc_line[0]


def toolchain_fingerprint():
    """The compiler's version line and :data:`_build.NVCC_FLAGS`."""
    return "nvcc=%s;flags=%s" % (nvcc_version_line(),
                                 " ".join(_build.NVCC_FLAGS))


def sources_digest():
    """SHA-256 (hex, 16 chars) over every ``csrc/*.cu``, by name."""
    h = hashlib.sha256()
    for path in sorted(_build.CSRC.glob("*.cu")):
        h.update(path.name.encode())
        h.update(b"\x00")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _device_part():
    if not torch.cuda.is_available():
        return "platform=none;device_kind=none;cc=none;sms=0;devices=0"
    props = torch.cuda.get_device_properties(0)
    return "platform=gpu;device_kind=%s;cc=%d.%d;sms=%d;devices=%d" % (
        props.name, props.major, props.minor,
        props.multi_processor_count, torch.cuda.device_count())


def environment_fingerprint():
    """The tuning environment as a stable string: torch and CUDA
    versions, the card (name, compute capability, SM count; ``none``
    without one, so a key is still valid), the toolchain and the digest
    of the kernel sources.  Monkeypatchable in tests, so drift is
    testable without a second card."""
    return "torch=%s;cuda=%s;%s;%s;csrc=%s" % (
        torch.__version__, torch.version.cuda or "none", _device_part(),
        toolchain_fingerprint(), sources_digest())


def cache_key(source, extra=None):
    """SHA-256 key (hex) of one built library: its source (bytes or
    text), the toolchain, and ``extra`` (a dict of caller-supplied
    discriminators, hashed as its sorted repr)."""
    if isinstance(source, str):
        source = source.encode()
    h = hashlib.sha256()
    h.update(source)
    h.update(b"\x00")
    h.update(toolchain_fingerprint().encode())
    if extra:
        h.update(b"\x00")
        h.update(repr(sorted(extra.items())).encode())
    return h.hexdigest()
