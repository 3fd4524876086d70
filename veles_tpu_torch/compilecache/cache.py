"""The build cache: kernel libraries that survive the process.

The port's counterpart of ``veles_tpu/compilecache/cache.py``.
:class:`CompileCache` sits between :mod:`veles_tpu_torch._build` and
``nvcc``: a library is keyed by its source and the toolchain
(:mod:`.keys`), looked up in the on-disk store (:mod:`.store`), and
either loaded where it lies (a hit: no ``nvcc``) or built fresh into
the store for the next process (a miss).  Every outcome is counted:
hits, misses (builds) and bytes written on the port's registry as the
JAX package's families ``veles_compile_cache_{hits,misses,bytes}_total``
(every family the registry exports is documented in
``docs/COMPONENTS.md``, which names no quarantine family), quarantines
in :meth:`CompileCache.stats`; and traced as ``compile.cache_hit`` /
``compile.miss`` events.

Failure policy: the cache may only ever cost a rebuild, never a crash
or a wrong result.  An entry that fails to load is quarantined and
rebuilt; a full disk loses the persist, not the build; toolchain drift
changes the key and misses cleanly.

The JAX package's ``AotStep`` (the fused train step deserialized off
the cache) has no counterpart: the port's steps run eagerly, with
nothing to serialize, until its steps become CUDA graphs.
"""

import logging
import os

from ..config import root
from ..logger import events
from ..observability.registry import REGISTRY
from .keys import cache_key
from .manifest import WarmupManifest
from .store import ExecutableStore

log = logging.getLogger("veles_tpu_torch.compilecache")

#: env vars a supervisor uses to hand the cache to child processes that
#: do not re-read its programmatic config
CACHE_DIR_ENV = "VELES_COMPILE_CACHE_DIR"
MAX_BYTES_ENV = "VELES_COMPILE_CACHE_MAX_BYTES"
#: the tuning store's, forwarded by :func:`inject_env` (a literal here:
#: importing the autotune package would cycle)
AUTOTUNE_DIR_ENV = "VELES_AUTOTUNE_DIR"


class CompileCache:
    """Persistent build cache over one directory."""

    def __init__(self, directory, max_bytes=None, registry=None):
        registry = registry or REGISTRY
        self.store = ExecutableStore(directory, max_bytes=max_bytes)
        self.manifest = WarmupManifest(
            os.path.join(self.store.directory, "warmup_manifest.json"))
        self._c_hits = registry.counter(
            "veles_compile_cache_hits_total",
            "Build cache hits (a kernel library loaded, not built)")
        self._c_misses = registry.counter(
            "veles_compile_cache_misses_total",
            "Build cache misses (a fresh nvcc build)")
        self._c_bytes = registry.counter(
            "veles_compile_cache_bytes_total",
            "Bytes of kernel libraries written to the build cache")
        self._quarantined = set()   # keys set aside (warned once each)

    @staticmethod
    def key_for(name, source, flags):
        """The store key of library ``name`` built from ``source`` with
        ``flags``."""
        return cache_key(source, {"name": str(name),
                                  "flags": " ".join(flags)})

    def lookup(self, key, name="lib"):
        """The path of a stored library, or None (a miss the caller
        builds and :meth:`persist`\\ s)."""
        path = self.store.lookup(key)
        if path is not None:
            self._c_hits.inc()
            events.event("compile.cache_hit", lib=name, key=key[:16])
        return path

    def persist(self, key, built, name="lib", seconds=0.0):
        """Move the freshly built file ``built`` into the store under
        ``key``; returns the path to load (``built`` itself when the
        disk refused the entry)."""
        self._c_misses.inc()
        events.span("compile.miss", seconds, lib=name, key=key[:16])
        stored = self.store.put_file(key, built)
        if not stored:
            return built
        self._c_bytes.inc(stored)
        return self.store.path_for(key)

    def quarantine(self, key, name="lib", reason=""):
        """Set aside an entry that failed to load (warned once a key)."""
        self.store.quarantine(key, reason)
        if key not in self._quarantined:
            self._quarantined.add(key)
            log.warning("compile cache: entry %s for %r was corrupt (%s); "
                        "rebuilding", key[:16], name, str(reason)[:200])

    def stats(self):
        return {"directory": self.store.directory,
                "entries": len(self.store.entries()),
                "total_bytes": self.store.total_bytes(),
                "max_bytes": self.store.max_bytes,
                "hits": int(self._c_hits.value),
                "misses": int(self._c_misses.value),
                "quarantined": len(self._quarantined)}


# -- config resolution --------------------------------------------------------

def resolve_config():
    """(directory_or_None, max_bytes) from
    ``root.common.compile_cache.{enabled, dir, max_bytes}`` with the
    :data:`CACHE_DIR_ENV` / :data:`MAX_BYTES_ENV` env fallbacks.  A
    None directory means the cache is OFF: kernels build into
    ``build/veles_tpu_torch/`` as without it."""
    cfg = root.common.compile_cache
    if not cfg.get("enabled", True):
        return None, None
    directory = cfg.get("dir", None) or os.environ.get(CACHE_DIR_ENV)
    max_bytes = cfg.get("max_bytes", None)
    if max_bytes is None and os.environ.get(MAX_BYTES_ENV):
        try:
            max_bytes = int(os.environ[MAX_BYTES_ENV])
        except ValueError:
            max_bytes = None
    return (str(directory) if directory else None), max_bytes


_instances = {}


def default_cache():
    """The process-wide :class:`CompileCache` for the configured dir,
    or None when no dir is configured (cache off)."""
    directory, max_bytes = resolve_config()
    if not directory:
        return None
    key = (os.path.abspath(directory), max_bytes)
    cache = _instances.get(key)
    if cache is None:
        cache = _instances[key] = CompileCache(directory,
                                               max_bytes=max_bytes)
    return cache


def reset_default_caches():
    """Drop memoized instances (tests that switch config dirs)."""
    _instances.clear()


def inject_env(env=None):
    """Return ``env`` (default: a copy of os.environ) with the
    configured cache dir and tuning dir exported for a child process —
    how a fleet's replicas share the supervisor's cache and winners
    without re-reading its programmatic config.  Unset: ``env`` as
    given."""
    directory, max_bytes = resolve_config()
    tune_dir = root.common.get("autotune", {}).get("dir", None)
    if not directory and not tune_dir:
        return env
    env = dict(os.environ if env is None else env)
    if directory:
        env.setdefault(CACHE_DIR_ENV, os.path.abspath(directory))
        if max_bytes:
            env.setdefault(MAX_BYTES_ENV, str(int(max_bytes)))
    if tune_dir:
        env.setdefault(AUTOTUNE_DIR_ENV, os.path.abspath(str(tune_dir)))
    return env
