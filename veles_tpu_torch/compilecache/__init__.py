"""Persistent build cache for the CUDA kernels + warmup manifests.

The port's counterpart of ``veles_tpu/compilecache``.  Every process
used to build the kernels it launches into ``build/veles_tpu_torch/``
of its own checkout; with a cache directory set, the libraries live in
one store that survives the process and is shared by every process
pointed at it (a fleet's replicas, a respawn, a restarted server), so
a warm restart runs no ``nvcc`` at all:

- :mod:`.keys` — key a library by its source and the toolchain, so a
  stale entry *misses* instead of loading; the wider environment
  fingerprint the tuning store keys on;
- :mod:`.store` — content-addressed on-disk store (tmp + fsync + atomic
  rename), with a size-budget LRU sweep and quarantine-on-corrupt;
- :mod:`.cache` — :class:`CompileCache`, the lookup / persist /
  quarantine layer ``_build`` builds through, with its counters;
- :mod:`.manifest` — :class:`WarmupManifest` (the JAX package's file
  format): serving records every (model, bucket) it warmed and the
  tuned configs it resolved; a restart warms those first.

Config: ``root.common.compile_cache.{dir, enabled, max_bytes,
background_warmup}`` (or ``$VELES_COMPILE_CACHE_DIR``).  Unset dir =
kernels built exactly as without the cache.
"""

from .cache import (CompileCache, default_cache, inject_env,
                    reset_default_caches, resolve_config)
from .keys import cache_key, environment_fingerprint
from .manifest import WarmupManifest
from .store import ExecutableStore

__all__ = ["CompileCache", "ExecutableStore", "WarmupManifest",
           "cache_key", "default_cache", "environment_fingerprint",
           "inject_env", "reset_default_caches", "resolve_config"]
