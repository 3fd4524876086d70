"""Dispatch: kernels resolve their configs here, cheaply and safely.

The port's counterpart of ``veles_tpu/autotune/dispatch.py``.
``resolve(site, shape_class, default)`` is the one call every tunable
site makes (lrn.py, flash_attention.py, gemm.py, paged_attention.py,
decode.py, scheduler.py).  Resolution order:

1. tuner off (no ``root.common.autotune.dir`` and no
   ``$VELES_AUTOTUNE_DIR``, or ``enabled`` false) -> the hand-picked
   ``default``, with NO disk access — byte-for-byte the pre-tuner
   behavior;
2. store hit for the current environment -> the measured winner
   (``veles_autotune_tuned_hits_total``);
3. miss / corrupt / version drift -> the default again
   (``veles_autotune_fallbacks_total``).

Results are memoized per ``(dir, site, shape-class)`` so kernel call
paths pay one disk read per shape class per process, not one per call.
"""

import os

from ..config import root
from ..observability.registry import REGISTRY
from . import space as _space
from .store import TuningStore

#: env var a supervisor/bench parent uses to hand the tuning dir to
#: child processes that don't re-read its programmatic config
AUTOTUNE_DIR_ENV = "VELES_AUTOTUNE_DIR"

_c_hits = REGISTRY.counter(
    "veles_autotune_tuned_hits_total",
    "Site resolutions served a measured tuning record")
_c_fallbacks = REGISTRY.counter(
    "veles_autotune_fallbacks_total",
    "Site resolutions that fell back to the hand-picked default "
    "(store configured but no valid record for this environment)")


def resolve_config():
    """The tuning-store directory, or None (tuner off) — from
    ``root.common.autotune.{enabled, dir}`` with the
    :data:`AUTOTUNE_DIR_ENV` env fallback."""
    cfg = root.common.autotune
    if not cfg.get("enabled", True):
        return None
    directory = cfg.get("dir", None) or os.environ.get(AUTOTUNE_DIR_ENV)
    return str(directory) if directory else None


_instances = {}
_memo = {}


def default_store():
    """The process-wide :class:`TuningStore` for the configured dir,
    or None when the tuner is off."""
    directory = resolve_config()
    if not directory:
        return None
    key = os.path.abspath(directory)
    store = _instances.get(key)
    if store is None:
        store = _instances[key] = TuningStore(directory)
    return store


def reset_default_stores():
    """Drop memoized stores AND resolutions (tests that switch dirs or
    rewrite records mid-process)."""
    _instances.clear()
    _memo.clear()


def resolve(site, shape_class, default=None):
    """-> ``(config, source)`` where source is ``"tuned"`` or
    ``"default"``.  ``default`` falls back to the site's declared
    hand-picked config; the returned dict is a copy (mutation-safe)."""
    if default is None:
        default = _space.site(site).default
    store = default_store()
    if store is None:
        return dict(default), "default"
    memo_key = (store.directory, site, shape_class)
    hit = _memo.get(memo_key)
    if hit is None:
        record = store.get(site, shape_class)
        if record is not None:
            hit = (record["config"], "tuned")
            _c_hits.inc()
        else:
            hit = (dict(default), "default")
            _c_fallbacks.inc()
        _memo[memo_key] = hit
    config, source = hit
    # tolerate records written by a space that has since GROWN params:
    # missing keys take the default, so dispatch never KeyErrors
    merged = dict(default)
    merged.update(config)
    return merged, source


def describe(site, shape_class, default=None):
    """JSON provenance helper: the resolved config flattened with its
    ``config_source`` tag."""
    config, source = resolve(site, shape_class, default)
    out = dict(config)
    out["config_source"] = source
    return out
