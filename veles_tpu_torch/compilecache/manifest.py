"""Warmup manifests: what a restart should warm, and first.

The port's copy of ``veles_tpu/compilecache/manifest.py``, the same
file format, so a manifest written by either package reads in the
other.  Serving records every (model, bucket) it warmed; on the next
start the scheduler warms those entries FIRST (its kernels come off the
build cache, so nothing is compiled), so the shapes real traffic uses
are ready before the speculative tail of the bucket ladder.  The
manifest is advisory: a missing/corrupt file means "no history", never
an error.

The JSON file lives next to the cache entries (atomic tmp+fsync+rename
writes, same conventions as :mod:`.store`) and is tiny — one record per
(model, bucket) ever compiled.
"""

import json
import logging
import os
import threading

log = logging.getLogger("veles_tpu_torch.compilecache")


class WarmupManifest:
    """Thread-safe (model, bucket) history backed by one JSON file."""

    def __init__(self, path):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        self._models, self._configs = self._load()

    def _load(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
            models = data.get("models", {})
            if not isinstance(models, dict):
                raise ValueError("manifest 'models' is not a dict")
            configs = data.get("configs", {})
            if not isinstance(configs, dict):
                raise ValueError("manifest 'configs' is not a dict")
            return ({str(name): list(entries)
                     for name, entries in models.items()},
                    {str(name): dict(sites)
                     for name, sites in configs.items()})
        except FileNotFoundError:
            return {}, {}
        except (OSError, ValueError) as exc:
            # a mangled manifest only loses warmup ORDER, never
            # correctness — start empty and say so once
            log.warning("warmup manifest %s unreadable (%s); starting "
                        "empty", self.path, exc)
            return {}, {}

    def _save_locked(self):
        tmp = self.path + ".tmp.%d" % os.getpid()
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            doc = {"models": self._models}
            if self._configs:       # old readers only look at "models"
                doc["configs"] = self._configs
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self.path)
        except OSError:
            log.warning("warmup manifest: could not persist %s",
                        self.path, exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- recording -----------------------------------------------------------
    def record(self, model, bucket, sample_shape=None):
        """Note that ``model`` compiled ``bucket``; persists immediately
        (compiles are rare).  Returns True when the entry is new."""
        entry = {"bucket": int(bucket)}
        if sample_shape is not None:
            entry["sample_shape"] = [int(d) for d in sample_shape]
        with self._lock:
            entries = self._models.setdefault(str(model), [])
            if any(e.get("bucket") == entry["bucket"] for e in entries):
                return False
            entries.append(entry)
            entries.sort(key=lambda e: e.get("bucket", 0))
            self._save_locked()
        return True

    def record_config(self, model, site, config):
        """Note the tuned config ``model`` resolved for autotune
        ``site`` (e.g. ``serving.bucket_ladder``) — advisory, like
        buckets: a warm restart reads the same geometry back before
        compiling, so tuned winners never cost a fresh compile.
        Returns True when the stored value changed."""
        config = dict(config)
        with self._lock:
            sites = self._configs.setdefault(str(model), {})
            if sites.get(str(site)) == config:
                return False
            sites[str(site)] = config
            self._save_locked()
        return True

    # -- reading -------------------------------------------------------------
    def buckets(self, model):
        """Recorded bucket sizes for ``model``, smallest first."""
        with self._lock:
            return sorted(int(e["bucket"])
                          for e in self._models.get(str(model), ())
                          if "bucket" in e)

    def configs(self, model):
        """Recorded tuned configs for ``model``: {site: config}."""
        with self._lock:
            return {site: dict(cfg) for site, cfg
                    in self._configs.get(str(model), {}).items()}

    def models(self):
        with self._lock:
            return sorted(set(self._models) | set(self._configs))

    def forget(self, model):
        """Drop one model's history (hot-unload / tests)."""
        with self._lock:
            had = self._models.pop(str(model), None) is not None
            had = (self._configs.pop(str(model), None)
                   is not None) or had
            if not had:
                return False
            self._save_locked()
        return True
