"""Persistent tuning store: measured winners, durable on disk.

The port's counterpart of ``veles_tpu/autotune/store.py``: the same
``.vtune`` records, :data:`SCHEMA` and required fields.  One JSON
record per ``(site, shape-class, environment)`` under one directory,
riding the compilecache store's durability discipline
(compilecache/store.py): every write is ``*.tmp`` + fsync + atomic
``os.rename``; records that fail to parse or validate are QUARANTINED
(renamed aside with ``.corrupt``) so the next lookup is a clean miss
and the caller falls back to the hand-picked default — a bad record
must never crash a kernel call or poison a second process.

The key hashes the site name, the shape class, and the environment
fingerprint (compilecache/keys.py: torch and CUDA versions, the card,
the toolchain and the kernel sources).  An upgrade, another card or an
edited kernel therefore produces a *different key* — a clean miss and a
re-tune, never a misload of a stale plan.  A record the JAX package
wrote carries its own (jax) fingerprint, so it is a clean miss here.
"""

import hashlib
import json
import logging
import os
import time

from ..observability.registry import REGISTRY

log = logging.getLogger("veles_tpu_torch.autotune")

#: record suffix; quarantined records get SUFFIX + ".corrupt"
SUFFIX = ".vtune"

#: record layout version — bump on schema change (old records then
#: quarantine-and-retune once, which is the upgrade path)
SCHEMA = 1

_REQUIRED = ("schema", "site", "shape_class", "fingerprint", "config",
             "default", "speedup", "gate", "measured_at")

_c_corrupt = REGISTRY.counter(
    "veles_autotune_corrupt_total",
    "Tuning records quarantined as unreadable or invalid")


def environment_fingerprint():
    """The tuning environment string — compilecache's fingerprint
    verbatim (monkeypatch THAT module in tests to simulate drift)."""
    from ..compilecache import keys
    return keys.environment_fingerprint()


def record_key(site, shape_class, fingerprint=None):
    """SHA-256 key (hex) for one ``(site, shape-class, environment)``."""
    if fingerprint is None:
        fingerprint = environment_fingerprint()
    h = hashlib.sha256()
    for part in (site, shape_class, fingerprint):
        h.update(str(part).encode())
        h.update(b"\x00")
    return h.hexdigest()


class TuningStore:
    """site + shape-class -> measured-winner records under one dir."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._warned = set()            # keys already logged (log-once)

    def path_for(self, key):
        return os.path.join(self.directory, key + SUFFIX)

    # -- read ----------------------------------------------------------------
    def get(self, site, shape_class):
        """The validated record for the CURRENT environment, or None
        (miss / corrupt — corrupt records are quarantined and warned
        about once; the caller falls back to its default config)."""
        fingerprint = environment_fingerprint()
        key = record_key(site, shape_class, fingerprint)
        path = self.path_for(key)
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return None
        record, reason = self._validate(text, site, shape_class,
                                        fingerprint)
        if record is None:
            self.quarantine(key, reason)
            if key not in self._warned:
                self._warned.add(key)
                log.warning(
                    "autotune: record for %s/%s is %s; quarantined "
                    "(%s.corrupt) and falling back to the hand-picked "
                    "default config", site, shape_class, reason,
                    os.path.basename(path))
            return None
        return record

    @staticmethod
    def _validate(text, site=None, shape_class=None, fingerprint=None):
        """(record, None) or (None, reason).  Beyond JSON parseability
        the stored identity fields must MATCH the key that found the
        record — a renamed/copied file can never smuggle a config onto
        the wrong site, shape, or environment."""
        try:
            record = json.loads(text)
        except ValueError as exc:
            return None, "unparseable (%s)" % exc
        if not isinstance(record, dict):
            return None, "not an object"
        missing = [k for k in _REQUIRED if k not in record]
        if missing:
            return None, "missing fields %s" % ",".join(missing)
        if record["schema"] != SCHEMA:
            return None, "schema %r != %d" % (record["schema"], SCHEMA)
        if not isinstance(record["config"], dict):
            return None, "config is not an object"
        for field, want in (("site", site), ("shape_class", shape_class),
                            ("fingerprint", fingerprint)):
            if want is not None and record[field] != want:
                return None, "%s mismatch" % field
        return record, None

    # -- write ---------------------------------------------------------------
    def put(self, site, shape_class, config, *, default, speedup,
            gate="passed", baseline_s=None, best_s=None,
            candidates_tried=None, extra=None):
        """Atomically persist a measured winner; returns the record."""
        fingerprint = environment_fingerprint()
        env = dict(kv.split("=", 1) for kv in fingerprint.split(";")
                   if "=" in kv)
        record = {
            "schema": SCHEMA,
            "site": site,
            "shape_class": shape_class,
            "fingerprint": fingerprint,
            "config": dict(config),
            "default": dict(default),
            "speedup": round(float(speedup), 4),
            "gate": gate,
            "measured_at": time.time(),
            # provenance the CLI surfaces per record
            "device_kind": env.get("device_kind", "?"),
            "platform": env.get("platform", "?"),
            "torch": env.get("torch", "?"),
            "cuda": env.get("cuda", "?"),
        }
        if baseline_s is not None:
            record["baseline_s"] = baseline_s
        if best_s is not None:
            record["best_s"] = best_s
        if candidates_tried is not None:
            record["candidates_tried"] = int(candidates_tried)
        if extra:
            record["extra"] = extra
        key = record_key(site, shape_class, fingerprint)
        path = self.path_for(key)
        tmp = path + ".tmp.%d" % os.getpid()
        try:
            with open(tmp, "w") as f:
                json.dump(record, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)
        except OSError:
            # a full/read-only disk must never fail the tuner — the
            # measurement already happened; the winner is just not saved
            log.warning("autotune: could not persist record %s under %s",
                        key[:16], self.directory, exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._warned.discard(key)       # a rewrite clears the log-once
        return record

    def quarantine(self, key, reason=""):
        """Rename a bad record aside (``.corrupt``).  Idempotent."""
        path = self.path_for(key)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            return False
        _c_corrupt.inc()
        log.debug("autotune: quarantined record %s (%s)", key[:16],
                  reason or "invalid")
        return True

    # -- listing (CLI) -------------------------------------------------------
    def records(self):
        """[(key, record_or_None, reason_or_None)] for every on-disk
        record, corrupt ones included (record None + reason) — the
        ``list``/``verify`` surface.  Read-only: nothing is quarantined
        here."""
        out = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for name in names:
            if not name.endswith(SUFFIX):
                continue
            key = name[:-len(SUFFIX)]
            try:
                with open(os.path.join(self.directory, name)) as f:
                    text = f.read()
            except OSError:
                continue            # raced with a concurrent quarantine
            record, reason = self._validate(text)
            out.append((key, record, reason))
        return out
