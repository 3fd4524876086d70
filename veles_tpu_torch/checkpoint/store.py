"""Content-addressed chunk store for sharded tensor checkpoints.

The port's copy of ``veles_tpu/checkpoint/store.py``: the same on-disk
layout and the same sha256 digest, so a chunk (a checkpoint's tensor
band, a disk-tier KV block) written by one package reads in the other.

Durability: every blob lands as ``*.tmp.<pid>`` + flush + fsync +
atomic ``os.rename`` — a kill at any point leaves either no chunk or a
complete one, never a truncated file at its final name.  Chunks are
named by the sha256 of their content, so

- a chunk is written at most once no matter how many tensors (or how
  many consecutive checkpoints) contain the same bytes — that is the
  whole cross-checkpoint dedupe story; and
- a read can always verify itself; a mismatching chunk is *quarantined*
  (renamed aside with ``.corrupt``) so the evidence survives and the
  caller gets a hard error instead of silently wrong weights.

A failed WRITE raises: a checkpoint chunk is the data, not an
optimization.
"""

import hashlib
import os

__all__ = ["ChunkStore", "CorruptChunkError", "digest_of", "SUFFIX"]

SUFFIX = ".chunk"


class CorruptChunkError(Exception):
    """A stored chunk no longer hashes to its name."""


def digest_of(data):
    return hashlib.sha256(data).hexdigest()


class ChunkStore:
    """sha256-hex -> bytes blobs under one flat directory."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, digest):
        return os.path.join(self.directory, digest + SUFFIX)

    def has(self, digest):
        return os.path.exists(self.path_for(digest))

    # -- write ---------------------------------------------------------------
    def put(self, data):
        """Persist one chunk; returns ``(digest, written_bytes)`` where
        ``written_bytes`` is 0 when the content was already stored (the
        dedupe hit).  ``data`` is any buffer (bytes/memoryview)."""
        data = memoryview(data)
        if data.ndim != 1 or data.format != "B":
            data = data.cast("B")   # byte view: len() must mean bytes
        digest = digest_of(data)
        path = self.path_for(digest)
        if os.path.exists(path):
            return digest, 0
        tmp = path + ".tmp.%d" % os.getpid()
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return digest, len(data)

    # -- read ----------------------------------------------------------------
    def get(self, digest):
        """The chunk bytes; verifies the content hash on every read and
        quarantines + raises on mismatch (bit rot, torn write that
        somehow reached its final name, operator error)."""
        path = self.path_for(digest)
        with open(path, "rb") as f:
            data = f.read()
        if digest_of(data) != digest:
            self.quarantine(digest)
            raise CorruptChunkError(
                "chunk %s... failed content verification (quarantined)"
                % digest[:16])
        return data

    def quarantine(self, digest):
        """Rename a bad chunk aside (``.corrupt``); idempotent."""
        path = self.path_for(digest)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            return False
        return True

    # -- accounting / gc -----------------------------------------------------
    def digests(self):
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return [n[:-len(SUFFIX)] for n in names if n.endswith(SUFFIX)]

    def total_bytes(self):
        total = 0
        for digest in self.digests():
            try:
                total += os.path.getsize(self.path_for(digest))
            except OSError:
                continue
        return total

    def gc(self, live_digests):
        """Drop every chunk not in ``live_digests`` (the union over all
        retained manifests).  Returns (chunks_removed, bytes_removed)."""
        live = set(live_digests)
        removed = freed = 0
        for digest in self.digests():
            if digest in live:
                continue
            path = self.path_for(digest)
            try:
                size = os.path.getsize(path)
                os.unlink(path)
            except OSError:
                continue
            removed += 1
            freed += size
        return removed, freed

    def fsync_dir(self):
        try:
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass
