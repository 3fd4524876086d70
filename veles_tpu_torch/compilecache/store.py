"""Content-addressed on-disk store of built kernel libraries.

The port's counterpart of ``veles_tpu/compilecache/store.py``, with its
durability: every write is ``*.tmp`` + flush + fsync + atomic
``os.rename``, so a kill at any point leaves either no entry or a
complete one, never a truncated file at its final name.  An entry the
caller cannot load is *quarantined*: renamed aside with a ``.corrupt``
suffix, so the next lookup is a clean miss (and a rebuild) and the
evidence survives for inspection.

The entries are the shared libraries ``nvcc`` builds (``<key>.so``,
loaded in place by ``ctypes``), where the JAX store kept serialized
executables.  Eviction is a size-budget LRU sweep: an entry's mtime is
touched on every hit, and when the store exceeds ``max_bytes`` the
oldest entries go first (a library another process has loaded stays
mapped there after its file is unlinked).  Concurrent processes are
safe by construction: writes are atomic renames, and eviction tolerates
entries vanishing underneath it.
"""

import logging
import os
import shutil

log = logging.getLogger("veles_tpu_torch.compilecache")

#: cache entry suffix; quarantined entries get SUFFIX + ".corrupt"
SUFFIX = ".so"


def _fsync_rename(tmp, path):
    with open(tmp, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


class ExecutableStore:
    """key (hex string) -> built library under one directory."""

    def __init__(self, directory, max_bytes=None):
        self.directory = os.path.abspath(directory)
        self.max_bytes = int(max_bytes) if max_bytes else None
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, key):
        return os.path.join(self.directory, key + SUFFIX)

    def tmp_path(self, key):
        """A private name in the store's directory to build into (then
        :meth:`put_file` it): the rename stays on one filesystem."""
        return self.path_for(key) + ".tmp.%d" % os.getpid()

    # -- read ----------------------------------------------------------------
    def lookup(self, key):
        """The entry's path, or None (miss).  A hit refreshes the
        entry's mtime — the LRU clock."""
        path = self.path_for(key)
        if not os.path.isfile(path):
            return None
        try:
            os.utime(path, None)
        except OSError:
            pass                    # concurrently evicted: still a hit
        return path

    # -- write ---------------------------------------------------------------
    def put_file(self, key, built):
        """Atomically move the file ``built`` into place under ``key``
        (copied first when it lies elsewhere); then sweep the size
        budget.  Returns the bytes stored, 0 when the disk refused."""
        tmp = self.tmp_path(key)
        try:
            if os.path.abspath(built) != tmp:
                shutil.copyfile(built, tmp)
            _fsync_rename(tmp, self.path_for(key))
        except OSError:
            self._unsaved(key, tmp)
            return 0
        self.evict(keep=key)
        return os.path.getsize(self.path_for(key))

    def _unsaved(self, key, tmp):
        # a full/read-only cache disk must never fail the caller: the
        # build already succeeded, the entry is just not saved
        log.warning("compile cache: could not persist entry %s under %s",
                    key[:16], self.directory, exc_info=True)
        try:
            os.unlink(tmp)
        except OSError:
            pass

    def quarantine(self, key, reason=""):
        """Rename a bad entry aside (``.corrupt``) so the next lookup is
        a clean miss; the caller rebuilds.  Idempotent."""
        path = self.path_for(key)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            return False
        log.debug("compile cache: quarantined entry %s (%s) -> "
                  "%s.corrupt", key[:16], reason or "unloadable",
                  os.path.basename(path))
        return True

    # -- accounting / eviction -----------------------------------------------
    def entries(self):
        """[(key, size, mtime)] for every live entry (no .corrupt/.tmp)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not name.endswith(SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue            # raced with eviction elsewhere
            out.append((name[:-len(SUFFIX)], st.st_size, st.st_mtime))
        return out

    def total_bytes(self):
        return sum(size for _, size, _ in self.entries())

    def evict(self, keep=None):
        """Drop oldest-used entries until the store fits ``max_bytes``
        (never ``keep``, the entry just written).  Returns the number
        of entries removed."""
        if not self.max_bytes:
            return 0
        entries = self.entries()
        total = sum(size for _, size, _ in entries)
        removed = 0
        for key, size, _ in sorted(entries, key=lambda e: e[2]):
            if total <= self.max_bytes:
                break
            if key == keep:
                continue
            try:
                os.unlink(self.path_for(key))
            except OSError:
                continue
            total -= size
            removed += 1
        if removed:
            log.info("compile cache: evicted %d entr%s (budget %d bytes)",
                     removed, "y" if removed == 1 else "ies",
                     self.max_bytes)
        return removed
