"""Tiered KV-block store: device chains demote to host RAM, then disk.

The port's copy of ``veles_tpu/kvtier/store.py``, pure host code over
bytes.  The device pool (``serving/kvcache.py``) keeps refcount-0
chains resident in an LRU cache and reclaims them only under
allocation pressure.  This module is what happens *instead of dying*
when that eviction fires: the pool's ``on_evict`` hook hands the
block's device contents (serialized through the session wire,
``sessions.pack_block``) to a :class:`TieredKVStore`, which parks them
in a bounded host-RAM tier and cascades the host tier's own LRU
overflow into a disk tier backed by the checkpoint chunk store — the
same sha256 content-addressing end to end, so a disk chunk IS a
publishable KV block, and identical chains written by different
sessions, replica incarnations or packages land on the same bytes.

Lookups touch-promote: a host hit refreshes its LRU slot, a disk hit is
copied back into the host tier (the readmit that follows re-publishes
it on the device), so a hot chain climbs back up the hierarchy exactly
as far as it is used.  Each tier evicts independently by byte capacity;
the disk tier's key index is one atomically-written file per chain key,
so a SIGKILL at any point leaves a consistent tier that re-advertises
its chains after respawn.
"""

import os

from ..checkpoint.store import ChunkStore, CorruptChunkError

__all__ = ["HostTier", "DiskTier", "TieredKVStore",
           "DIR_ENV", "ADVERT_HEX", "advert_key"]

#: environment variable replicas read for their disk-tier directory
#: (set per replica id by the supervisor so the tier survives respawn)
DIR_ENV = "VELES_KVTIER_DIR"

#: chain keys are truncated to this many hex chars in advertisements,
#: routing headers and inspection dumps — 64 bits of sha256 is plenty
#: to make collisions a non-concern at fleet scale while keeping the
#: /readyz piggyback payload small
ADVERT_HEX = 16

_REF_SUFFIX = ".ref"


def advert_key(key):
    """Advertised (truncated-hex) form of a chain key."""
    if isinstance(key, (bytes, bytearray)):
        key = bytes(key).hex()
    return str(key)[:ADVERT_HEX]


class HostTier:
    """Bounded LRU of chain key -> serialized block bytes in host RAM."""

    name = "host"

    def __init__(self, capacity_bytes):
        self.capacity_bytes = int(capacity_bytes)
        self._blocks = {}        # key -> bytes; dict order IS the LRU
        self.used_bytes = 0

    def __len__(self):
        return len(self._blocks)

    def __contains__(self, key):
        return key in self._blocks

    def keys(self):
        return list(self._blocks)

    def get(self, key):
        data = self._blocks.get(key)
        if data is not None:                      # touch: newest = last
            del self._blocks[key]
            self._blocks[key] = data
        return data

    def put(self, key, data):
        """Insert (or refresh) a block; returns the ``(key, data)``
        pairs LRU-evicted to make room, for the caller to cascade into
        the next tier down."""
        old = self._blocks.pop(key, None)
        if old is not None:
            self.used_bytes -= len(old)
        self._blocks[key] = data
        self.used_bytes += len(data)
        spilled = []
        while self.used_bytes > self.capacity_bytes and len(self._blocks) > 1:
            k = next(iter(self._blocks))          # oldest
            v = self._blocks.pop(k)
            self.used_bytes -= len(v)
            spilled.append((k, v))
        if self.used_bytes > self.capacity_bytes:  # sole block too big
            k, v = self._blocks.popitem()
            self.used_bytes -= len(v)
            spilled.append((k, v))
        return spilled

    def discard(self, key):
        data = self._blocks.pop(key, None)
        if data is not None:
            self.used_bytes -= len(data)

    def check_integrity(self):
        bad = []
        actual = sum(len(v) for v in self._blocks.values())
        if actual != self.used_bytes:
            bad.append("host tier byte accounting %d != actual %d"
                       % (self.used_bytes, actual))
        if self.used_bytes > self.capacity_bytes and len(self._blocks) > 1:
            bad.append("host tier over capacity with evictable blocks")
        return bad


class DiskTier:
    """Chain key -> serialized block bytes, durable across SIGKILL.

    Layout under ``directory``::

        chunks/<sha256-of-bytes>.chunk   content (ChunkStore: atomic
                                         write, verified read, deduped)
        keys/<chain-key-hex>.ref         the chunk digest (atomic rename)

    Payload bytes are canonical (``sessions.pack_block``), so two chains
    with identical contents share one chunk no matter who wrote them.
    The ref file's mtime is the LRU clock: reads touch it, capacity
    eviction drops the stalest refs and then gc's unreferenced chunks.
    """

    name = "disk"

    def __init__(self, directory, capacity_bytes=0):
        self.directory = os.path.abspath(directory)
        self.capacity_bytes = int(capacity_bytes)   # 0 == unbounded
        self._chunks = ChunkStore(os.path.join(self.directory, "chunks"))
        self._keys_dir = os.path.join(self.directory, "keys")
        os.makedirs(self._keys_dir, exist_ok=True)

    def _ref_path(self, key_hex):
        return os.path.join(self._keys_dir, key_hex + _REF_SUFFIX)

    def keys(self):
        """Chain keys (hex) resident on disk — rebuilt by listing the
        index, which is how a respawned replica re-advertises chains
        its previous incarnation demoted."""
        try:
            names = os.listdir(self._keys_dir)
        except OSError:
            return []
        return [n[:-len(_REF_SUFFIX)] for n in names
                if n.endswith(_REF_SUFFIX)]

    def __contains__(self, key_hex):
        return os.path.exists(self._ref_path(key_hex))

    def __len__(self):
        return len(self.keys())

    @property
    def used_bytes(self):
        return self._chunks.total_bytes()

    def put(self, key_hex, data):
        digest, _ = self._chunks.put(data)
        path = self._ref_path(key_hex)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w", encoding="ascii") as f:
            f.write(digest)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        if self.capacity_bytes:
            self._enforce_capacity(keep=key_hex)

    def get(self, key_hex):
        path = self._ref_path(key_hex)
        try:
            with open(path, "r", encoding="ascii") as f:
                digest = f.read().strip()
        except OSError:
            return None
        try:
            data = self._chunks.get(digest)
        except (OSError, CorruptChunkError):
            # dangling or corrupt: drop the ref so the chain is simply
            # absent (it re-prefills) rather than poisonous
            self.discard(key_hex)
            return None
        try:
            os.utime(path, None)                  # LRU touch
        except OSError:
            pass
        return data

    def discard(self, key_hex):
        try:
            os.unlink(self._ref_path(key_hex))
        except OSError:
            pass

    def _enforce_capacity(self, keep=None):
        while self.used_bytes > self.capacity_bytes:
            refs = []
            for key_hex in self.keys():
                if key_hex == keep:
                    continue
                try:
                    refs.append((os.path.getmtime(self._ref_path(key_hex)),
                                 key_hex))
                except OSError:
                    continue
            if not refs:
                break
            refs.sort()
            self.discard(refs[0][1])
            self.gc()

    def gc(self):
        """Drop chunks no ref file points at; returns bytes freed."""
        live = set()
        for key_hex in self.keys():
            try:
                with open(self._ref_path(key_hex), encoding="ascii") as f:
                    live.add(f.read().strip())
            except OSError:
                continue
        _, freed = self._chunks.gc(live)
        return freed

    def check_integrity(self):
        bad = []
        have = set(self._chunks.digests())
        for key_hex in self.keys():
            try:
                with open(self._ref_path(key_hex), encoding="ascii") as f:
                    digest = f.read().strip()
            except OSError:
                continue
            if digest not in have:
                bad.append("disk ref %s.. -> missing chunk %s.."
                           % (key_hex[:12], digest[:12]))
        return bad


class TieredKVStore:
    """The demote/promote stack behind one decode scheduler's device pool.

    Keys are the pool's raw sha256 chain keys (bytes); internally and
    on disk they are hex.  ``observer`` is duck-typed (DecodeMetrics):
    ``record_tier_demotion(tier, nbytes)``,
    ``record_tier_promotion(tier, nbytes)`` and ``record_disk_readmit()``
    are called as blocks move — absent methods are simply skipped.
    ``version`` bumps on every mutation so advertisement snapshots can
    be rebuilt only when something actually changed.
    """

    def __init__(self, host_bytes=0, disk_dir=None, disk_bytes=0,
                 observer=None):
        if not host_bytes and not disk_dir:
            raise ValueError("tiered KV store needs a host-RAM byte "
                             "budget, a disk directory, or both")
        self.host = HostTier(host_bytes) if host_bytes else None
        self.disk = DiskTier(disk_dir, disk_bytes) if disk_dir else None
        self.observer = observer
        self.version = 0
        # cumulative counters (mirrors of what the observer sees, so
        # stats work without a metrics registry wired in)
        self.demotions = {"host": 0, "disk": 0}
        self.promotions = {"host": 0, "disk": 0}
        self.disk_readmits = 0

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _hex(key):
        return key.hex() if isinstance(key, (bytes, bytearray)) else str(key)

    def _note(self, method, *args):
        fn = getattr(self.observer, method, None)
        if fn is not None:
            fn(*args)

    # -- data path -----------------------------------------------------------
    def demote(self, key, data):
        """Park one serialized block evicted from the device.  Returns the
        tier it landed in ('host' or 'disk')."""
        self.version += 1
        key_hex = self._hex(key)
        if self.host is not None:
            spilled = self.host.put(key_hex, data)
            self.demotions["host"] += 1
            self._note("record_tier_demotion", "host", len(data))
            for k, v in spilled:
                if self.disk is not None:
                    self.disk.put(k, v)
                    self.demotions["disk"] += 1
                    self._note("record_tier_demotion", "disk", len(v))
            return "host"
        self.disk.put(key_hex, data)
        self.demotions["disk"] += 1
        self._note("record_tier_demotion", "disk", len(data))
        return "disk"

    def lookup(self, key):
        """``(tier_name, data)`` for a resident chain key, else None.

        Touch-promotes: a host hit refreshes its LRU slot; a disk hit
        is copied up into the host tier (the caller is about to readmit
        it onto the device, making it the hottest chain in the store)."""
        key_hex = self._hex(key)
        if self.host is not None:
            data = self.host.get(key_hex)
            if data is not None:
                self.promotions["host"] += 1
                self._note("record_tier_promotion", "host", len(data))
                return "host", data
        if self.disk is not None:
            data = self.disk.get(key_hex)
            if data is not None:
                self.version += 1
                self.disk_readmits += 1
                self.promotions["disk"] += 1
                self._note("record_tier_promotion", "disk", len(data))
                self._note("record_disk_readmit")
                if self.host is not None:
                    for k, v in self.host.put(key_hex, data):
                        if k != key_hex:          # don't spill it back out
                            self.disk.put(k, v)
                            self.demotions["disk"] += 1
                            self._note("record_tier_demotion", "disk",
                                       len(v))
                return "disk", data
        return None

    def tier_of(self, key):
        key_hex = self._hex(key)
        if self.host is not None and key_hex in self.host:
            return "host"
        if self.disk is not None and key_hex in self.disk:
            return "disk"
        return None

    # -- introspection -------------------------------------------------------
    def resident_keys(self):
        """{'host': [hex...], 'disk': [hex...]} of resident chains."""
        out = {}
        if self.host is not None:
            out["host"] = self.host.keys()
        if self.disk is not None:
            out["disk"] = self.disk.keys()
        return out

    def used_bytes(self):
        return {"host": self.host.used_bytes if self.host else 0,
                "disk": self.disk.used_bytes if self.disk else 0}

    def check_integrity(self):
        bad = []
        if self.host is not None:
            bad.extend(self.host.check_integrity())
        if self.disk is not None:
            bad.extend(self.disk.check_integrity())
        return bad

    def stats(self):
        used = self.used_bytes()
        out = {"demotions": dict(self.demotions),
               "promotions": dict(self.promotions),
               "disk_readmits": self.disk_readmits,
               "host_bytes": used["host"],
               "disk_bytes": used["disk"],
               "host_blocks": len(self.host) if self.host else 0,
               "disk_blocks": len(self.disk) if self.disk else 0}
        return out
