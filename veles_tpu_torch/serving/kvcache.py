"""Host-side block accounting for the paged KV cache.

The port of ``veles_tpu/serving/kvcache.py``, host-only code: the
free-list pool of the core decode scheduler, its content-addressed half
(``prefix_caching=True``: shared, refcounted and cached blocks keyed by
:func:`key_chain`), the speculative-decoding rollback tallies, the
tiered store's ``on_evict`` demotion hook and the ``state_dict`` /
``load_state`` pair of ``checkpoint_kv``.

The device side is dumb on purpose — two preallocated pool tensors per
layer ([num_blocks, block_size, heads, head_dim]) that the decode step
scatters into and the ragged paged-attention kernel gathers from
(znicz/paged_attention.py).  ALL placement policy lives here, on the
host, as plain integers: a free-list of physical block ids and one
page-table row per live sequence.  Admitting a sequence is a list pop,
retiring is a list push — no device traffic, which is the entire point
of paging (vLLM's PagedAttention block tables).

Physical block 0 is reserved as the **trash block**: padding rows of
the page table point at it, masked-out prefill positions scatter into
it, and it is never handed to a live sequence — so a stray write can
only ever land somewhere no real sequence reads.
"""

import hashlib
from collections import OrderedDict

from ..znicz.paged_attention import required_blocks

__all__ = ["KVBlockPool", "required_blocks", "key_chain"]


def key_chain(tokens, block_size, kv_dtype="f32"):
    """Rolling content keys of every FULL block of ``tokens``.

    ``keys[i] = sha256(keys[i-1] + tokens_of_block_i)`` — a block's key
    commits to the entire prefix ending at that block, so two sequences
    share ``keys[i]`` iff their first ``(i+1) * block_size`` tokens are
    identical.  Trailing partial blocks get no key (they are still
    being written).

    ``kv_dtype != "f32"`` mixes the precision into the chain seed:
    quantization is deterministic (same tokens in, same int8 bytes +
    scales out), so tagging the seed is equivalent to hashing the
    quantized bytes themselves — equal tags + equal tokens imply equal
    block content — while guaranteeing an int8 chain can never dedupe
    against an f32 chain whose device bytes differ."""
    bs = int(block_size)
    toks = [int(t) for t in tokens]
    keys = []
    parent = (b"veles-kv" if kv_dtype == "f32"
              else b"veles-kv/" + kv_dtype.encode())
    for i in range(len(toks) // bs):
        h = hashlib.sha256(parent)
        h.update(b",".join(b"%d" % t for t in toks[i * bs:(i + 1) * bs]))
        parent = h.digest()
        keys.append(parent)
    return keys


class KVBlockPool:
    """Free-list allocator over ``num_blocks`` physical blocks.

    With ``prefix_caching`` the pool is also content-addressed: a full
    block published under its chain key is shared (refcounted) while
    sequences read it, and parks in an LRU cache at refcount 0, its
    content resident and addressable until an allocation needs the
    room.  Every block is in exactly one domain: free, private (one
    sequence), shared or cached.  With the flag off only the first two
    exist and the pool behaves as the plain free list.

    Not thread-safe by itself: the decode scheduler's single worker
    thread owns it.
    """

    TRASH = 0           # reserved physical block, never allocated

    def __init__(self, num_blocks, block_size, prefix_caching=False):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_caching = bool(prefix_caching)
        if self.num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        # LIFO: recently-freed blocks are reused first (warm in cache)
        self._free = list(range(self.num_blocks - 1, self.TRASH, -1))
        self._live = set()
        # prefix-caching domains (empty forever when the flag is off)
        self._refs = {}                  # block -> refcount (> 0)
        self._cached = OrderedDict()     # block -> key, LRU order
        self._key_of = {}                # block -> key (shared + cached)
        self._by_key = {}                # key -> block
        # cumulative counters (never reset; surfaced via stats())
        self.prefix_hits = 0             # admits that reused >= 1 block
        self.dedup_blocks = 0            # blocks attached already-resident
        self.published_blocks = 0
        self.evicted_blocks = 0
        # speculative-decoding rollback accounting: positions the verify
        # pass wrote but the accept step discarded (their blocks stay
        # private and masked: never published, never readable)
        self.draft_rollbacks = 0         # iterations that rolled back
        self.rolled_back_tokens = 0      # positions written, then dropped
        # demotion hook: called as on_evict(block, key) just before a
        # cached chain block is reclaimed, while its device contents are
        # still intact; the tiered KV store (veles_tpu_torch/kvtier)
        # captures the block here and parks it in host RAM or on disk
        # instead of letting the content die with the eviction
        self.on_evict = None

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def live_blocks(self):
        """Blocks owned by live sequences (private + shared)."""
        return len(self._live) + len(self._refs)

    @property
    def cached_blocks(self):
        return len(self._cached)

    @property
    def shared_blocks(self):
        return len(self._refs)

    @property
    def capacity(self):
        """Allocatable blocks (total minus the reserved trash block)."""
        return self.num_blocks - 1

    def fits(self, tokens):
        """Whether a sequence of ``tokens`` total tokens can ever fit."""
        return required_blocks(tokens, self.block_size) <= self.capacity

    def alloc(self, n):
        """Pop ``n`` blocks, or None (allocation is all-or-nothing: a
        partial grab would deadlock two half-admitted sequences).

        Cached (refcount-0) blocks back the free list: when it runs
        short they are evicted oldest first, so resident prefixes cost
        nothing until the pool is actually full."""
        n = int(n)
        if n < 1:
            raise ValueError("alloc of %d blocks" % n)
        if n > len(self._free) + len(self._cached):
            return None
        while len(self._free) < n:
            self._evict_one()
        blocks = [self._free.pop() for _ in range(n)]
        self._live.update(blocks)
        return blocks

    def _evict_one(self):
        block, key = self._cached.popitem(last=False)   # LRU
        if self.on_evict is not None:
            self.on_evict(block, key)
        del self._key_of[block]
        del self._by_key[key]
        self._free.append(block)
        self.evicted_blocks += 1

    def free(self, blocks):
        """Return a retired sequence's PRIVATE blocks to the free list.
        Shared blocks go through :meth:`release`: freeing a block that
        another sequence still reads is what this guard refuses."""
        for b in blocks:
            b = int(b)
            if b == self.TRASH:
                raise ValueError("block 0 is reserved; it was never "
                                 "allocated")
            if b in self._refs:
                raise ValueError("block %d freed while referenced "
                                 "(refcount %d); use release()"
                                 % (b, self._refs[b]))
            if b in self._cached:
                raise ValueError("block %d is cached prefix content; "
                                 "only eviction reclaims it" % b)
            if b not in self._live:
                raise ValueError("double free of block %d" % b)
            self._live.discard(b)
            self._free.append(b)

    # -- content addressing --------------------------------------------------
    def _need_prefix(self):
        if not self.prefix_caching:
            raise RuntimeError("pool was built with prefix_caching=False")

    def acquire_prefix(self, keys):
        """Attach to the longest resident chain prefix of ``keys``.

        Returns the matched blocks (possibly none), each with its
        refcount incremented; cached blocks are revived to shared.  The
        caller owns one reference per returned block and must
        :meth:`release` them all at retire."""
        self._need_prefix()
        blocks = []
        for key in keys:
            b = self._by_key.get(key)
            if b is None:
                break
            if b in self._cached:
                del self._cached[b]
                self._refs[b] = 1
            else:
                self._refs[b] += 1
            blocks.append(b)
        if blocks:
            self.prefix_hits += 1
            self.dedup_blocks += len(blocks)
        return blocks

    def publish(self, block, key):
        """Move a private block into the shared domain under ``key``.

        Returns False (and leaves the block private) if the key is
        already resident: the caller keeps its own copy, and the first
        writer wins, so a chain is never rebound under its readers."""
        self._need_prefix()
        block = int(block)
        if block not in self._live:
            raise ValueError("publish of non-private block %d" % block)
        if key in self._by_key:
            return False
        self._live.discard(block)
        self._refs[block] = 1
        self._key_of[block] = key
        self._by_key[key] = block
        self.published_blocks += 1
        return True

    def release(self, blocks):
        """Drop one reference per block; at refcount 0 the block parks
        in the LRU cache (its content stays resident and addressable)."""
        self._need_prefix()
        for b in blocks:
            b = int(b)
            count = self._refs.get(b)
            if not count:
                raise ValueError("release of unshared block %d" % b)
            if count > 1:
                self._refs[b] = count - 1
            else:
                del self._refs[b]
                self._cached[b] = self._key_of[b]   # newest = last

    def note_draft_rollback(self, tokens):
        """Record one speculative iteration discarding ``tokens``
        written-but-rejected positions.  Accounting only: the rollback
        itself is the scheduler not advancing the length over them (the
        kernel's length masking keeps them invisible until overwritten),
        so no block changes domain here, which is why rejected content
        can never be published or shared."""
        if tokens > 0:
            self.draft_rollbacks += 1
            self.rolled_back_tokens += int(tokens)

    def is_shared(self, block):
        return int(block) in self._refs

    def refcount(self, block):
        return self._refs.get(int(block), 0)

    def key_of(self, block):
        """Chain key a shared or cached block is published under, or
        None."""
        return self._key_of.get(int(block))

    def resident_keys(self):
        """Chain keys currently addressable on the device (shared +
        cached)."""
        return list(self._by_key)

    # -- persistence / introspection -----------------------------------------
    def state_dict(self):
        """Picklable index state for ``checkpoint_kv`` (keys as hex; the
        reference's layout, so either package restores the other's)."""
        return {"free": [int(b) for b in self._free],
                "live": sorted(int(b) for b in self._live),
                "refs": {str(b): int(c) for b, c in self._refs.items()},
                "cached": [[int(b), k.hex()]
                           for b, k in self._cached.items()],
                "keys": {str(b): k.hex()
                         for b, k in self._key_of.items()}}

    def load_state(self, state):
        self._free = [int(b) for b in state["free"]]
        self._live = set(int(b) for b in state["live"])
        self._refs = {int(b): int(c)
                      for b, c in state.get("refs", {}).items()}
        self._cached = OrderedDict(
            (int(b), bytes.fromhex(k))
            for b, k in state.get("cached", []))
        self._key_of = {int(b): bytes.fromhex(k)
                        for b, k in state.get("keys", {}).items()}
        self._by_key = {k: b for b, k in self._key_of.items()}
        violations = self.check_integrity()
        if violations:
            raise ValueError("corrupt pool state: %s"
                             % "; ".join(violations))

    def check_integrity(self):
        """List of invariant violations (empty == healthy pool)."""
        bad = []
        if len(set(self._free)) != len(self._free):
            bad.append("duplicate block(s) on the free list")
        domains = [set(self._free), self._live,
                   set(self._refs), set(self._cached)]
        total = sum(len(d) for d in domains)
        if total != self.capacity:
            bad.append("free+live+shared+cached=%d != capacity=%d"
                       % (total, self.capacity))
        seen = set()
        for d in domains:
            if seen & d:
                bad.append("block(s) %s in two domains"
                           % sorted(seen & d))
            seen |= d
        if self.TRASH in seen:
            bad.append("trash block allocated")
        keyed = set(self._refs) | set(self._cached)
        if set(self._key_of) != keyed:
            bad.append("key index out of sync with shared+cached")
        if len(self._by_key) != len(self._key_of):
            bad.append("duplicate keys in block index")
        if any(c < 1 for c in self._refs.values()):
            bad.append("non-positive refcount")
        return bad

    def dump(self):
        """Introspection snapshot (``GET /api/<name>/kv``)."""
        alloc_total = self.published_blocks + self.dedup_blocks
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "prefix_caching": self.prefix_caching,
            "free_blocks": self.free_blocks,
            "private_blocks": len(self._live),
            "shared": sorted(
                ({"block": b, "key": self._key_of[b].hex()[:12],
                  "refcount": c} for b, c in self._refs.items()),
                key=lambda e: e["block"]),
            "cached": [{"block": b, "key": k.hex()[:12]}
                       for b, k in self._cached.items()],
            "prefix_hits": self.prefix_hits,
            "dedup_blocks": self.dedup_blocks,
            "published_blocks": self.published_blocks,
            "evicted_blocks": self.evicted_blocks,
            "draft_rollbacks": self.draft_rollbacks,
            "rolled_back_tokens": self.rolled_back_tokens,
            "dedup_ratio": round(self.dedup_blocks / alloc_total, 4)
                           if alloc_total else 0.0,
            "integrity": self.check_integrity(),
        }

    def stats(self):
        out = {"num_blocks": self.num_blocks,
               "block_size": self.block_size,
               "free_blocks": self.free_blocks,
               "live_blocks": self.live_blocks,
               "utilization": round(
                   self.live_blocks / max(self.capacity, 1), 4)}
        if self.prefix_caching:
            out.update(shared_blocks=self.shared_blocks,
                       cached_blocks=self.cached_blocks,
                       prefix_hits=self.prefix_hits,
                       dedup_blocks=self.dedup_blocks,
                       published_blocks=self.published_blocks,
                       evicted_blocks=self.evicted_blocks)
        return out
