"""Host-side block accounting for the paged KV cache.

The port of ``veles_tpu/serving/kvcache.py``, host-only code: the
free-list pool the core decode scheduler uses, and :func:`key_chain`.
The pool's content-addressed half (``prefix_caching``: shared,
refcounted and cached blocks) comes with the scheduler's
``prefix_caching`` option, which this port does not take yet.

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

    Not thread-safe by itself — the decode scheduler's single worker
    thread owns it.
    """

    TRASH = 0           # reserved physical block — never allocated

    def __init__(self, num_blocks, block_size):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        if self.num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        # LIFO: recently-freed blocks are reused first (warm in cache)
        self._free = list(range(self.num_blocks - 1, self.TRASH, -1))
        self._live = set()

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def live_blocks(self):
        """Blocks owned by live sequences."""
        return len(self._live)

    @property
    def capacity(self):
        """Allocatable blocks (total minus the reserved trash block)."""
        return self.num_blocks - 1

    def fits(self, tokens):
        """Whether a sequence of ``tokens`` total tokens can ever fit."""
        return required_blocks(tokens, self.block_size) <= self.capacity

    def alloc(self, n):
        """Pop ``n`` blocks, or None (allocation is all-or-nothing —
        a partial grab would deadlock two half-admitted sequences)."""
        n = int(n)
        if n < 1:
            raise ValueError("alloc of %d blocks" % n)
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._live.update(blocks)
        return blocks

    def free(self, blocks):
        """Return a retired sequence's blocks to the free list."""
        for b in blocks:
            b = int(b)
            if b == self.TRASH:
                raise ValueError("block 0 is reserved; it was never "
                                 "allocated")
            if b not in self._live:
                raise ValueError("double free of block %d" % b)
            self._live.discard(b)
            self._free.append(b)

    def check_integrity(self):
        """List of invariant violations (empty == healthy pool)."""
        bad = []
        free = set(self._free)
        if len(free) != len(self._free):
            bad.append("duplicate block(s) on the free list")
        if len(free) + len(self._live) != self.capacity:
            bad.append("free+live=%d != capacity=%d"
                       % (len(free) + len(self._live), self.capacity))
        if free & self._live:
            bad.append("block(s) %s both free and live"
                       % sorted(free & self._live))
        if self.TRASH in free | self._live:
            bad.append("trash block allocated")
        return bad

    def stats(self):
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free_blocks": self.free_blocks,
                "live_blocks": self.live_blocks,
                "utilization": round(
                    self.live_blocks / max(self.capacity, 1), 4)}
