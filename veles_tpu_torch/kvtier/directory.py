"""Fleet-wide prefix directory: which replica holds which chain.

The port's copy of ``veles_tpu/kvtier/directory.py``.

Replicas advertise their resident chain keys — truncated hex, grouped
by tier — inside the ``load`` payload the router already polls off
``/readyz`` (no new control traffic).  The router feeds each probe into
a :class:`PrefixDirectory` and consults it per request: a client that
sends its prompt's chain keys (the ``X-Veles-Prefix-Keys`` header,
computed with the same rolling sha256 as the pools use) is routed to
the replica holding the **longest consecutive leading run** of those
keys, falling back to least-loaded when nobody holds anything or the
holder is not currently eligible.  Stale entries are harmless by
construction: affinity only ever *biases* the pick among eligible
replicas, and a miss on arrival degrades to a normal prefill.
"""

import threading

__all__ = ["PrefixDirectory", "PREFIX_HEADER", "prefix_key_header"]

#: request header carrying the prompt's chain keys (comma-separated
#: truncated hex, leading blocks first) for cache-aware routing
PREFIX_HEADER = "X-Veles-Prefix-Keys"

_TIER_RANK = {"hbm": 0, "host": 1, "disk": 2}


def prefix_key_header(tokens, block_size, max_keys=16):
    """Header value for a prompt: its chain keys in advertised form.

    Client-side helper (benches, tests): mirrors what the serving pool
    computes at admit, so the router can match the prompt against
    advertised residency without ever parsing the request body."""
    from ..serving.kvcache import key_chain     # lazy: avoids import cycle
    from .store import advert_key
    keys = key_chain(tokens, block_size)[:max_keys]
    return ",".join(advert_key(k) for k in keys)


class PrefixDirectory:
    """Thread-safe map of advertised chain keys per replica."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_replica = {}    # rid -> {key_hex: tier}

    def update(self, rid, tiers):
        """Replace ``rid``'s advertisement.  ``tiers`` maps tier name
        ('hbm' | 'host' | 'disk') to a list of truncated-hex keys; a
        key in several tiers records its fastest one."""
        keymap = {}
        for tier in ("hbm", "host", "disk"):
            for key in tiers.get(tier) or ():
                key = str(key)
                old = keymap.get(key)
                if old is None or _TIER_RANK[tier] < _TIER_RANK[old]:
                    keymap[key] = tier
        with self._lock:
            self._by_replica[str(rid)] = keymap

    def drop(self, rid):
        with self._lock:
            self._by_replica.pop(str(rid), None)

    def replicas(self):
        with self._lock:
            return list(self._by_replica)

    def best_replica(self, keys, candidates=None):
        """``(rid, matched)`` — the replica holding the longest
        consecutive leading run of ``keys`` (any tier), or (None, 0).
        ``candidates`` restricts the search to currently-eligible
        replica ids; ties break on the smaller rid for determinism."""
        keys = [str(k) for k in keys]
        best_rid, best_n = None, 0
        with self._lock:
            items = sorted(self._by_replica.items())
        for rid, keymap in items:
            if candidates is not None and rid not in candidates:
                continue
            n = 0
            for key in keys:
                if key not in keymap:
                    break
                n += 1
            if n > best_n:
                best_rid, best_n = rid, n
        return best_rid, best_n

    def residency(self, key):
        """{rid: tier} for one advertised key across the fleet."""
        key = str(key)
        out = {}
        with self._lock:
            for rid, keymap in self._by_replica.items():
                tier = keymap.get(key)
                if tier is not None:
                    out[rid] = tier
        return out

    def snapshot(self, max_keys=None):
        """Full directory for the ``/fleet/kv`` route: per replica, the
        advertised keys grouped back by tier (optionally capped)."""
        out = {}
        with self._lock:
            items = list(self._by_replica.items())
        for rid, keymap in items:
            tiers = {"hbm": [], "host": [], "disk": []}
            for key, tier in keymap.items():
                tiers[tier].append(key)
            for tier in tiers:
                tiers[tier].sort()
                if max_keys is not None:
                    tiers[tier] = tiers[tier][:max_keys]
            tiers["total"] = len(keymap)
            out[rid] = tiers
        return out
