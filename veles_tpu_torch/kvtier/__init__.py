"""Fleet-global tiered KV cache (device -> host RAM -> disk): the port of
``veles_tpu/kvtier``.

Per replica, :class:`TieredKVStore` catches chain blocks the device pool
would otherwise evict and parks them down a memory hierarchy; fleet
wide, :class:`PrefixDirectory` lets the router
(:mod:`veles_tpu_torch.fleet.router`) steer each request to the replica
already holding the longest resident prefix of its prompt chain.
"""

from .store import (TieredKVStore, HostTier, DiskTier,
                    DIR_ENV, ADVERT_HEX, advert_key)
from .directory import PrefixDirectory, PREFIX_HEADER, prefix_key_header

__all__ = ["TieredKVStore", "HostTier", "DiskTier",
           "PrefixDirectory", "PREFIX_HEADER", "prefix_key_header",
           "DIR_ENV", "ADVERT_HEX", "advert_key"]
