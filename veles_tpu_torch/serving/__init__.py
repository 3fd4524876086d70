"""Decode serving of the port: token-level continuous batching over a
paged KV cache, behind ``POST /api/<name>/generate``."""

from .decode import DecodeScheduler
from .kvcache import KVBlockPool, key_chain, required_blocks
from .metrics import DecodeMetrics, LatencyWindow
from .registry import DecodeServedModel, ModelRegistry
from .scheduler import (DeadlineExpired, SchedulerClosed,
                        SchedulerOverflow, bucket_sizes, deadline_expired)
from .server import InferenceServer

__all__ = ["DecodeScheduler", "KVBlockPool", "key_chain",
           "required_blocks", "DecodeMetrics", "LatencyWindow",
           "DecodeServedModel", "ModelRegistry", "DeadlineExpired",
           "SchedulerClosed", "SchedulerOverflow", "bucket_sizes",
           "deadline_expired", "InferenceServer"]
