"""Serving of the port: the classifier route (request-granularity
micro-batching into power-of-two buckets, behind ``POST /api/<name>``)
and decode serving (token-level continuous batching over a paged KV
cache, behind ``POST /api/<name>/generate``, with the tiered KV cache,
KV checkpoints and live session migration), one HTTP server and a
registry of hot-loadable models."""

from .decode import DecodeScheduler
from .kvcache import KVBlockPool, key_chain, required_blocks
from .metrics import DecodeMetrics, LatencyWindow, ServingMetrics
from .registry import DecodeServedModel, ModelRegistry, ServedModel
from .scheduler import (BucketScheduler, DeadlineExpired, OpaqueModel,
                        SchedulerClosed, SchedulerOverflow, TorchModel,
                        bucket_sizes, deadline_expired)
from .server import InferenceServer
from .sessions import pack_state, pack_states, unpack_state, unpack_states
from .toydecode import ToyDecodeModel

__all__ = ["DecodeScheduler", "KVBlockPool", "key_chain",
           "required_blocks", "DecodeMetrics", "LatencyWindow",
           "ServingMetrics", "DecodeServedModel", "ModelRegistry",
           "ServedModel", "BucketScheduler", "OpaqueModel", "TorchModel",
           "DeadlineExpired", "SchedulerClosed", "SchedulerOverflow",
           "bucket_sizes", "deadline_expired", "InferenceServer",
           "ToyDecodeModel", "pack_state", "pack_states", "unpack_state",
           "unpack_states"]
