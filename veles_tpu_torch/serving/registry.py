"""Multi-model registry: one server, several named models.

The port of ``veles_tpu/serving/registry.py``: ``name ->``
:class:`ServedModel` (a :class:`~.scheduler.BucketScheduler` plus the
result-shaping transform, behind ``POST /api/<name>``) or
:class:`DecodeServedModel` (a :class:`~.decode.DecodeScheduler` behind
``POST /api/<name>/generate``), with the first (or an explicitly
flagged) entry as the default for bare ``POST /api``.  Re-adding a name
hot-swaps it: the new entry is warm before the swap, and the replaced
scheduler drains.  :meth:`ModelRegistry.load_package` raises until
exported packages are ported (ROADMAP queue A item 8).
"""

import threading
import time

from .decode import DecodeScheduler
from .metrics import ServingMetrics
from .scheduler import BucketScheduler, _unported

__all__ = ["ServedModel", "DecodeServedModel", "ModelRegistry"]

#: the scheduler defaults a registry forwards to DecodeScheduler
_DECODE_KWARGS = ("max_batch", "block_size", "max_prompt_len",
                  "max_new_tokens", "num_blocks", "queue_limit",
                  "prefix_caching", "prefill_chunk_tokens", "spec_depth",
                  "kvtier", "kv_dtype", "device", "cache", "manifest")
#: ... and to BucketScheduler (one server can host both kinds)
_BUCKET_KWARGS = ("max_batch", "queue_limit", "workers", "max_wait",
                  "warmup", "background_warmup", "sample_shape", "device",
                  "cache", "manifest", "buckets")


class ServedModel:
    """One classifier registry entry: scheduler + answer shaping.

    ``transform`` plays the reference's ``evaluation_transform`` role;
    without it a 2-D multi-column output is argmaxed (the classifier
    convention), anything else is returned verbatim.
    """

    def __init__(self, name, scheduler, transform=None, source=None,
                 version=None):
        self.name = name
        self.scheduler = scheduler
        self.transform = transform
        self.source = source
        self.version = version
        self.created = time.time()

    def infer(self, batch, timeout=None, deadline=None):
        """-> (result, output), the protocol tuple the handlers serve."""
        out = self.scheduler.infer(batch, timeout=timeout,
                                   deadline=deadline)
        if self.transform is not None:
            result = self.transform(out)
        elif out.ndim == 2 and out.shape[1] > 1:
            result = out.argmax(axis=1).tolist()
        else:
            result = out.tolist()
        return result, out

    def describe(self):
        stats = self.scheduler.stats()
        return {"source": self.source,
                "version": self.version,
                "ready": stats["ready"],
                "device": stats["device"],
                "sample_shape": list(self.scheduler.sample_shape)
                if self.scheduler.sample_shape is not None else None,
                "buckets": stats["buckets"],
                "queue_depth": stats["queue_depth"],
                "queue_limit": stats["queue_limit"]}


class DecodeServedModel:
    """A registry entry for the token-level decode path."""

    kind = "decode"

    def __init__(self, name, scheduler, source=None, version=None):
        self.name = name
        self.scheduler = scheduler
        self.source = source
        self.version = version
        self.created = time.time()

    def generate(self, prompt, max_new_tokens=None, timeout=None,
                 session_id=None, deadline=None):
        """-> the result dict (tokens, ttft_s, prompt_tokens,
        session_id)."""
        return self.scheduler.generate(prompt, max_new_tokens,
                                       timeout=timeout,
                                       session_id=session_id,
                                       deadline=deadline)

    def describe(self):
        stats = self.scheduler.stats()
        return {"source": self.source,
                "version": self.version,
                "ready": stats["ready"],
                "kind": "decode",
                "device": stats["device"],
                "max_prompt_len": stats["max_prompt_len"],
                "max_new_tokens": stats["max_new_tokens"],
                "max_batch": stats["max_batch"],
                "block_size": stats["block_size"],
                "num_blocks": stats["num_blocks"],
                "kv_dtype": stats["kv_dtype"],
                "prefix_caching": stats["prefix_caching"],
                "prefill_chunk_tokens": stats["prefill_chunk_tokens"],
                "spec_depth": stats.get("spec_depth"),
                "active_sequences": stats["active_sequences"],
                "queue_depth": stats["queue_depth"],
                "queue_limit": stats["queue_limit"]}


def _is_decode_model(model):
    """A decode adapter exposes the prefill/decode closure pair."""
    return (hasattr(model, "decode_fn") and hasattr(model, "prefill_fn")
            and hasattr(model, "make_pools"))


class ModelRegistry:
    """Thread-safe name -> :class:`ServedModel` /
    :class:`DecodeServedModel` map."""

    def __init__(self, **scheduler_defaults):
        unknown = set(scheduler_defaults) - set(_DECODE_KWARGS) \
            - set(_BUCKET_KWARGS)
        if unknown:
            raise TypeError("unknown scheduler options: %s"
                            % ", ".join(sorted(unknown)))
        self._models = {}
        self._order = []
        self._default = None
        self._lock = threading.Lock()
        self._scheduler_defaults = scheduler_defaults

    def _defaults(self, allowed):
        return {k: v for k, v in self._scheduler_defaults.items()
                if k in allowed}

    def add(self, name, model, transform=None, default=False,
            metrics=None, version=None, **scheduler_kwargs):
        """Register a model (a workflow with ``forwards``, a
        :class:`~.scheduler.TorchModel` / ``OpaqueModel`` or a callable)
        under ``name``; warms its bucket ladder now so the first request
        is already warm.  A decode adapter (the ``prefill_fn`` /
        ``decode_fn`` / ``make_pools`` trio) routes to
        :meth:`add_decode` instead.

        Re-adding an existing ``name`` is the hot-load path: the new
        entry (optionally tagged ``version``) warms fully before the
        swap, the swap itself is one dict write under the lock, and the
        replaced scheduler drains, so in-flight requests against the
        old version complete normally."""
        if _is_decode_model(model):
            return self.add_decode(name, model, default=default,
                                   version=version, **scheduler_kwargs)
        kwargs = self._defaults(_BUCKET_KWARGS)
        kwargs.update(scheduler_kwargs)
        scheduler = BucketScheduler(
            model, name=name,
            metrics=metrics or ServingMetrics(name), **kwargs)
        entry = ServedModel(name, scheduler, transform=transform,
                            source=type(model).__name__, version=version)
        return self._install(name, entry, default)

    def add_decode(self, name, model, default=False, version=None,
                   **decode_kwargs):
        """Register a decode adapter under ``name`` — warms its decode
        step now, serves ``POST /api/<name>/generate``.  The model's own
        ``decode_defaults`` (e.g. a ToyDecodeModel's spec geometry)
        override the registry-wide defaults; explicit kwargs override
        both."""
        kwargs = self._defaults(_DECODE_KWARGS)
        kwargs.update(getattr(model, "decode_defaults", None) or {})
        kwargs.update(decode_kwargs)
        scheduler = DecodeScheduler(model, name=name, **kwargs)
        entry = DecodeServedModel(name, scheduler,
                                  source=type(model).__name__,
                                  version=version)
        return self._install(name, entry, default)

    def _install(self, name, entry, default):
        with self._lock:
            prior = self._models.get(name)
            self._models[name] = entry
            if name not in self._order:
                self._order.append(name)
            if default or self._default is None:
                self._default = name
        if prior is not None:     # hot swap: drain the replaced scheduler
            prior.scheduler.close(drain=True)
        return entry

    def load_package(self, name, path, **kwargs):
        """Hot-load an exported package zip under ``name``: not ported
        yet (ROADMAP queue A item 8)."""
        raise _unported("serving an exported package (%r)" % (path,),
                        "item 8, export")

    def remove(self, name, drain=True):
        with self._lock:
            entry = self._models.pop(name, None)
            if name in self._order:
                self._order.remove(name)
            if self._default == name:
                self._default = self._order[0] if self._order else None
        if entry is not None:
            entry.scheduler.close(drain=drain)
        return entry is not None

    def get(self, name):
        with self._lock:
            return self._models.get(name)

    def resolve(self, name=None):
        """``None``/empty -> the default entry; unknown -> None."""
        with self._lock:
            if not name:
                name = self._default
            return self._models.get(name) if name else None

    def names(self):
        with self._lock:
            return list(self._order)

    @property
    def default_name(self):
        return self._default

    def ready(self):
        """True when at least one model is registered and every
        registered scheduler is warm — what ``GET /readyz`` gates on."""
        with self._lock:
            entries = list(self._models.values())
        return bool(entries) and all(e.scheduler.ready for e in entries)

    def load_snapshot(self):
        """Per-model backpressure signals (cheap, poll-safe): the fleet
        router's least-loaded dispatch input."""
        with self._lock:
            entries = list(self._models.items())
        return {name: entry.scheduler.load() for name, entry in entries}

    def describe(self):
        with self._lock:
            entries = list(self._models.items())
        return {name: entry.describe() for name, entry in entries}

    def metrics_snapshot(self):
        with self._lock:
            entries = list(self._models.items())
        return {name: {**entry.scheduler.metrics.snapshot(),
                       **entry.scheduler.stats()}
                for name, entry in entries}

    def close(self, drain=True):
        with self._lock:
            entries = list(self._models.values())
        for entry in entries:
            entry.scheduler.close(drain=drain)
