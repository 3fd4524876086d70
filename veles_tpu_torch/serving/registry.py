"""Multi-model registry: one server, several named decode models.

The decode half of ``veles_tpu/serving/registry.py``: ``name ->
DecodeServedModel`` (a :class:`DecodeScheduler` behind ``POST
/api/<name>/generate``), with the first — or an explicitly flagged —
entry as the default.  Re-adding a name hot-swaps it: the new entry is
warm before the swap and the replaced scheduler drains.  The
request-granularity ``ServedModel`` / ``BucketScheduler`` path is not
ported yet.
"""

import threading

from .decode import DecodeScheduler

__all__ = ["DecodeServedModel", "ModelRegistry"]

#: the scheduler defaults a registry forwards to DecodeScheduler
_DECODE_KWARGS = ("max_batch", "block_size", "max_prompt_len",
                  "max_new_tokens", "num_blocks", "queue_limit",
                  "prefix_caching", "prefill_chunk_tokens", "spec_depth",
                  "kvtier", "kv_dtype", "device")


class DecodeServedModel:
    """A registry entry for the token-level decode path."""

    kind = "decode"

    def __init__(self, name, scheduler, source=None):
        self.name = name
        self.scheduler = scheduler
        self.source = source

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
    """Thread-safe name -> :class:`DecodeServedModel` map."""

    def __init__(self, **scheduler_defaults):
        unknown = set(scheduler_defaults) - set(_DECODE_KWARGS)
        if unknown:
            raise TypeError("unknown scheduler options: %s"
                            % ", ".join(sorted(unknown)))
        self._models = {}
        self._order = []
        self._default = None
        self._lock = threading.Lock()
        self._scheduler_defaults = scheduler_defaults

    def add(self, name, model, default=False, **scheduler_kwargs):
        """Register a model under ``name``.  Only decode adapters (the
        ``prefill_fn``/``decode_fn``/``make_pools`` trio) are served by
        the port so far; they route to :meth:`add_decode`."""
        if not _is_decode_model(model):
            raise TypeError(
                "%r is not a decode model; the port serves decode "
                "adapters only (prefill_fn, decode_fn, make_pools)"
                % type(model).__name__)
        return self.add_decode(name, model, default=default,
                               **scheduler_kwargs)

    def add_decode(self, name, model, default=False, **decode_kwargs):
        """Register a decode adapter under ``name`` — warms its decode
        step now, serves ``POST /api/<name>/generate``.  The model's own
        ``decode_defaults`` (e.g. a ToyDecodeModel's spec geometry)
        override the registry-wide defaults; explicit kwargs override
        both."""
        kwargs = dict(self._scheduler_defaults)
        kwargs.update(getattr(model, "decode_defaults", None) or {})
        kwargs.update(decode_kwargs)
        scheduler = DecodeScheduler(model, name=name, **kwargs)
        entry = DecodeServedModel(name, scheduler,
                                  source=type(model).__name__)
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
        """Per-model backpressure signals (cheap, poll-safe)."""
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
