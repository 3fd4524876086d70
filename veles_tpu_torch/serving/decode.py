"""Token-level continuous batching over a paged KV cache.

The core of ``veles_tpu/serving/decode.py``'s ``DecodeScheduler``:
scheduling decisions happen **every token step**, not every request —

- one decode step with STATIC shapes (``max_batch`` rows x the
  ``[max_batch, max_blocks]`` page table) serves the whole lifetime of
  the server: admitting a sequence writes integers into the page table,
  retiring one returns its blocks to the free list;
- prompt prefill runs through a power-of-two length ladder, one
  sequence per prefill;
- K/V lives in fixed-size blocks of a preallocated device pool
  (:mod:`.kvcache` owns placement; the paged-attention kernel gathers
  through the page table), so memory is allocated per sequence LENGTH;
- backpressure is a bounded queue: beyond ``queue_limit`` outstanding
  requests :meth:`submit` raises :class:`SchedulerOverflow` and the
  server answers 429 + Retry-After.

PyTorch runs eagerly, so the JAX scheduler's ``jax.jit``, persistent
compile cache and AOT warmup have no counterpart here: the model's
functions run on the pools' device as they are called, and update the
pools in place.  ``stats()`` keeps the ``compiles`` and ``cache_hits``
keys for the JAX package's readers; both are always 0.  In place of the
AOT warmup, construction runs one all-padding decode step and one
prefill of every ladder bucket, writing only into the trash block: that
builds the CUDA kernels (``nvcc`` at first use) and the library handles
before the first request.

Not taken by this port yet: ``prefix_caching``, ``prefill_chunk_tokens``,
``spec_depth``, ``kvtier``, sessions and migration, ``checkpoint_kv``,
the flight recorder and autotuning.  The geometry defaults to the JAX
scheduler's tuner-off ``(max_batch, block_size) = (8, 8)``.

The single worker thread owns every mutable: the block pool, the page
table, the session map and the device pools.  ``submit`` only validates
and enqueues — the cross-thread surface is one Queue and one Future per
request.
"""

import collections
import queue
import threading
import time
from concurrent.futures import Future

import numpy

from ..device import resolve_device
from ..logger import events
from ..znicz.paged_attention import DEFAULT_BLOCK_SIZE
from .kvcache import KVBlockPool, required_blocks
from .metrics import DecodeMetrics
from .scheduler import (DeadlineExpired, SchedulerClosed,
                        SchedulerOverflow, bucket_sizes, deadline_expired)

__all__ = ["DecodeScheduler"]

_STOP = object()

#: the JAX scheduler's tuner-off batch (its block size is the paged
#: attention module's DEFAULT_BLOCK_SIZE)
DEFAULT_MAX_BATCH = 8


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "future", "enqueued",
                 "deadline")

    def __init__(self, prompt, max_new_tokens, deadline=None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.future = Future()
        self.enqueued = time.perf_counter()
        self.deadline = deadline    # absolute time.monotonic() or None


class _Session:
    """One admitted sequence: its row, blocks, and token state."""

    __slots__ = ("req", "row", "blocks", "length", "generated",
                 "first_token_s")

    def __init__(self, req, row, blocks):
        self.req = req
        self.row = row
        self.blocks = blocks
        self.length = 0          # tokens in the KV cache
        self.generated = []
        self.first_token_s = None

    @property
    def done(self):
        return len(self.generated) >= self.req.max_new_tokens


class DecodeScheduler:
    """Admit/retire sequences every step against one static-shape step.

    ``model`` is a decode adapter (e.g.
    :class:`veles_tpu_torch.znicz.samples.flagship.FlagshipDecodeModel`):
    ``make_pools(num_blocks, block_size)``, ``prefill_fn(block_size)``,
    ``decode_fn(block_size)``, ``vocab``, ``device``.

    Geometry: ``max_batch`` concurrent sequences, each at most
    ``max_prompt_len`` prompt + ``max_new_tokens`` generated tokens,
    stored in ``block_size``-token blocks.  ``num_blocks`` defaults to
    full occupancy (every row at max context) + the reserved trash
    block; size it smaller to oversubscribe memory, in which case
    admission also waits for free blocks.

    ``device`` (default: the card) must be the model's device.
    ``kv_dtype`` ("f32" or "int8") is passed through to the model's
    factories when it is not the default.
    """

    def __init__(self, model, *, max_batch=None, block_size=None,
                 max_prompt_len=32, max_new_tokens=32, num_blocks=None,
                 queue_limit=64, name="decode", kv_dtype=None,
                 device=None):
        self.name = name
        self.model = model
        self.device = resolve_device(device)
        model_device = getattr(model, "device", self.device)
        if model_device != self.device:
            raise ValueError("model %r lives on %s but the scheduler runs "
                             "on %s" % (name, model_device, self.device))
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.queue_limit = int(queue_limit)
        self.max_context = self.max_prompt_len + self.max_new_tokens
        self.kv_dtype = str(kv_dtype) if kv_dtype else "f32"
        if self.kv_dtype != "f32":
            supported = tuple(getattr(model, "kv_dtypes", ("f32",)))
            if self.kv_dtype not in supported:
                raise ValueError(
                    "model %r does not serve kv_dtype=%r (supported: %s)"
                    % (name, self.kv_dtype, ", ".join(supported)))
        # quantized pools widen the model-hook signatures ONLY when on
        self._model_kw = ({} if self.kv_dtype == "f32"
                          else {"kv_dtype": self.kv_dtype})
        self.max_batch = int(max_batch or DEFAULT_MAX_BATCH)
        self.block_size = int(block_size or DEFAULT_BLOCK_SIZE)
        self.max_blocks = required_blocks(self.max_context,
                                          self.block_size)
        if num_blocks is None:
            num_blocks = self.max_batch * self.max_blocks + 1
        self.metrics = DecodeMetrics(name)
        self.prefill_buckets = bucket_sizes(self.max_prompt_len)
        self._pool = KVBlockPool(num_blocks, self.block_size)
        if not self._pool.fits(self.max_context):
            raise ValueError(
                "num_blocks=%d cannot hold even one max-context "
                "sequence (%d tokens need %d blocks of %d)"
                % (num_blocks, self.max_context, self.max_blocks,
                   self.block_size))
        self._k_pools, self._v_pools = model.make_pools(
            num_blocks, self.block_size, **self._model_kw)
        # per-block byte footprint across every pool tensor (int8 pools
        # carry their f32 scale planes; all index blocks on axis 0)
        self._block_bytes = sum(
            t[0].numel() * t.element_size()
            for pools in (self._k_pools, self._v_pools) for pool in pools
            for t in (pool.values() if isinstance(pool, dict) else (pool,)))
        self.metrics.set_kv_dtype(self.kv_dtype)
        self.metrics.set_kv_bytes(0)
        self._decode = model.decode_fn(self.block_size, **self._model_kw)
        self._prefill_run = model.prefill_fn(self.block_size,
                                             **self._model_kw)
        # numpy mirrors of the step operands; the worker edits them on
        # admit/retire and ships them whole every step
        self._np_table = numpy.zeros((self.max_batch, self.max_blocks),
                                     numpy.int32)
        self._np_lengths = numpy.zeros(self.max_batch, numpy.int32)
        self._np_tokens = numpy.zeros(self.max_batch, numpy.int32)
        self._sessions = {}          # row -> _Session (decoding)
        self._pending = collections.deque()
        self._queue = queue.Queue()
        self._depth = 0              # queued + pending + active
        self._depth_lock = threading.Lock()
        self._closed = False
        self._abort = False
        self._warmed = False
        self.warmup()
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True,
            name="veles-decode-%s" % name)
        self._worker.start()

    def warmup(self):
        """Run the decode step with every row padding and a prefill of
        every ladder bucket over an all-trash block row (every write
        lands in the trash block): builds and loads the kernels and
        the library handles, so the first request pays for neither."""
        out = self._decode(self._k_pools, self._v_pools, self._np_table,
                           self._np_lengths, self._np_tokens)
        out[0].cpu()
        trash_row = numpy.zeros(self.max_blocks, numpy.int32)
        for bucket in self.prefill_buckets:
            first, _, _ = self._prefill_run(
                numpy.zeros(bucket, numpy.int32), bucket, self._k_pools,
                self._v_pools, trash_row)
            int(first)
        self._warmed = True

    # -- request side --------------------------------------------------------
    def validate(self, prompt, max_new_tokens):
        prompt = numpy.asarray(prompt)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError("prompt must be a non-empty 1-D token "
                             "sequence")
        if prompt.shape[0] > self.max_prompt_len:
            raise ValueError(
                "prompt of %d tokens exceeds max_prompt_len=%d"
                % (prompt.shape[0], self.max_prompt_len))
        if not numpy.issubdtype(prompt.dtype, numpy.integer):
            if not numpy.all(prompt == prompt.astype(numpy.int64)):
                raise ValueError("prompt tokens must be integers")
        prompt = prompt.astype(numpy.int32)
        vocab = getattr(self.model, "vocab", None)
        if vocab and (prompt.min() < 0 or prompt.max() >= vocab):
            raise ValueError("prompt tokens outside [0, %d)" % vocab)
        if not 1 <= int(max_new_tokens) <= self.max_new_tokens:
            raise ValueError(
                "max_new_tokens must be in [1, %d], got %r"
                % (self.max_new_tokens, max_new_tokens))
        return prompt

    def submit(self, prompt, max_new_tokens=None, deadline=None):
        """Enqueue one generate request -> Future of ``{"tokens": [...],
        "ttft_s": float, "prompt_tokens": n}``.  Raises
        SchedulerOverflow / SchedulerClosed / DeadlineExpired /
        ValueError."""
        if max_new_tokens is None:
            max_new_tokens = self.max_new_tokens
        prompt = self.validate(prompt, max_new_tokens)
        if self._closed:
            raise SchedulerClosed("decode scheduler %r is draining"
                                  % self.name)
        if deadline_expired(deadline):
            self.metrics.record_expired()
            raise DeadlineExpired(
                "deadline passed before admission to %r" % self.name)
        with self._depth_lock:
            if self._depth >= self.queue_limit:
                self.metrics.record_reject()
                raise SchedulerOverflow(
                    "decode queue full (%d outstanding, limit %d)"
                    % (self._depth, self.queue_limit))
            self._depth += 1
        req = _Request(prompt, max_new_tokens, deadline=deadline)
        self._queue.put(req)
        return req.future

    def generate(self, prompt, max_new_tokens=None, timeout=None,
                 deadline=None):
        """Blocking :meth:`submit`."""
        return self.submit(prompt, max_new_tokens,
                           deadline=deadline).result(timeout)

    # -- worker --------------------------------------------------------------
    def _worker_loop(self):
        stop = False
        while True:
            block = not self._sessions and not self._pending and not stop
            while True:
                try:
                    item = self._queue.get(block=block) if block \
                        else self._queue.get_nowait()
                except queue.Empty:
                    break
                block = False
                if item is _STOP:
                    stop = True
                    break
                self._pending.append(item)
            if self._abort:
                self._cancel_all()
                return
            self._admit()
            if self._sessions:
                self._step()
            elif stop and not self._pending:
                return

    def _fail(self, req, exc):
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)
        self._release()

    def _release(self):
        with self._depth_lock:
            self._depth -= 1

    def _cancel_all(self):
        exc = SchedulerClosed("scheduler shut down")
        while self._pending:
            self._fail(self._pending.popleft(), exc)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                self._fail(item, exc)
        for session in list(self._sessions.values()):
            self._retire(session, error=exc)

    # -- admission / prefill -------------------------------------------------
    def _set_occupancy(self):
        self.metrics.set_occupancy(
            len(self._sessions),
            self._pool.live_blocks / max(self._pool.capacity, 1))
        self.metrics.set_kv_bytes(self._pool.live_blocks
                                  * self._block_bytes)

    def _admit(self):
        # shed queue-expired work FIRST: a request whose deadline passed
        # while it waited must not spend a prefill
        if self._pending:
            now = time.monotonic()
            live = collections.deque()
            while self._pending:
                req = self._pending.popleft()
                if deadline_expired(req.deadline, now):
                    self.metrics.record_expired()
                    self._fail(req, DeadlineExpired(
                        "deadline passed before prefill"))
                else:
                    live.append(req)
            self._pending = live
        rows = [r for r in range(self.max_batch) if r not in self._sessions]
        while self._pending and rows:
            req = self._pending[0]
            blocks = self._pool.alloc(required_blocks(
                len(req.prompt) + req.max_new_tokens, self.block_size))
            if blocks is None:
                break               # head-of-line waits for retirements
            self._pending.popleft()
            row = rows.pop(0)
            session = _Session(req, row, blocks)
            try:
                self._prefill(session)
            except Exception as exc:  # noqa: BLE001 — fail THIS request
                self._pool.free(blocks)
                self._np_table[row] = 0
                self._fail(req, exc)
                rows.insert(0, row)
                continue
            self._sessions[row] = session
            self.metrics.record_admit(len(req.prompt))
            if session.done:        # max_new_tokens == 1: prefill was all
                self._retire(session)
                rows.insert(0, row)
        self._set_occupancy()

    def _prefill(self, session):
        req = session.req
        length = len(req.prompt)
        bucket = next(b for b in self.prefill_buckets if b >= length)
        tokens = numpy.zeros(bucket, numpy.int32)
        tokens[:length] = req.prompt
        block_row = numpy.zeros(self.max_blocks, numpy.int32)
        block_row[:len(session.blocks)] = session.blocks
        t0 = time.perf_counter()
        first, self._k_pools, self._v_pools = self._prefill_run(
            tokens, length, self._k_pools, self._v_pools, block_row)
        first = int(first)           # device -> host sync
        dt = time.perf_counter() - t0
        session.length = length
        session.generated.append(first)
        session.first_token_s = time.perf_counter() - req.enqueued
        self._np_table[session.row, :] = 0
        self._np_table[session.row, :len(session.blocks)] = session.blocks
        self._np_lengths[session.row] = length
        self._np_tokens[session.row] = first
        self.metrics.record_first_token(session.first_token_s)
        events.span("serving.prefill", dt, model=self.name,
                    bucket=int(bucket), prompt_tokens=int(length))

    # -- the per-token step --------------------------------------------------
    def _step(self):
        t0 = time.perf_counter()
        next_tokens, self._k_pools, self._v_pools = self._decode(
            self._k_pools, self._v_pools, self._np_table,
            self._np_lengths, self._np_tokens)
        next_tokens = next_tokens.cpu().numpy()      # device -> host sync
        dt = time.perf_counter() - t0
        active = list(self._sessions.values())
        for session in active:
            token = int(next_tokens[session.row])
            session.length += 1              # the fed token is now cached
            session.generated.append(token)
            self._np_lengths[session.row] = session.length
            self._np_tokens[session.row] = token
            if session.done:
                self._retire(session)
        self.metrics.record_step(len(active), self.max_batch, dt)

    def _retire(self, session, error=None):
        self._sessions.pop(session.row, None)
        self._pool.free(session.blocks)
        self._np_table[session.row, :] = 0
        self._np_lengths[session.row] = 0
        self._np_tokens[session.row] = 0
        future = session.req.future
        if error is not None:
            self.metrics.record_complete(len(session.generated), ok=False)
            if future.set_running_or_notify_cancel():
                future.set_exception(error)
        else:
            self.metrics.record_complete(len(session.generated))
            result = {
                "tokens": [int(t) for t in session.generated],
                "prompt_tokens": len(session.req.prompt),
                "ttft_s": round(session.first_token_s, 6),
            }
            if future.set_running_or_notify_cancel():
                future.set_result(result)
        self._release()

    # -- lifecycle / introspection -------------------------------------------
    def close(self, drain=True, timeout=30.0):
        """Stop accepting; with ``drain`` every already-submitted
        request finishes (admitted sequences run out, queued ones still
        get admitted as rows free), else cancel everything."""
        if self._closed:
            return
        self._closed = True
        if not drain:
            self._abort = True
        self._queue.put(_STOP)
        self._worker.join(timeout)
        # late racers that slipped past the closed flag
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                self._fail(item, SchedulerClosed("scheduler shut down"))

    @property
    def active_sequences(self):
        return len(self._sessions)

    @property
    def ready(self):
        """True once warmup ran and until close — the ``GET /readyz``
        signal."""
        return self._warmed and not self._closed

    def load(self):
        """Cheap backpressure snapshot for routers (int/float reads
        only — poll-safe)."""
        depth = self._depth
        return {"kind": "decode",
                "queue_depth": depth,
                "queue_limit": self.queue_limit,
                "utilization": round(depth / self.queue_limit, 4),
                "active_rows": len(self._sessions),
                "kv_occupancy": round(
                    self._pool.live_blocks /
                    max(self._pool.capacity, 1), 4)}

    def retry_after_s(self, cap=30):
        """Computed ``Retry-After`` for shed generate requests: gangs
        of queued sequences ahead x the tokens each must stream x the
        recent per-step wall time."""
        step_p50 = self.metrics.step_latency.summary().get("p50_ms")
        if not step_p50:
            return 1
        gangs_ahead = -(-self._depth // self.max_batch)  # ceil
        est = gangs_ahead * self.max_new_tokens * (step_p50 / 1e3)
        return max(1, min(int(cap), int(est + 0.999)))

    def stats(self):
        """Occupancy and configuration, shaped like the JAX scheduler's
        (``compiles``/``cache_hits`` are always 0: nothing compiles
        ahead of time in eager PyTorch)."""
        pool = self._pool.stats()
        return {
            "buckets": list(self.prefill_buckets),
            "compiles": 0,
            "cache_hits": 0,
            "queue_depth": self._depth,
            "queue_limit": self.queue_limit,
            "max_batch": self.max_batch,
            "active_sequences": len(self._sessions),
            "block_size": self.block_size,
            "num_blocks": pool["num_blocks"],
            "free_blocks": pool["free_blocks"],
            "kv_utilization": pool["utilization"],
            "kv_dtype": self.kv_dtype,
            "block_bytes": int(self._block_bytes),
            "kv_bytes_resident": int(self._pool.live_blocks
                                     * self._block_bytes),
            "max_prompt_len": self.max_prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "device": str(self.device),
            "ready": self.ready,
            "closed": self._closed,
        }
