"""Token-level continuous batching over a paged KV cache.

The port of ``veles_tpu/serving/decode.py``'s ``DecodeScheduler``:
scheduling decisions happen **every token step**, not every request —

- one decode step with STATIC shapes (``max_batch`` rows x the
  ``[max_batch, max_blocks]`` page table) serves the whole lifetime of
  the server: admitting a sequence writes integers into the page table,
  retiring one returns its blocks to the free list;
- prompt prefill runs through a power-of-two length ladder, one
  sequence per prefill; with ``prefill_chunk_tokens`` set it runs
  instead through one fixed-size chunk function, one chunk per worker
  iteration, interleaved with decode steps, so a long prompt no longer
  stalls the batch for a whole prefill;
- with ``prefix_caching`` on, the block pool is content-addressed over
  token-prefix hashes (:func:`.kvcache.key_chain`): admission attaches
  to already-resident blocks by reference and prefills only the rest of
  the prompt, chunk by chunk, so shared system prompts and multi-turn
  resubmissions skip most of their prefill;
- with ``spec_depth`` set, decode runs **speculatively**: the model's
  drafter (``draft_fn``) proposes k tokens a row, and the target checks
  all k+1 positions in one batched pass (``verify_fn``, the multi-token
  entry of the same ragged paged-attention kernel).  Greedy acceptance
  (the longest draft prefix the target agrees with, plus the target's
  own next token) emits exactly the plain decode's tokens; K/V written
  for rejected positions is rolled back by NOT advancing the length
  over it, so it is never published or read;
- K/V lives in fixed-size blocks of a preallocated device pool
  (:mod:`.kvcache` owns placement; the paged-attention kernel gathers
  through the page table), so memory is allocated per sequence LENGTH;
- backpressure is a bounded queue: beyond ``queue_limit`` outstanding
  requests :meth:`submit` raises :class:`SchedulerOverflow` and the
  server answers 429 + Retry-After.

Every option defaults OFF, which is the core scheduler exactly: the
ladder prefill, the plain free-list pool and the per-token step.

PyTorch runs eagerly, so the JAX scheduler's ``jax.jit``, persistent
compile cache and AOT warmup have no counterpart here: the model's
functions run on the pools' device as they are called, and update the
pools in place.  ``stats()`` keeps the ``compiles`` and ``cache_hits``
keys for the JAX package's readers; both are always 0.  In place of the
AOT warmup, construction runs every step function once on padding
(writes land only in the trash block): that builds the CUDA kernels
(``nvcc`` at first use) and the library handles before the first
request.

Not taken by this port yet, and refused with ``NotImplementedError``
naming the ROADMAP item (:data:`REFUSED_OPTIONS`): ``"auto"`` for
``prefill_chunk_tokens``, ``spec_depth`` or ``kv_dtype`` (autotuning)
and ``kvtier``.  Sessions and migration, ``checkpoint_kv`` and the
flight recorder are not ported either.  The geometry defaults to the
JAX scheduler's tuner-off ``(max_batch, block_size) = (8, 8)``.

The single worker thread owns every mutable: the block pool, the page
table, the session map and the device pools.  ``submit`` only validates
and enqueues — the cross-thread surface is one Queue and one Future per
request (and per :meth:`kv_dump`).
"""

import collections
import queue
import threading
import time
import uuid
from concurrent.futures import Future

import numpy
import torch

from ..device import resolve_device
from ..logger import events
from ..znicz.paged_attention import DEFAULT_BLOCK_SIZE
from .kvcache import KVBlockPool, key_chain, required_blocks
from .metrics import DecodeMetrics
from .scheduler import (DeadlineExpired, SchedulerClosed,
                        SchedulerOverflow, bucket_sizes, deadline_expired)

__all__ = ["DecodeScheduler", "DEFAULT_PREFILL_CHUNK",
           "DEFAULT_SPEC_DEPTH", "REFUSED_OPTIONS"]

_STOP = object()

#: the JAX scheduler's tuner-off batch (its block size is the paged
#: attention module's DEFAULT_BLOCK_SIZE)
DEFAULT_MAX_BATCH = 8

#: the JAX package's hand-picked prefill chunk and speculation depth
#: (its autotune sites' baseline candidates)
DEFAULT_PREFILL_CHUNK = 32
DEFAULT_SPEC_DEPTH = 2

#: scheduler options of the JAX package the port does not honour yet:
#: option -> (the refused values, or None for any set value; the
#: ROADMAP queue A item that ports it)
REFUSED_OPTIONS = {
    "prefill_chunk_tokens": (("auto",), "item 3, autotune"),
    "spec_depth": (("auto",), "item 3, autotune"),
    "kv_dtype": (("auto",), "item 3, autotune"),
    "kvtier": (None, "item 1, its third bullet (kvtier)"),
}


def _refuse_unported(options):
    for name, value in options.items():
        refused, item = REFUSED_OPTIONS[name]
        if (value in refused) if refused else value:
            raise NotImplementedError(
                "DecodeScheduler(%s=%r) is not ported yet (ROADMAP queue "
                "A %s)" % (name, value, item))


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "future", "enqueued",
                 "deadline", "sid")

    def __init__(self, prompt, max_new_tokens, deadline=None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.future = Future()
        self.enqueued = time.perf_counter()
        self.deadline = deadline    # absolute time.monotonic() or None
        self.sid = uuid.uuid4().hex[:16]    # names it in kv_dump


class _Job:
    """A callable the WORKER runs between token steps: the only safe
    place to read the pools, the table and the sessions."""

    __slots__ = ("fn", "future")

    def __init__(self, fn):
        self.fn = fn
        self.future = Future()


class _Session:
    """One admitted sequence: its row, blocks, and token state."""

    __slots__ = ("req", "row", "blocks", "length", "next_input",
                 "generated", "first_token_s", "shared", "prefilled")

    def __init__(self, req, row, blocks):
        self.req = req
        self.row = row
        self.blocks = blocks
        self.length = 0          # tokens in the KV cache
        self.next_input = 0      # last emitted token (next step's input)
        self.generated = []
        self.first_token_s = None
        self.shared = 0          # leading blocks attached already-resident
        self.prefilled = 0       # prompt tokens prefilled so far (chunked)

    @property
    def done(self):
        return len(self.generated) >= self.req.max_new_tokens


class DecodeScheduler:
    """Admit/retire sequences every step against one static-shape step.

    ``model`` is a decode adapter (e.g.
    :class:`veles_tpu_torch.znicz.samples.flagship.FlagshipDecodeModel`
    or :class:`.toydecode.ToyDecodeModel`): ``make_pools(num_blocks,
    block_size)``, ``prefill_fn(block_size)``, ``decode_fn(block_size)``,
    ``vocab``, ``device``; ``prefill_chunk_fn`` for chunked prefill and
    ``draft_fn``/``verify_fn`` for speculation.

    Geometry: ``max_batch`` concurrent sequences, each at most
    ``max_prompt_len`` prompt + ``max_new_tokens`` generated tokens,
    stored in ``block_size``-token blocks.  ``num_blocks`` defaults to
    full occupancy (every row at max context) + the reserved trash
    block; size it smaller to oversubscribe memory, in which case
    admission also waits for free blocks.

    Options, each off by default: ``prefill_chunk_tokens`` (an int, the
    chunk size), ``prefix_caching`` (needs ``prefill_chunk_tokens``) and
    ``spec_depth`` (an int, the draft tokens an iteration).

    ``device`` (default: the card) must be the model's device.
    ``kv_dtype`` ("f32" or "int8") is passed through to the model's
    factories when it is not the default.
    """

    def __init__(self, model, *, max_batch=None, block_size=None,
                 max_prompt_len=32, max_new_tokens=32, num_blocks=None,
                 queue_limit=64, name="decode", prefix_caching=False,
                 prefill_chunk_tokens=None, spec_depth=None, kvtier=None,
                 kv_dtype=None, device=None):
        _refuse_unported({"prefill_chunk_tokens": prefill_chunk_tokens,
                          "spec_depth": spec_depth, "kv_dtype": kv_dtype,
                          "kvtier": kvtier})
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
        self.prefix_caching = bool(prefix_caching)
        # 0 or None: the ladder prefill, as in the JAX scheduler
        self.chunk_tokens = (int(prefill_chunk_tokens)
                             if prefill_chunk_tokens else None)
        if self.chunk_tokens is not None and self.chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        if self.prefix_caching and not self.chunk_tokens:
            raise ValueError(
                "prefix_caching=True requires prefill_chunk_tokens: the "
                "chunked path is what admits partially-resident prompts "
                "(suffix-only prefill)")
        if self.chunk_tokens and not hasattr(model, "prefill_chunk_fn"):
            raise ValueError(
                "model %r has no prefill_chunk_fn; chunked prefill is "
                "unavailable for it" % name)
        self.spec_depth = None if spec_depth is None else int(spec_depth)
        if self.spec_depth is not None and self.spec_depth < 1:
            raise ValueError("spec_depth must be >= 1 (or None to "
                             "disable speculative decoding)")
        if self.spec_depth and not (hasattr(model, "draft_fn")
                                    and hasattr(model, "verify_fn")):
            raise ValueError(
                "model %r has no draft_fn/verify_fn; speculative decoding "
                "is unavailable for it" % name)
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
        self._pool = KVBlockPool(num_blocks, self.block_size,
                                 prefix_caching=self.prefix_caching)
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
            t[0].numel() * t.element_size() for t in self._pool_tensors())
        self.metrics.set_kv_dtype(self.kv_dtype)
        self.metrics.set_kv_bytes(0)
        kw = self._model_kw
        self._decode = model.decode_fn(self.block_size, **kw)
        # chunked mode runs every prompt through the chunk function, so
        # it builds no ladder prefill
        self._prefill_run = self._chunk_run = None
        if self.chunk_tokens:
            self._chunk_run = model.prefill_chunk_fn(self.block_size, **kw)
        else:
            self._prefill_run = model.prefill_fn(self.block_size, **kw)
        self._draft = self._verify = None
        if self.spec_depth:
            self._draft = model.draft_fn(self.block_size, self.spec_depth,
                                         **kw)
            self._verify = model.verify_fn(self.block_size,
                                           self.spec_depth, **kw)
        # lifetime speculation counters (stats()/kv_dump beside the
        # registry-backed metrics series)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_rejected = 0
        # numpy mirrors of the step operands; the worker edits them on
        # admit/retire and ships them whole every step
        self._np_table = numpy.zeros((self.max_batch, self.max_blocks),
                                     numpy.int32)
        self._np_lengths = numpy.zeros(self.max_batch, numpy.int32)
        self._np_tokens = numpy.zeros(self.max_batch, numpy.int32)
        self._sessions = {}          # row -> _Session (decoding)
        self._chunking = collections.deque()   # _Session mid-prefill
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

    def _pool_tensors(self):
        for pool in self._k_pools + self._v_pools:
            yield from (pool.values() if isinstance(pool, dict)
                        else (pool,))

    def warmup(self):
        """Run each step function once on padding over all-trash block
        rows (every write lands in the trash block): the decode step,
        then every ladder bucket's prefill, or the chunk function in
        chunked mode, and the drafter and verify pass with speculation.
        That builds and loads the kernels and the library handles, so
        the first request pays for neither."""
        out = self._decode(self._k_pools, self._v_pools, self._np_table,
                           self._np_lengths, self._np_tokens)
        out[0].cpu()
        if self.spec_depth:
            self._draft(self._k_pools, self._v_pools, self._np_table,
                        self._np_lengths, self._np_tokens).cpu()
            fed = numpy.zeros((self.max_batch, self.spec_depth + 1),
                              numpy.int32)
            self._verify(self._k_pools, self._v_pools, self._np_table,
                         self._np_lengths, fed)[0].cpu()
        trash_row = numpy.zeros(self.max_blocks, numpy.int32)
        if self.chunk_tokens:
            int(self._chunk_run(
                numpy.zeros(self.chunk_tokens, numpy.int32), 0,
                self.chunk_tokens, self._k_pools, self._v_pools,
                trash_row)[0])
        else:
            for bucket in self.prefill_buckets:
                int(self._prefill_run(
                    numpy.zeros(bucket, numpy.int32), bucket,
                    self._k_pools, self._v_pools, trash_row)[0])
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
            block = (not self._sessions and not self._chunking
                     and not self._pending and not stop)
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
                if isinstance(item, _Job):
                    # step boundary: nothing in flight, the worker owns
                    # every mutable, so the job runs inline
                    try:
                        item.future.set_result(item.fn())
                    except Exception as exc:  # noqa: BLE001 — to caller
                        item.future.set_exception(exc)
                    continue
                self._pending.append(item)
            if self._abort:
                self._cancel_all()
                return
            self._admit()
            # the interleave: one prefill chunk, then one decode step, so
            # a long prompt never stalls the live rows for more than one
            # chunk's worth of device time
            if self._chunking:
                self._chunk_step()
            if self._sessions:
                if self.spec_depth:
                    self._spec_step()
                else:
                    self._step()
            elif stop and not self._pending and not self._chunking:
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
            if isinstance(item, _Job):
                item.future.set_exception(exc)
            elif item is not _STOP:
                self._fail(item, exc)
        while self._chunking:
            session = self._chunking.popleft()
            self._release_session_blocks(session, publish=False)
            self._fail(session.req, exc)
        for session in list(self._sessions.values()):
            self._retire(session, error=exc)

    # -- admission / prefill -------------------------------------------------
    def _set_occupancy(self):
        self.metrics.set_occupancy(
            len(self._sessions),
            self._pool.live_blocks / max(self._pool.capacity, 1))
        # cached (refcount-0, content kept for prefix reuse) blocks still
        # hold device bytes: resident means "not free"
        self.metrics.set_kv_bytes(
            (self._pool.live_blocks + self._pool.cached_blocks)
            * self._block_bytes)

    def _free_rows(self):
        busy = set(self._sessions)
        busy.update(s.row for s in self._chunking)
        return [r for r in range(self.max_batch) if r not in busy]

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
        rows = self._free_rows()
        while self._pending and rows:
            req = self._pending[0]
            need = required_blocks(len(req.prompt) + req.max_new_tokens,
                                   self.block_size)
            if self.chunk_tokens:
                if not self._admit_chunked(req, need, rows):
                    break           # head-of-line waits for retirements
                continue
            blocks = self._pool.alloc(need)
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
        self.metrics.set_chunk_queue(len(self._chunking))
        self._set_occupancy()

    def _admit_chunked(self, req, need, rows):
        """Admit the head-of-line request onto the chunked path: attach
        the resident prefix (by reference, suffix-only prefill), allocate
        the rest as private blocks, queue the session for chunk steps.
        Returns False when the pool cannot serve it yet."""
        length = len(req.prompt)
        matched = []
        if self.prefix_caching:
            # never match the whole prompt: the first output token needs
            # the hidden state at position length-1, which only a
            # prefill of >= 1 suffix token computes
            keys = key_chain(req.prompt, self.block_size,
                             kv_dtype=self.kv_dtype)[
                                 :(length - 1) // self.block_size]
            matched = self._pool.acquire_prefix(keys)
        private = self._pool.alloc(need - len(matched))
        if private is None:
            if matched:
                self._pool.release(matched)
            return False
        self._pending.popleft()
        row = rows.pop(0)
        session = _Session(req, row, list(matched) + private)
        session.shared = len(matched)
        session.prefilled = len(matched) * self.block_size
        # the page-table row stays zeroed (trash) until the final chunk
        # lands: decode steps treat the row as padding, and a stray
        # write never touches a shared block
        self._chunking.append(session)
        self.metrics.record_admit(length,
                                  prefilled=length - session.prefilled)
        self.metrics.record_prefix(len(matched))
        return True

    def _block_row(self, session):
        row = numpy.zeros(self.max_blocks, numpy.int32)
        row[:len(session.blocks)] = session.blocks
        return row

    def _start_decoding(self, session, first, **ttft):
        """The prompt is cached and ``first`` emitted: the session
        becomes a decode row."""
        req = session.req
        session.length = len(req.prompt)
        session.next_input = first
        session.generated.append(first)
        session.first_token_s = time.perf_counter() - req.enqueued
        self._np_table[session.row, :] = self._block_row(session)
        self._np_lengths[session.row] = session.length
        self._np_tokens[session.row] = first
        self.metrics.record_first_token(session.first_token_s, **ttft)

    def _prefill(self, session):
        req = session.req
        length = len(req.prompt)
        bucket = next(b for b in self.prefill_buckets if b >= length)
        tokens = numpy.zeros(bucket, numpy.int32)
        tokens[:length] = req.prompt
        t0 = time.perf_counter()
        first, self._k_pools, self._v_pools = self._prefill_run(
            tokens, length, self._k_pools, self._v_pools,
            self._block_row(session))
        first = int(first)           # device -> host sync
        # the stand-in's pinned prefill time, per prompt token
        delay = getattr(self.model, "prefill_host_delay", 0)
        if delay:
            time.sleep(delay * length)
        dt = time.perf_counter() - t0
        self._start_decoding(session, first)
        events.span("serving.prefill", dt, model=self.name,
                    bucket=int(bucket), prompt_tokens=int(length))

    def _chunk_step(self):
        """Advance the oldest prefilling session by ONE chunk; on the
        final chunk the session becomes a decode row."""
        session = self._chunking.popleft()
        req = session.req
        length = len(req.prompt)
        start = session.prefilled
        end = min(start + self.chunk_tokens, length)
        tokens = numpy.zeros(self.chunk_tokens, numpy.int32)
        tokens[:end - start] = req.prompt[start:end]
        t0 = time.perf_counter()
        try:
            first, self._k_pools, self._v_pools = self._chunk_run(
                tokens, start, length, self._k_pools, self._v_pools,
                self._block_row(session))
            if end >= length:
                first = int(first)   # device -> host sync, last chunk only
        except Exception as exc:  # noqa: BLE001 — fail THIS request
            self._release_session_blocks(session, publish=False)
            self._fail(req, exc)
            return
        # a chunk pays the stand-in's delay for its OWN tokens only (a
        # resident prefix costs nothing)
        delay = getattr(self.model, "prefill_host_delay", 0)
        if delay:
            time.sleep(delay * (end - start))
        dt = time.perf_counter() - t0
        session.prefilled = end
        self.metrics.record_chunk()
        events.span("serving.prefill_chunk", dt, model=self.name,
                    start=int(start), prompt_tokens=int(length))
        if end < length:
            self._chunking.append(session)
            return
        self._start_decoding(
            session, first,
            resident=session.shared * self.block_size / length)
        self._sessions[session.row] = session
        self._publish_prompt(session)
        if session.done:            # max_new_tokens == 1
            self._retire(session)
        self.metrics.set_chunk_queue(len(self._chunking))

    # -- prefix publication / block release ----------------------------------
    def _publish(self, session, tokens):
        """Publish the session's full blocks of ``tokens`` under their
        chain keys (first writer wins: on a key collision the block stays
        a private copy and dies with the session)."""
        keys = key_chain(tokens, self.block_size, kv_dtype=self.kv_dtype)
        for block, key in zip(session.blocks, keys):
            if not self._pool.is_shared(block):
                self._pool.publish(block, key)

    def _publish_prompt(self, session):
        """Make the session's full PROMPT blocks addressable the moment
        its prefill completes: sequences arriving while it decodes
        already match them."""
        if self.prefix_caching:
            self._publish(session, session.req.prompt)

    def _publish_history(self, session):
        """At a successful retire, publish the full blocks of the whole
        history (prompt + generated, the last token never cached): a
        multi-turn follow-up that resubmits the conversation attaches
        to them."""
        self._publish(session, list(session.req.prompt)
                      + session.generated[:-1])

    def _release_session_blocks(self, session, publish):
        """Give a leaving session's blocks back: shared ones drop a
        reference (their content stays resident), private ones return
        to the free list, optionally after publishing the history so the
        content stays addressable."""
        if not self.prefix_caching:
            self._pool.free(session.blocks)
            return
        if publish:
            self._publish_history(session)
        shared = [b for b in session.blocks if self._pool.is_shared(b)]
        private = [b for b in session.blocks
                   if not self._pool.is_shared(b)]
        if shared:
            self._pool.release(shared)
        if private:
            self._pool.free(private)

    # -- the per-token step --------------------------------------------------
    def _step(self):
        t0 = time.perf_counter()
        next_tokens, self._k_pools, self._v_pools = self._decode(
            self._k_pools, self._v_pools, self._np_table,
            self._np_lengths, self._np_tokens)
        next_tokens = next_tokens.cpu().numpy()      # device -> host sync
        # the stand-in's pinned per-step time
        delay = getattr(self.model, "step_host_delay", 0)
        if delay:
            time.sleep(delay)
        dt = time.perf_counter() - t0
        active = list(self._sessions.values())
        for session in active:
            token = int(next_tokens[session.row])
            session.length += 1              # the fed token is now cached
            session.generated.append(token)
            session.next_input = token
            self._np_lengths[session.row] = session.length
            self._np_tokens[session.row] = token
            if session.done:
                self._retire(session)
        self.metrics.record_step(len(active), self.max_batch, dt)

    def _spec_step(self):
        """One speculative iteration: draft k tokens a row, verify all
        k+1 fed positions in one batched pass, accept greedily.

        The verify output at position ``i`` is the target's next token
        given the history plus the fed tokens ``0 .. i``, so the longest
        prefix where ``draft[i] == out[i]`` consists of tokens plain
        decode would have emitted, and ``out[m]`` (the correction) is
        the target's own token after them: every emitted token is the
        plain decode's; speculation only changes how many arrive an
        iteration.

        Rollback: the verify pass wrote K/V at ``length .. length+k``,
        but ``length`` advances only over the emitted tokens; the
        positions past it stay masked until a later iteration overwrites
        them, so history publication never covers rejected content.
        """
        k = self.spec_depth
        t0 = time.perf_counter()
        drafts = self._draft(self._k_pools, self._v_pools, self._np_table,
                             self._np_lengths, self._np_tokens)
        drafts = drafts.cpu().numpy()                # [B, k]
        ddelay = getattr(self.model, "draft_host_delay", 0)
        if ddelay:
            time.sleep(ddelay)
        ddt = time.perf_counter() - t0
        fed = numpy.concatenate([self._np_tokens[:, None], drafts],
                                axis=1).astype(numpy.int32)  # [B, k+1]
        t1 = time.perf_counter()
        out, self._k_pools, self._v_pools = self._verify(
            self._k_pools, self._v_pools, self._np_table,
            self._np_lengths, fed)
        out = out.cpu().numpy()                      # device -> host sync
        delay = getattr(self.model, "step_host_delay", 0)
        if delay:
            time.sleep(delay)
        vdt = time.perf_counter() - t1
        active = list(self._sessions.values())
        accepted_total = emitted_total = 0
        for session in active:
            row = session.row
            accepted = 0
            while (accepted < k and
                   int(drafts[row, accepted]) == int(out[row, accepted])):
                accepted += 1
            remaining = (session.req.max_new_tokens
                         - len(session.generated))
            emit = [int(t) for t in out[row, :accepted + 1][:remaining]]
            # roll back every written-but-unemitted position (rejected
            # drafts and an accepted tail past the token budget)
            self._pool.note_draft_rollback(k + 1 - len(emit))
            session.length += len(emit)      # the fed tokens now cached
            session.generated.extend(emit)
            session.next_input = emit[-1]
            self._np_lengths[row] = session.length
            self._np_tokens[row] = session.next_input
            accepted_total += accepted
            emitted_total += len(emit)
            if session.done:
                self._retire(session)
        rejected_total = len(active) * k - accepted_total
        self._spec_drafted += len(active) * k
        self._spec_accepted += accepted_total
        self._spec_rejected += rejected_total
        self.metrics.record_draft(len(active), k, ddt)
        self.metrics.record_verify(len(active), k + 1, accepted_total,
                                   rejected_total, vdt)
        # record_step counts one token a row, as plain decode; the extra
        # accepted ones come on top
        self.metrics.record_step(len(active), self.max_batch, vdt)
        extra = emitted_total - len(active)
        if extra > 0:
            self.metrics.record_extra_tokens(extra)

    def _retire(self, session, error=None):
        self._sessions.pop(session.row, None)
        self._release_session_blocks(session, publish=error is None)
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

    # -- pool introspection --------------------------------------------------
    def _run_job(self, fn, timeout=120.0):
        """Ship ``fn`` to the worker thread and wait for its result (the
        worker runs jobs only at step boundaries)."""
        if self._closed:
            raise SchedulerClosed("decode scheduler %r is draining"
                                  % self.name)
        job = _Job(fn)
        self._queue.put(job)
        return job.future.result(timeout)

    def kv_dump(self):
        """Live-pool introspection (``GET /api/<name>/kv``): resident
        prefixes, refcounts, dedupe ratio, the speculation tallies and an
        integrity verdict, captured on the worker at a step boundary so
        the snapshot is self-consistent."""
        return self._run_job(self._kv_dump)

    def _kv_dump(self):
        dump = self._pool.dump()
        sessions = [{
            "session_id": session.req.sid,
            "row": int(session.row),
            "blocks": [int(b) for b in session.blocks],
            "shared_blocks": int(session.shared),
            "length": int(session.length),
            "prefilled": int(session.prefilled),
        } for session in (list(self._sessions.values())
                          + list(self._chunking))]
        problems = list(dump["integrity"])
        allocated = self._pool._live | set(self._pool._refs)
        for entry in sessions:
            missing = [b for b in entry["blocks"] if b not in allocated]
            if missing:
                problems.append("session %s references unallocated "
                                "block(s) %s"
                                % (entry["session_id"], missing))
        dump["kv_dtype"] = self.kv_dtype
        if self.kv_dtype != "f32":
            dump["quant"] = self._quant_stats()
        dump.update(model=self.name,
                    prefill_chunk_tokens=self.chunk_tokens,
                    active_sequences=len(self._sessions),
                    chunking_sessions=len(self._chunking),
                    sessions=sessions,
                    integrity=problems)
        if self.spec_depth:
            drafted = self._spec_drafted
            dump["speculation"] = {
                "spec_depth": self.spec_depth,
                "draft_tokens": drafted,
                "accepted_tokens": self._spec_accepted,
                "rejected_tokens": self._spec_rejected,
                "acceptance_rate":
                    round(self._spec_accepted / drafted, 4)
                    if drafted else None,
                "draft_rollbacks": self._pool.draft_rollbacks,
                "rolled_back_tokens": self._pool.rolled_back_tokens,
            }
        return dump

    def _quant_stats(self):
        """The ``quant`` block of :meth:`kv_dump`: the per-block byte
        footprint and statistics of the pools' f32 scale planes.  A zero
        scale marks a never-written block slice, so the statistics cover
        the nonzero entries and report the zero fraction."""
        out = {"kv_dtype": self.kv_dtype,
               "bytes_per_block": int(self._block_bytes)}
        scales = [pool["s"].reshape(-1).cpu()
                  for pool in self._k_pools + self._v_pools
                  if isinstance(pool, dict)]
        if scales:
            flat = torch.cat(scales)
            nz = flat[flat > 0]
            if nz.numel():
                out["scales"] = {
                    "min": float(nz.min()),
                    "max": float(nz.max()),
                    "mean": float(nz.mean()),
                    "zero_fraction": round(
                        1.0 - nz.numel() / flat.numel(), 4),
                }
        return out

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
            if isinstance(item, _Job):
                item.future.set_exception(
                    SchedulerClosed("scheduler shut down"))
            elif item is not _STOP:
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
                "chunking_sessions": len(self._chunking),
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
        ahead of time in eager PyTorch).  The prefix and speculation
        keys appear only with their option on."""
        pool = self._pool.stats()
        out = {
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
            "kv_bytes_resident": int(
                (self._pool.live_blocks + self._pool.cached_blocks)
                * self._block_bytes),
            "max_prompt_len": self.max_prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "prefix_caching": self.prefix_caching,
            "prefill_chunk_tokens": self.chunk_tokens,
            "chunking_sessions": len(self._chunking),
            "device": str(self.device),
            "ready": self.ready,
            "closed": self._closed,
        }
        if self.spec_depth:
            drafted = self._spec_drafted
            out.update(
                spec_depth=self.spec_depth,
                draft_tokens=drafted,
                accepted_tokens=self._spec_accepted,
                rejected_tokens=self._spec_rejected,
                acceptance_rate=round(self._spec_accepted / drafted, 4)
                if drafted else None,
                rolled_back_tokens=self._pool.rolled_back_tokens)
        if self.prefix_caching:
            out.update((key, pool[key]) for key in (
                "prefix_hits", "dedup_blocks", "published_blocks",
                "evicted_blocks", "shared_blocks", "cached_blocks"))
        return out
