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
- with ``kvtier`` set (it needs ``prefix_caching``), a cached chain the
  pool evicts is demoted instead of dropped: gathered to the host,
  serialized (:func:`.sessions.pack_block`) and parked in host RAM,
  cascading to disk (:mod:`veles_tpu_torch.kvtier`); an admit whose
  prefix is no longer on the device readmits it from there into a fresh
  block, with no re-prefill;
- :meth:`checkpoint_kv` / :meth:`restore_kv` save and resume the whole
  decode state (pools, page table, pool accounting, live sessions) at a
  step boundary, through :mod:`veles_tpu_torch.checkpoint`;
- live sessions migrate between schedulers mid-generation
  (:meth:`export_sessions`, :meth:`import_sessions`,
  :meth:`release_migrated`, :meth:`attach`): a session's state is its
  token bookkeeping plus its blocks' contents, in the wire format of
  :mod:`.sessions`, which both packages read and write;
- backpressure is a bounded queue: beyond ``queue_limit`` outstanding
  requests :meth:`submit` raises :class:`SchedulerOverflow` and the
  server answers 429 + Retry-After.

Every option defaults OFF, which is the core scheduler exactly: the
ladder prefill, the plain free-list pool and the per-token step.

The pools hold per-stage K and V tensors (f32), or ``{"q", "s"}`` dicts
(int8 data and f32 scales).  Wherever they leave the device — a demoted
block, an exported session, a checkpoint — they travel as flat leaf
lists in the JAX package's order (``jax.tree_util.tree_leaves`` of the
per-stage tuple: a dict's keys sorted), with the same shapes per block,
so the bytes read the same in either package.

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
``prefill_chunk_tokens``, ``spec_depth`` or ``kv_dtype`` (autotuning).
The flight recorder is not ported either: an export carries no
``trace_id`` or ``flight`` timeline, and an import ignores both.  The
geometry defaults to the JAX scheduler's tuner-off ``(max_batch,
block_size) = (8, 8)``.

The single worker thread owns every mutable: the block pool, the page
table, the session map and the device pools.  ``submit`` only validates
and enqueues — the cross-thread surface is one Queue and one Future per
request (and per :meth:`kv_dump`).
"""

import collections
import os
import queue
import threading
import time
import uuid
from concurrent.futures import Future

import numpy
import torch

from ..device import resolve_device
from ..checkpoint import delete_checkpoint, load_state, save_state
from ..kvtier import DIR_ENV, TieredKVStore, advert_key
from ..logger import events
from ..znicz.paged_attention import DEFAULT_BLOCK_SIZE
from .kvcache import KVBlockPool, key_chain, required_blocks
from .metrics import DecodeMetrics
from .scheduler import (DeadlineExpired, SchedulerClosed,
                        SchedulerOverflow, bucket_sizes, deadline_expired)
from .sessions import pack_block, unpack_block

__all__ = ["DecodeScheduler", "DEFAULT_PREFILL_CHUNK",
           "DEFAULT_SPEC_DEPTH", "REFUSED_OPTIONS"]

_STOP = object()

#: completed results kept for session re-attach (a migrated session's
#: follow-up, or a retry, can land after completion)
_FINISHED_KEEP = 256

#: the JAX scheduler's tuner-off batch (its block size is the paged
#: attention module's DEFAULT_BLOCK_SIZE)
DEFAULT_MAX_BATCH = 8

#: the JAX package's hand-picked prefill chunk and speculation depth
#: (its autotune sites' baseline candidates)
DEFAULT_PREFILL_CHUNK = 32
DEFAULT_SPEC_DEPTH = 2

#: scheduler options of the JAX package the port does not honour yet:
#: option -> (the refused values, the ROADMAP queue A item that ports
#: them)
REFUSED_OPTIONS = {
    "prefill_chunk_tokens": (("auto",), "item 3, autotune"),
    "spec_depth": (("auto",), "item 3, autotune"),
    "kv_dtype": (("auto",), "item 3, autotune"),
}


def _refuse_unported(options):
    for name, value in options.items():
        refused, item = REFUSED_OPTIONS[name]
        if value in refused:
            raise NotImplementedError(
                "DecodeScheduler(%s=%r) is not ported yet (ROADMAP queue "
                "A %s)" % (name, value, item))


def _leaves(pools):
    """The pools' tensors in the JAX package's leaf order
    (``jax.tree_util.tree_leaves`` of the per-stage tuple: a dict's keys
    sorted, so an int8 pool gives its data, then its scales)."""
    out = []
    for pool in pools:
        if isinstance(pool, dict):
            out.extend(pool[key] for key in sorted(pool))
        else:
            out.append(pool)
    return out


def _gather(pools, blocks):
    """Host numpy copies of the contents of ``blocks``, one per leaf: an
    int gives each leaf's block without the leading axis (a demoted
    block), a list gives ``[len(blocks), ...]`` (a session's blocks)."""
    out = []
    for leaf in _leaves(pools):
        if isinstance(blocks, int):
            part = leaf[blocks]
        else:
            part = leaf.index_select(0, torch.as_tensor(
                blocks, dtype=torch.long, device=leaf.device))
        out.append(part.detach().to("cpu", copy=True).numpy())
    return out


def _host_tensors(pools, host, lead, what):
    """``host`` (numpy leaves, the wire's order) as CPU tensors after
    checking them against the pools: the leaf count, each leaf's dtype,
    and its shape (``lead`` + the per-block shape; ``lead`` None is the
    whole pool).  Raises ValueError naming ``what`` before anything is
    written."""
    leaves = _leaves(pools)
    if len(host) != len(leaves):
        raise ValueError("%s carries %d KV leaves, the pools hold %d"
                         % (what, len(host), len(leaves)))
    out = []
    for leaf, arr in zip(leaves, host):
        arr = numpy.asarray(arr)
        shape = (tuple(leaf.shape) if lead is None
                  else tuple(lead) + tuple(leaf.shape[1:]))
        src = torch.from_numpy(arr.copy() if not arr.flags.writeable
                               or not arr.flags.c_contiguous else arr)
        if src.dtype != leaf.dtype or tuple(src.shape) != shape:
            raise ValueError(
                "%s: a KV leaf of %s %s does not fit a pool leaf of %s %s"
                % (what, src.dtype, tuple(src.shape), leaf.dtype, shape))
        out.append(src)
    return out


def _scatter(pools, blocks, host):
    """Write checked host leaves (:func:`_host_tensors`) into the pools
    in place: at block ``blocks`` (an int), at each of ``blocks`` (a
    list), or over the whole pool (None)."""
    for leaf, src in zip(_leaves(pools), host):
        src = src.to(leaf.device)
        if blocks is None:
            leaf.copy_(src)
        elif isinstance(blocks, int):
            leaf[blocks].copy_(src)
        else:
            leaf.index_copy_(0, torch.as_tensor(
                blocks, dtype=torch.long, device=leaf.device), src)


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "future", "enqueued",
                 "deadline", "sid")

    def __init__(self, prompt, max_new_tokens, session_id=None,
                 deadline=None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.future = Future()
        self.enqueued = time.perf_counter()
        self.deadline = deadline    # absolute time.monotonic() or None
        # every sequence is addressable: an explicit session id or a
        # fresh one (migration, re-attach and kv_dump key on it)
        self.sid = str(session_id) if session_id else uuid.uuid4().hex[:16]


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
                 "generated", "first_token_s", "shared", "prefilled",
                 "tier")

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
        self.tier = None         # deepest tier serving the prefix hit

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
    chunk size), ``prefix_caching`` (needs ``prefill_chunk_tokens``),
    ``spec_depth`` (an int, the draft tokens an iteration) and
    ``kvtier`` (needs ``prefix_caching``): ``{"host_bytes",
    "disk_dir", "disk_bytes"}`` or a ready
    :class:`~veles_tpu_torch.kvtier.TieredKVStore`; ``"disk_dir": True``
    reads the directory from :data:`~veles_tpu_torch.kvtier.DIR_ENV`.

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
                          "spec_depth": spec_depth, "kv_dtype": kv_dtype})
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
        # tiered KV cache: None (default) keeps the evict-means-die pool
        # exactly; otherwise the pool's eviction hook demotes refcount-0
        # chains to host RAM / disk and admits readmit them
        self._kvtier = self._resolve_kvtier(kvtier)
        self._advert = None          # {"hbm": [...], "host": [...], ...}
        self._advert_sig = None
        if self._kvtier is not None:
            self._pool.on_evict = self._demote_block
            self._refresh_advert()   # disk chains advertise pre-traffic
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
        self._by_sid = {}            # session id -> live _Session
        self._migrating = {}         # session id -> parked Future
        self._finished = collections.OrderedDict()  # sid -> result (LRU)
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
        return _leaves(self._k_pools) + _leaves(self._v_pools)

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

    def submit(self, prompt, max_new_tokens=None, session_id=None,
               deadline=None):
        """Enqueue one generate request -> Future of ``{"tokens": [...],
        "ttft_s": float, "prompt_tokens": n, "session_id": sid}``.
        Raises SchedulerOverflow / SchedulerClosed / DeadlineExpired /
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
        req = _Request(prompt, max_new_tokens, session_id=session_id,
                       deadline=deadline)
        self._queue.put(req)
        return req.future

    def generate(self, prompt, max_new_tokens=None, timeout=None,
                 session_id=None, deadline=None):
        """Blocking :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, session_id=session_id,
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
            self._by_sid.pop(session.req.sid, None)
            self._release_session_blocks(session, publish=False)
            self._fail(session.req, exc)
        for session in list(self._sessions.values()):
            self._retire(session, error=exc)
        for sid in list(self._migrating):
            future = self._migrating.pop(sid)
            if future.set_running_or_notify_cancel():
                future.set_exception(exc)

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
            self._by_sid[req.sid] = session
            self.metrics.record_admit(len(req.prompt))
            if session.done:        # max_new_tokens == 1: prefill was all
                self._retire(session)
                rows.insert(0, row)
        self.metrics.set_chunk_queue(len(self._chunking))
        self._set_occupancy()
        if self._kvtier is not None:
            self._refresh_advert()

    def _admit_chunked(self, req, need, rows):
        """Admit the head-of-line request onto the chunked path: attach
        the resident prefix (by reference, suffix-only prefill), allocate
        the rest as private blocks, queue the session for chunk steps.
        Returns False when the pool cannot serve it yet."""
        length = len(req.prompt)
        matched, tier_hit = [], None
        if self.prefix_caching:
            # never match the whole prompt: the first output token needs
            # the hidden state at position length-1, which only a
            # prefill of >= 1 suffix token computes
            keys = key_chain(req.prompt, self.block_size,
                             kv_dtype=self.kv_dtype)[
                                 :(length - 1) // self.block_size]
            matched = self._pool.acquire_prefix(keys)
            if self._kvtier is not None and len(matched) < len(keys):
                matched, tier_hit = self._extend_from_tiers(keys, matched)
            if tier_hit is None and matched:
                tier_hit = "hbm"
        private = self._pool.alloc(need - len(matched))
        if private is None:
            if matched:
                self._pool.release(matched)
            return False
        self._pending.popleft()
        row = rows.pop(0)
        session = _Session(req, row, list(matched) + private)
        session.shared = len(matched)
        session.tier = tier_hit
        session.prefilled = len(matched) * self.block_size
        # the page-table row stays zeroed (trash) until the final chunk
        # lands: decode steps treat the row as padding, and a stray
        # write never touches a shared block
        self._chunking.append(session)
        self._by_sid[req.sid] = session
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
            self._by_sid.pop(req.sid, None)
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
            resident=session.shared * self.block_size / length,
            tier=session.tier)
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

    # -- tiered KV cache (veles_tpu_torch/kvtier) ----------------------------
    def _resolve_kvtier(self, kvtier):
        if not kvtier:
            return None
        if not self.prefix_caching:
            raise ValueError(
                "kvtier requires prefix_caching=True — only "
                "content-addressed chains can demote and readmit")
        if isinstance(kvtier, TieredKVStore):
            if kvtier.observer is None:
                kvtier.observer = self.metrics
            return kvtier
        cfg = dict(kvtier)
        disk_dir = cfg.get("disk_dir")
        if disk_dir is True:
            disk_dir = os.environ.get(DIR_ENV)
            if not disk_dir:
                raise ValueError(
                    "kvtier disk tier requested but %s is not set "
                    "(the fleet supervisor exports it per replica)"
                    % DIR_ENV)
        return TieredKVStore(host_bytes=int(cfg.get("host_bytes") or 0),
                             disk_dir=disk_dir,
                             disk_bytes=int(cfg.get("disk_bytes") or 0),
                             observer=self.metrics)

    def _demote_block(self, block, key):
        """Pool eviction hook: copy the block's device contents (still
        intact: eviction only reclaims the slot) to the host and park
        them in the tier stack.  Runs on the worker at a step
        boundary."""
        block = int(block)
        payload = {"kv_k": _gather(self._k_pools, block),
                   "kv_v": _gather(self._v_pools, block)}
        self._kvtier.demote(key, pack_block(payload))

    def _extend_from_tiers(self, keys, matched):
        """Continue an :meth:`KVBlockPool.acquire_prefix` match down the
        tier stack: each further chain key found in host RAM or on disk
        is written back into a fresh device block, published under its
        key and attached to the session — the readmit that makes a chain
        evicted from the device cost no re-prefill.  A payload that does
        not fit the pools ends the match (the rest is prefilled).
        Returns (matched_blocks, deepest_tier_hit)."""
        deepest = None
        for key in keys[len(matched):]:
            found = self._kvtier.lookup(key)
            if found is None:
                break
            tier, data = found
            alloc = self._pool.alloc(1)
            if alloc is None:
                break                # pool full: prefill the rest
            block = alloc[0]
            payload = unpack_block(data)
            try:
                host_k = _host_tensors(self._k_pools, payload["kv_k"], (),
                                       "a tier block")
                host_v = _host_tensors(self._v_pools, payload["kv_v"], (),
                                       "a tier block")
            except (KeyError, ValueError):
                self._pool.free([block])
                break
            _scatter(self._k_pools, block, host_k)
            _scatter(self._v_pools, block, host_v)
            if not self._pool.publish(block, key):
                # the key became resident between the miss and now
                # (cannot happen on the single worker, but stay safe):
                # drop our copy and attach to the resident one
                self._pool.free([block])
                revived = self._pool.acquire_prefix([key])
                if not revived:
                    break
                block = revived[0]
            matched.append(block)
            if deepest != "disk":
                deepest = tier
        return matched, deepest

    def _refresh_advert(self):
        """Rebuild the resident-chain advertisement (the ``kv_tiers``
        payload :meth:`load` carries on the router's /readyz poll) when
        residency changed.  Keys travel truncated-hex, capped per tier —
        a router only needs enough to rank replicas."""
        cap = 256
        sig = (self._pool.published_blocks, self._pool.evicted_blocks,
               self._kvtier.version)
        if sig == self._advert_sig:
            return
        self._advert_sig = sig
        advert = {"hbm": sorted(advert_key(k) for k in
                                self._pool.resident_keys())[:cap]}
        for tier, keys in self._kvtier.resident_keys().items():
            advert[tier] = sorted(advert_key(k) for k in keys)[:cap]
        self._advert = advert
        self.metrics.set_tier_bytes(**self._kvtier.used_bytes())

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
        self._by_sid.pop(session.req.sid, None)
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
                "session_id": session.req.sid,
            }
            # kept for re-attach: a migrated session's follow-up (or a
            # retry) may arrive after completion
            self._finished[session.req.sid] = result
            while len(self._finished) > _FINISHED_KEEP:
                self._finished.popitem(last=False)
            if future.set_running_or_notify_cancel():
                future.set_result(result)
        self._release()

    # -- jobs on the worker --------------------------------------------------
    def _run_job(self, fn, timeout=120.0):
        """Ship ``fn`` to the worker thread and wait for its result (the
        worker runs jobs only at step boundaries)."""
        if self._closed:
            raise SchedulerClosed("decode scheduler %r is draining"
                                  % self.name)
        job = _Job(fn)
        self._queue.put(job)
        return job.future.result(timeout)

    # -- KV checkpoint / restore ---------------------------------------------
    def checkpoint_kv(self, directory, name="kv"):
        """Checkpoint the whole decode state — the device K/V pools, the
        page-table mirrors, the block pool's accounting and every live
        session's token state — under ``directory``
        (:func:`veles_tpu_torch.checkpoint.save_state`).  Runs on the
        worker at a step boundary, after finishing any chunked prefill
        in flight, so the state is a consistent token-step cut.  Returns
        the checkpoint path."""
        return self._run_job(lambda: self._checkpoint_kv(directory, name))

    def restore_kv(self, path):
        """Load a :meth:`checkpoint_kv` checkpoint (of either package)
        into this idle scheduler and resume its sequences
        mid-generation.  Geometry and ``kv_dtype`` must match; the pools
        are written in place on this scheduler's device.  Returns ``{row:
        Future}`` — the futures of the resumed sequences (the originals
        died with the old scheduler); they emit exactly the tokens the
        uninterrupted run would have."""
        return self._run_job(lambda: self._restore_kv(path))

    def _geometry(self):
        return {"max_batch": self.max_batch,
                "block_size": self.block_size,
                "max_prompt_len": self.max_prompt_len,
                "max_new_tokens": self.max_new_tokens,
                "num_blocks": self._pool.num_blocks,
                "prefix_caching": self.prefix_caching}

    def _checkpoint_kv(self, directory, name):
        # finish chunked prefills in flight first: a session with half a
        # prompt in the pool has no consistent cut to save
        while self._chunking:
            self._chunk_step()
        state = {
            "geometry": dict(self._geometry(), kv_dtype=self.kv_dtype),
            "k_pools": self._k_pools,
            "v_pools": self._v_pools,
            "table": self._np_table.copy(),
            "lengths": self._np_lengths.copy(),
            "tokens": self._np_tokens.copy(),
            "pool": self._pool.state_dict(),
            "sessions": [{
                "row": int(s.row),
                "blocks": [int(b) for b in s.blocks],
                "length": int(s.length),
                "next_input": int(s.next_input),
                "generated": [int(t) for t in s.generated],
                "first_token_s": float(s.first_token_s or 0.0),
                "prompt": numpy.array(s.req.prompt),
                "max_new_tokens": int(s.req.max_new_tokens),
                "shared": int(s.shared),
            } for s in self._sessions.values()],
        }
        return save_state(directory, name, state,
                          meta={"kind": "decode_kv", "scheduler": self.name})

    def _restore_kv(self, path):
        if self._sessions or self._pending or self._chunking:
            raise RuntimeError(
                "restore_kv into a busy scheduler (restore before "
                "serving traffic)")
        state = load_state(path)
        geo = dict(state["geometry"])
        # dtype first, and by name: int8 blocks restored into f32 pools
        # (or the reverse) would reinterpret quantized bytes
        ck_dtype = str(geo.pop("kv_dtype", "f32"))
        if ck_dtype != self.kv_dtype:
            raise ValueError(
                "kv_dtype mismatch: checkpoint holds %s pools but this "
                "scheduler serves %s" % (ck_dtype, self.kv_dtype))
        mine = self._geometry()
        if geo != mine:
            raise ValueError("geometry mismatch: checkpoint %s vs "
                             "scheduler %s" % (geo, mine))
        host_k = _host_tensors(self._k_pools, _leaves(state["k_pools"]),
                               None, "the checkpoint")
        host_v = _host_tensors(self._v_pools, _leaves(state["v_pools"]),
                               None, "the checkpoint")
        self._pool.load_state(state["pool"])
        _scatter(self._k_pools, None, host_k)
        _scatter(self._v_pools, None, host_v)
        self._np_table[:] = state["table"]
        self._np_lengths[:] = state["lengths"]
        self._np_tokens[:] = state["tokens"]
        futures = {}
        for saved in state["sessions"]:
            req = _Request(numpy.asarray(saved["prompt"], numpy.int32),
                           saved["max_new_tokens"])
            session = _Session(req, int(saved["row"]),
                               [int(b) for b in saved["blocks"]])
            session.length = int(saved["length"])
            session.next_input = int(saved["next_input"])
            session.generated = [int(t) for t in saved["generated"]]
            session.first_token_s = saved["first_token_s"]
            session.shared = int(saved.get("shared", 0))
            self._sessions[session.row] = session
            self._by_sid[req.sid] = session
            with self._depth_lock:
                self._depth += 1
            futures[session.row] = req.future
        self._set_occupancy()
        return futures

    # -- live session migration ----------------------------------------------
    # A session's state at a step boundary is its token bookkeeping plus
    # the K/V contents of ITS blocks, gathered to the host: portable to
    # any peer scheduler (of either package) with the same block size
    # and kv_dtype, where it is one more row of the running batch.
    # Export PARKS the original request future instead of completing
    # it: the source answers (with a "migrated" redirect marker) only
    # after release_migrated confirms the import, so a client's
    # follow-up never races an import that failed.

    def export_sessions(self, session_ids=None):
        """Export live sessions (all, or the given ids) as portable state
        dicts at a step boundary.  Exported sessions leave this scheduler
        (rows and blocks freed, futures parked) — follow with
        :meth:`import_sessions` on a peer and :meth:`release_migrated`
        here, or re-import here to abort."""
        return self._run_job(lambda: self._export_sessions(session_ids))

    def import_sessions(self, states):
        """Adopt exported sessions mid-generation.  Each state imports on
        its own; returns ``(imported_ids, errors)`` with errors as
        ``[(sid, reason), ...]``."""
        def job():
            done, errors = [], []
            for state in states:
                try:
                    done.append(self._import_session(state))
                except Exception as exc:  # noqa: BLE001 — per session
                    errors.append((str(state.get("session_id")),
                                   str(exc)))
            return done, errors
        return self._run_job(job)

    def release_migrated(self, session_ids, target=None):
        """Complete the parked futures of exported sessions with a
        ``{"migrated": True, "target": ...}`` marker — the source's
        commit, made only after the target imported."""
        return self._run_job(
            lambda: self._release_migrated(session_ids, target))

    def attach(self, session_id):
        """Re-attach to a session by id: ``("live", future)`` while it
        decodes, waits or is parked mid-migration, ``("finished",
        result)`` after completion, None when unknown."""
        return self._run_job(lambda: self._attach(session_id))

    def session_ids(self):
        """Session-id snapshot: active / migrating / finished."""
        return self._run_job(lambda: {
            "active": sorted(self._by_sid)
            + sorted(r.sid for r in self._pending),
            "migrating": sorted(self._migrating),
            "finished": list(self._finished)})

    def spill_session(self, session_id, directory):
        """Spill one live session to a host checkpoint under
        ``directory`` and free its row and blocks; its waiter gets a
        ``{"spilled": True, "path": ...}`` marker.  Readmit it later
        with :meth:`readmit_session`."""
        return self._run_job(
            lambda: self._spill_session(session_id, directory))

    def readmit_session(self, path, delete=True):
        """Readmit a spilled session into the running batch; returns its
        id (collect the result with :meth:`attach`)."""
        return self._run_job(lambda: self._readmit_session(path, delete))

    def _export_sessions(self, session_ids=None):
        want = None if session_ids is None else set(session_ids)
        states = []
        for session in list(self._sessions.values()):
            if want is not None and session.req.sid not in want:
                continue
            states.append(self._export_one(session))
        # mid-prefill sessions drop their partial KV and travel as
        # prompt-only states (the peer prefills them, from its own
        # resident prefixes where it has them)
        keep_chunking = collections.deque()
        while self._chunking:
            session = self._chunking.popleft()
            if want is not None and session.req.sid not in want:
                keep_chunking.append(session)
                continue
            self._by_sid.pop(session.req.sid, None)
            self._release_session_blocks(session, publish=False)
            states.append(self._fresh_state(session.req))
            self._migrating[session.req.sid] = session.req.future
            self._release()
        self._chunking = keep_chunking
        # queued requests ride along as prompt-only states too
        keep = collections.deque()
        while self._pending:
            req = self._pending.popleft()
            if want is not None and req.sid not in want:
                keep.append(req)
                continue
            states.append(self._fresh_state(req))
            self._migrating[req.sid] = req.future
            self._release()
        self._pending = keep
        if states:
            self.metrics.record_migrate(len(states), "out")
            self.metrics.set_occupancy(
                len(self._sessions),
                self._pool.live_blocks / max(self._pool.capacity, 1))
        return states

    def _fresh_state(self, req):
        """A prompt-only state.  The JAX package adds the request's
        ``trace_id`` and flight timeline here; the port has no flight
        recorder yet and leaves both out."""
        return {"session_id": req.sid,
                "prompt": numpy.array(req.prompt),
                "max_new_tokens": int(req.max_new_tokens),
                "block_size": self.block_size,
                "kv_dtype": self.kv_dtype,
                "deadline_left_s": None if req.deadline is None
                else max(req.deadline - time.monotonic(), 0.0)}

    def _export_one(self, session):
        req = session.req
        # with the tier stack on, the leading run of published blocks
        # travels BY HASH: chain keys are content addresses a peer
        # resolves against its own pool and tiers, so the wire carries
        # device bytes only for the private tail
        hash_keys = []
        if self._kvtier is not None:
            for b in session.blocks:
                key = self._pool.key_of(b)
                if key is None:
                    break
                hash_keys.append(key)
        tail = [int(b) for b in session.blocks[len(hash_keys):]]
        state = self._fresh_state(req)
        state.update({
            "length": int(session.length),
            "next_input": int(session.next_input),
            "generated": [int(t) for t in session.generated],
            "first_token_s": float(session.first_token_s or 0.0),
            "kv_k": _gather(self._k_pools, tail),
            "kv_v": _gather(self._v_pools, tail),
        })
        if hash_keys:
            state["kv_hash"] = [k.hex() for k in hash_keys]
        self._sessions.pop(session.row, None)
        self._by_sid.pop(req.sid, None)
        self._release_session_blocks(session, publish=False)
        self._np_table[session.row, :] = 0
        self._np_lengths[session.row] = 0
        self._np_tokens[session.row] = 0
        self._migrating[req.sid] = req.future
        self._release()
        return state

    def _import_session(self, state):
        """Adopt one exported state (``trace_id`` and ``flight``, which
        the JAX package's exports carry, are ignored)."""
        sid = str(state["session_id"])
        if sid in self._by_sid or any(r.sid == sid for r in self._pending):
            raise ValueError("session %r is already live here" % sid)
        if int(state["block_size"]) != self.block_size:
            raise ValueError(
                "block_size mismatch: session %s vs scheduler %s"
                % (state["block_size"], self.block_size))
        prompt = self.validate(numpy.asarray(state["prompt"]),
                               state["max_new_tokens"])
        deadline = None
        if state.get("deadline_left_s") is not None:
            deadline = time.monotonic() + float(state["deadline_left_s"])
        req = _Request(prompt, state["max_new_tokens"], session_id=sid,
                       deadline=deadline)
        # the parked future, when this is the source taking its own
        # export back: the original waiter stays attached
        parked = self._migrating.pop(sid, None)
        if parked is not None:
            req.future = parked

        def refuse(exc, lead=(), blocks=()):
            if lead:
                self._pool.release(lead)
            if blocks:
                self._pool.free(blocks)
            if parked is not None:          # re-park: the caller may retry
                self._migrating[sid] = parked
            raise exc

        # prompt-only states carry no KV bytes and import under any pool
        # dtype; states with KV must match (int8 payloads in f32 pools
        # would be garbage)
        if state.get("kv_k") is not None \
                and str(state.get("kv_dtype", "f32")) != self.kv_dtype:
            refuse(ValueError(
                "kv_dtype mismatch: session %s travels %s KV blocks but "
                "this scheduler serves %s"
                % (sid, state.get("kv_dtype", "f32"), self.kv_dtype)))
        if state.get("kv_k") is None:       # prompt-only: just enqueue
            self._pending.append(req)
            with self._depth_lock:
                self._depth += 1
            return sid
        rows = self._free_rows()
        # hash-referenced lead blocks resolve against local content:
        # device chains first, then the tier stack
        hash_hexes = [str(h) for h in state.get("kv_hash") or []]
        lead = []
        if hash_hexes:
            if not self.prefix_caching:
                refuse(ValueError(
                    "session %r carries hashed prefix blocks but this "
                    "scheduler has prefix_caching off" % sid))
            keys = [bytes.fromhex(h) for h in hash_hexes]
            lead = self._pool.acquire_prefix(keys)
            if self._kvtier is not None and len(lead) < len(keys):
                lead, _ = self._extend_from_tiers(keys, lead)
            if len(lead) < len(keys):
                refuse(ValueError(
                    "cannot resolve hashed prefix of session %r (%d/%d "
                    "chain keys resident)"
                    % (sid, len(lead), len(hash_hexes))), lead)
        n_blocks = int(numpy.shape(state["kv_k"][0])[0])
        blocks = self._pool.alloc(n_blocks) if rows else None
        if blocks is None:
            refuse(RuntimeError(
                "no capacity to import session %r (%d blocks, %d free; %d "
                "rows free)" % (sid, n_blocks, self._pool.free_blocks,
                                len(rows))), lead)
        try:
            host_k = _host_tensors(self._k_pools, state["kv_k"],
                                   (n_blocks,), "session %s" % sid)
            host_v = _host_tensors(self._v_pools, state["kv_v"],
                                   (n_blocks,), "session %s" % sid)
        except ValueError as exc:
            refuse(exc, lead, blocks)
        _scatter(self._k_pools, blocks, host_k)
        _scatter(self._v_pools, blocks, host_v)
        row = rows.pop(0)
        session = _Session(req, row, list(lead) + blocks)
        session.shared = len(lead)
        session.length = int(state["length"])
        session.next_input = int(state["next_input"])
        session.generated = [int(t) for t in state["generated"]]
        session.first_token_s = float(state["first_token_s"])
        self._np_table[row, :] = self._block_row(session)
        self._np_lengths[row] = session.length
        self._np_tokens[row] = session.next_input
        self._sessions[row] = session
        self._by_sid[sid] = session
        with self._depth_lock:
            self._depth += 1
        self.metrics.record_migrate(1, "in")
        self._set_occupancy()
        return sid

    def _release_migrated(self, session_ids, target):
        released = []
        for sid in session_ids:
            future = self._migrating.pop(sid, None)
            if future is None:
                continue
            if future.set_running_or_notify_cancel():
                future.set_result({"migrated": True, "session_id": sid,
                                   "target": target})
            released.append(sid)
        return released

    def _attach(self, session_id):
        sid = str(session_id)
        session = self._by_sid.get(sid)
        if session is not None:
            return "live", session.req.future
        for req in self._pending:
            if req.sid == sid:
                return "live", req.future
        if sid in self._migrating:
            return "live", self._migrating[sid]
        if sid in self._finished:
            return "finished", self._finished[sid]
        return None

    def _spill_session(self, session_id, directory):
        sid = str(session_id)
        session = self._by_sid.get(sid)
        if session is None:
            raise KeyError("no live session %r to spill" % sid)
        state = self._export_one(session)
        path = save_state(directory, "session-" + sid, state,
                          meta={"kind": "decode_session",
                                "scheduler": self.name,
                                "session_id": sid})
        future = self._migrating.pop(sid, None)
        if future is not None and future.set_running_or_notify_cancel():
            future.set_result({"spilled": True, "session_id": sid,
                               "path": str(path)})
        events.event("serving.session_spill", model=self.name, session=sid)
        return str(path)

    def _readmit_session(self, path, delete):
        state = load_state(path)
        sid = self._import_session(state)
        if delete:
            delete_checkpoint(path)
        events.event("serving.session_readmit", model=self.name,
                     session=sid)
        return sid

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
        if self._kvtier is not None:
            problems.extend(self._kvtier.check_integrity())
            tiers = self._kvtier.stats()
            resident = {"hbm": sorted(k.hex()[:12] for k in
                                      self._pool.resident_keys())}
            for tier, keys in self._kvtier.resident_keys().items():
                resident[tier] = sorted(str(k)[:12] for k in keys)
            tiers["resident"] = resident
            dump["kvtier"] = tiers
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
        out = {"kind": "decode",
               "queue_depth": depth,
               "queue_limit": self.queue_limit,
               "utilization": round(depth / self.queue_limit, 4),
               "active_rows": len(self._sessions),
               "chunking_sessions": len(self._chunking),
               "kv_occupancy": round(
                   self._pool.live_blocks /
                   max(self._pool.capacity, 1), 4)}
        advert = self._advert
        if advert is not None:
            # the resident-chain advertisement a router reads off the
            # /readyz load poll: a snapshot the worker swaps in whole,
            # so reading it here is still poll-safe
            out["kv_tiers"] = advert
        return out

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
            "migrating_sessions": len(self._migrating),
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
        if self._kvtier is not None:
            out["kvtier"] = self._kvtier.stats()
        return out
