"""MinibatchPrefetcher: serve minibatches ahead of the training step.

The port of ``veles_tpu/loader/prefetch.py``.  The synchronous per-step
loop runs ``loader.run() -> step.run()`` strictly in turn, so the card
waits for the host's minibatch preparation on every step (the
``data_wait`` phase of the StepProfiler).  A worker thread serves
minibatches ``depth`` steps ahead into a bounded queue and stages each
on the card; the consumer's ``loader.run()`` installs the next ready
one.

**Twin serving** keeps the semantics exact without a second copy of any
loader logic: the worker drives a *twin* of the loader, an object of the
same class whose ``__dict__`` starts as the loader's (so the generator
state is shared by reference: ``prng``, ``shuffled_indices``,
``failed_minibatches``, ``labels_mapping``, the class geometry, a
``ShardedBatchLoader``'s window) but with private minibatch Arrays, epoch
flags, counters and ``pending_minibatches_``, so the worker writes no
surface the consumer reads.  Each production calls the loader's own,
unmodified ``run()`` on the twin and snapshots the result into an item;
consumption installs it into the real loader, the flags last: the same
minibatch order, shuffles and flag edges, one step earlier in wall
time only.  The worker never crosses an epoch's end ahead of the
consumer: the shuffle that opens the next epoch moves the shared
``shuffled_indices`` and ``prng``, so it waits until the consumer asks
for that epoch's first minibatch.  A snapshot taken at any moment then
pickles the generator state of the minibatch last consumed, and a
restored run serves what the uninterrupted one would.

**Staging on the card.**  The worker copies each item's padded index
vector and size (a fused step's gather; the step reads them as
``prefetch_staged_``), or the minibatch Arrays the loader served on the
host (``force_numpy``, a ``ShardedBatchLoader``), into pinned host
memory, issues their asynchronous copies on a CUDA stream of its own
and records an event.  The consumer makes its current stream wait on
that event and marks the staged tensors used there (``record_stream``)
before the step reads them: without the wait the step could read
indices still in flight, and without the mark the allocator could hand
their memory to another copy while the step still reads it.  The
buffers are a ring of ``depth + 14`` slots, pinned and on the card: a
slot's next copy waits for an event the consumer records on its stream
once the step that read the slot is queued, and the worker refills a
slot's pinned half only after that slot's last copy is done.  The worker
issues its copies and events through the CUDA driver with Python's GIL
held (``_Driver``): the training thread releases the GIL on every
PyTorch operation and takes it straight back, so a worker that released
it on every call of its own (a ``pin_memory``, a ``copy_``, an event)
waited for it again each time and fell behind a step of ~90 launches
(``chip_smoke.py`` phase 4i: 15.6 % of the fenced loop blocked on the
queue against 2.8 % synchronously, MNIST on an NVIDIA H100 80GB HBM3 at
700.00 W).  On the CPU, items carry host copies only.

Guarantees:

- ``prefetch_depth = 0`` (or :meth:`MinibatchPrefetcher.attach`
  returning None) leaves the loader on its synchronous path, untouched;
- the minibatch sequence, the requeue of ``failed_minibatches`` and the
  epoch metrics are the synchronous path's;
- the master/slave methods (``generate_data_for_slave`` /
  ``apply_data_from_master``), where a loader has them, detach the
  prefetcher on their first call and serve synchronously;
- a worker's exception is raised again on the consumer (after the items
  queued before it), then :class:`PrefetchError`;
- ``stop()`` joins the worker and keeps the queued items (they are
  served first when serving resumes); the workflow's end stops it, so
  no thread outlives ``Workflow.run()``;
- the wrappers it installs on the loader are ``transient_``: a pickle
  taken mid-run carries no worker, queue or wrapper.
"""

import collections
import ctypes
import logging
import queue as queue_mod
import threading
import time
import weakref

import numpy
import torch

from ..config import root
from ..device import resolve_device
from ..memory import Array
from ..mutable import Bool
from ..observability.registry import REGISTRY

__all__ = ["MinibatchPrefetcher", "PrefetchError"]

logger = logging.getLogger("prefetch")

#: per-minibatch output surfaces the twin gets private copies of
_OUT_ARRAYS = ("minibatch_data", "minibatch_labels", "minibatch_indices",
               "minibatch_targets")
_OUT_FLAGS = ("last_minibatch", "epoch_ended", "train_ended", "valid_ended")
#: instance-dict wrappers that must never leak onto the twin
_WRAPPED = ("run", "stop", "generate_data_for_slave",
            "apply_data_from_master")
#: how long blocked queue operations sleep before checking stop/failure
_POLL_S = 0.05
#: ring slots beyond the queue's depth: the queue, the worker's carry and
#: the item being consumed hold at most ``depth + 2`` slots at once, and
#: the rest let the card lag the host by as many steps before the worker
#: waits for a slot's last copy
_RING_SPARE = 14


class _Driver:
    """The CUDA driver calls of the worker's staging, made with the GIL
    held (``ctypes.PyDLL``): each takes microseconds, and a call that
    released the GIL would wait for it again behind the training thread.
    Handles are PyTorch's own (``cuda_stream``, ``cuda_event``,
    ``data_ptr()``): the driver's stream and event objects."""

    _lib = None
    _NOT_READY = 600

    @classmethod
    def lib(cls):
        if cls._lib is None:
            lib = ctypes.PyDLL("libcuda.so.1")
            vp, sz = ctypes.c_void_p, ctypes.c_size_t
            for name, args in (
                    ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_int]),
                    ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(vp),
                                                  ctypes.c_int]),
                    ("cuCtxSetCurrent", [vp]),
                    ("cuMemcpyHtoDAsync_v2", [ctypes.c_uint64, vp, sz, vp]),
                    ("cuEventRecord", [vp, vp]),
                    ("cuEventQuery", [vp]),
                    ("cuStreamWaitEvent", [vp, vp, ctypes.c_uint]),
                    ("cuGetErrorString", [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_char_p)])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            cls._lib = lib
        return cls._lib

    @classmethod
    def check(cls, code, what):
        if code:
            msg = ctypes.c_char_p()
            cls.lib().cuGetErrorString(code, ctypes.byref(msg))
            raise RuntimeError("%s failed: CUDA driver error %d (%s)" % (
                what, code, msg.value.decode() if msg.value else "?"))

    @classmethod
    def bind(cls, index):
        """Make card ``index``'s primary context (PyTorch's) current on
        the calling thread."""
        lib = cls.lib()
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        cls.check(lib.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        cls.check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        cls.check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")

    @classmethod
    def copy(cls, dst, src, nbytes, stream):
        cls.check(cls.lib().cuMemcpyHtoDAsync_v2(dst, src, nbytes, stream),
                  "cuMemcpyHtoDAsync")

    @classmethod
    def record(cls, event, stream):
        cls.check(cls.lib().cuEventRecord(event, stream), "cuEventRecord")

    @classmethod
    def wait(cls, stream, event):
        cls.check(cls.lib().cuStreamWaitEvent(stream, event, 0),
                  "cuStreamWaitEvent")

    @classmethod
    def done(cls, event):
        code = cls.lib().cuEventQuery(event)
        if code == cls._NOT_READY:
            return False
        cls.check(code, "cuEventQuery")
        return True


class PrefetchError(RuntimeError):
    """The prefetch worker died and its exception was already raised once
    on the consumer: raised on any further serve."""


def _worker_main(ref, stop_evt):
    """The worker thread.  It holds only a weak reference between
    cycles, so an abandoned workflow stays collectable: when the
    prefetcher is collected the worker exits at its next wake-up."""
    idle = 0
    while not stop_evt.is_set():
        self = ref()
        if self is None:
            return
        try:
            idle = self._work_once(idle)
        except BaseException as exc:  # noqa: BLE001 — raised at consume
            self._failure = exc
            return
        del self


class _Item:
    """One prefetched minibatch: everything the synchronous path leaves
    on the loader after ``run()``."""

    __slots__ = ("offset", "size", "cls", "epoch", "served",
                 "global_offset", "flags", "arrays", "raw_labels",
                 "padded", "staged", "event", "slot")


class MinibatchPrefetcher:
    """Background producer for one loader's serving.

    Constructing one attaches it; :meth:`attach` honours the
    ``prefetch_depth`` knob and the loader's ``supports_prefetch`` in one
    call.  ``device`` (default: the card; no card raises unless
    ``device="cpu"``) is where items are staged; ``stage_to_device=False``
    keeps host copies only.
    """

    @classmethod
    def attach(cls, loader, depth=None, **kwargs):
        """Attach per the config; None (nothing attached) when ``depth``
        is 0 or the loader opts out (``supports_prefetch = False``)."""
        if depth is None:
            depth = int(root.common.loader.get("prefetch_depth", 2) or 0)
        if depth <= 0:
            return None
        if not getattr(loader, "supports_prefetch", True):
            logger.debug("%s opts out of prefetching", loader)
            return None
        existing = getattr(loader, "prefetcher_", None)
        if existing is not None:
            existing.detach()
        return cls(loader, depth=depth, **kwargs)

    def __init__(self, loader, depth=2, stage_to_device=True, device=None,
                 registry=None):
        if depth <= 0:
            raise ValueError("depth must be >= 1 (attach() takes 0 as "
                             "no prefetching)")
        self._loader = loader
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._stage = bool(stage_to_device)
        # the worker's own copy stream and the staging ring (the card
        # only): each slot's pinned and device buffers by field, made by
        # the worker at first use, and two events a slot: "free" (the
        # consumer's stream is past the step that read it) and "done"
        # (its last copy finished)
        self._stream = self._free = self._done = None
        if self._stage and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            n = self.depth + _RING_SPARE
            self._free = [torch.cuda.Event() for _ in range(n)]
            self._done = [torch.cuda.Event() for _ in range(n)]
            for ev in self._free + self._done:
                ev.record(self._stream)     # created, and complete
        self._slots = [{} for _ in self._done or ()]
        self._next_slot = 0
        self._read_slot = None    # the slot of the item consumed last
        self._marked = set()      # (ring buffer, consumer stream) marked
        self._bound = None        # the worker thread bound to the context
        self._queue = queue_mod.Queue(maxsize=self.depth)
        self._carry = None        # produced, not yet queued (stop())
        self._thread = None
        self._stop_evt = threading.Event()
        self._failure = None
        self._lock = threading.Lock()   # worker lifecycle transitions
        self.produced = 0
        self.consumed = 0
        self.requested = 0        # consumer run() calls so far
        # set on every event the idle worker waits for: an item taken, a
        # minibatch asked for, stop()
        self._wake = threading.Event()
        self.restarts = 0
        self.wait_s = 0.0         # consumer time blocked on the queue
        reg = registry or REGISTRY
        lbl = {"loader": getattr(loader, "name", type(loader).__name__)}
        self._g_queue = reg.gauge(
            "veles_loader_prefetch_queue", "Prefetched minibatches ready",
            ("loader",)).labels(**lbl)
        self._c_items = reg.counter(
            "veles_loader_prefetch_items_total",
            "Minibatches served through the prefetch queue",
            ("loader",)).labels(**lbl)
        self._c_wait = reg.counter(
            "veles_loader_prefetch_wait_seconds_total",
            "Consumer time blocked waiting on the prefetch queue",
            ("loader",)).labels(**lbl)
        self._twin = self._make_twin()
        self._install_wrappers()
        loader.prefetcher_ = self

    # -- twin ----------------------------------------------------------------
    def _make_twin(self):
        """A worker-private serving view of the loader: shared generator
        state, private output surfaces."""
        ld = self._loader
        twin = object.__new__(type(ld))
        state = dict(ld.__dict__)
        for name in _WRAPPED:
            state.pop(name, None)   # never inherit instance wrappers
        twin.__dict__.update(state)
        twin.pending_minibatches_ = collections.defaultdict(list)
        twin.prefetcher_ = None
        twin.prefetch_staged_ = None
        for name in _OUT_ARRAYS:
            arr = getattr(ld, name, None)
            if not isinstance(arr, Array):
                continue
            fresh = Array()
            host = arr.mem
            if host is None and arr:
                host = arr.map_read()
            if host is not None:
                fresh.reset(numpy.array(host, copy=True))
            if arr.device is not None:
                fresh.initialize(arr.device)
            setattr(twin, name, fresh)
        for name in _OUT_FLAGS:
            flag = getattr(ld, name, None)
            if isinstance(flag, Bool):
                setattr(twin, name, Bool(bool(flag)))
        twin.raw_minibatch_labels = list(ld.raw_minibatch_labels)
        return twin

    # -- wrappers ------------------------------------------------------------
    def _install_wrappers(self):
        ld = self._loader
        # instance-level overrides already there (an outer profiler's
        # wrapper) come back on detach
        self._origs = {name: ld.__dict__.get(name) for name in _WRAPPED}

        def _run():
            return self._consume()

        def _stop():
            # the workflow finished: join the worker (no leaked thread);
            # queued items wait for the next run()
            self.stop()
            return type(ld).stop(ld)

        self._wrappers = {"run": _run, "stop": _stop}
        # the master/slave methods detach, where the loader has them
        if hasattr(type(ld), "generate_data_for_slave"):
            def _gdfs(slave=None):
                self.detach(reason="master-side slave serving")
                return type(ld).generate_data_for_slave(ld, slave)
            self._wrappers["generate_data_for_slave"] = _gdfs
        if hasattr(type(ld), "apply_data_from_master"):
            def _adfm(data):
                self.detach(reason="slave-side master serving")
                return type(ld).apply_data_from_master(ld, data)
            self._wrappers["apply_data_from_master"] = _adfm
        for name, fn in self._wrappers.items():
            # Pickleable.__getstate__ drops transient_ callables: a
            # snapshot taken mid-run never pickles the worker
            fn.transient_ = True
            setattr(ld, name, fn)

    # -- production (worker thread) ------------------------------------------
    def _produce(self):
        tw = self._twin
        tw.run()    # the loader's own serving, unmodified
        it = _Item()
        it.offset = tw.minibatch_offset
        it.size = tw.minibatch_size
        it.cls = tw.minibatch_class
        it.epoch = tw.epoch_number
        it.served = tw.samples_served
        it.global_offset = tw._global_offset
        it.flags = tuple(bool(getattr(tw, n)) for n in _OUT_FLAGS)
        it.raw_labels = (list(tw.raw_minibatch_labels[:it.size])
                         if tw.has_labels else None)
        idx = tw.minibatch_indices
        it.arrays = [("minibatch_indices",
                      numpy.array(idx.mem, copy=True)
                      if idx.mem is not None else None, None)]
        it.padded = it.staged = it.event = it.slot = None
        fields = []     # (name, host array) to stage together
        if tw.defer_device_gather:
            # the step gathers from the resident dataset: stage the
            # indices and the size, the data never leaves the device
            it.padded = tw._padded_indices_
            if self._stage:
                fields = [("indices", it.padded),
                          ("size", numpy.array(it.size, numpy.int64))]
        else:
            for name in ("minibatch_data", "minibatch_labels",
                         "minibatch_targets"):
                arr = getattr(tw, name, None)
                if not isinstance(arr, Array) or not arr:
                    continue
                if arr._device_dirty_ and arr._devmem_ is not None:
                    # device-fresh (a gather on the loader's device, a new
                    # tensor each call): it rides as it is
                    it.arrays.append((name, None, arr._devmem_))
                elif self._stage:
                    fields.append((name, arr.mem))
                else:   # copied out of the twin's reused buffer
                    it.arrays.append((name, numpy.array(arr.mem, copy=True),
                                      None))
        if fields:
            staged = self._stage_fields(it, fields)
            if it.padded is not None:
                it.staged = (staged["indices"], staged["size"])
            else:
                it.arrays.extend((name, None, staged[name])
                                 for name, _ in fields)
        return it

    def _stage_fields(self, it, fields):
        """{name: device tensor} of the host arrays ``fields``: host
        copies on the CPU; on the card the next ring slot's buffers,
        filled and copied on the worker's stream (``it.slot``,
        ``it.event``: the slot and its "done" event)."""
        if self._stream is None:
            return {name: torch.from_numpy(numpy.array(h, copy=True))
                    for name, h in fields}
        if self._bound != threading.get_ident():
            # a new worker thread: the driver needs the context current
            _Driver.bind(self.device.index)
            self._bound = threading.get_ident()
        j = self._next_slot
        self._next_slot = (j + 1) % len(self._slots)
        slot, stream = self._slots[j], self._stream.cuda_stream
        done = self._done[j].cuda_event
        # the pinned half is refilled once the slot's last copy is done
        while not _Driver.done(done):
            time.sleep(0.0002)
        out = {}
        for k, (name, host) in enumerate(fields):
            host = numpy.asarray(host)
            bufs = slot.get(name)
            if bufs is None or bufs[1].shape != host.shape or \
                    bufs[1].dtype != host.dtype:
                dtype = torch.from_numpy(numpy.empty(0, host.dtype)).dtype
                pinned = torch.empty(host.shape, dtype=dtype,
                                     pin_memory=True)
                # allocated on the worker's stream, which writes it: a
                # block from another stream's pool may still be written
                # by that stream's queued work
                with torch.cuda.stream(self._stream):
                    dev = torch.empty(host.shape, dtype=dtype,
                                      device=self.device)
                bufs = slot[name] = (pinned, pinned.numpy(), dev)
            pinned, view, dev = bufs
            view[...] = host
            if k == 0:
                # the step that read this slot last is past: the
                # consumer recorded "free" on its stream after queueing it
                _Driver.wait(stream, self._free[j].cuda_event)
            _Driver.copy(dev.data_ptr(), pinned.data_ptr(), host.nbytes,
                         stream)
            out[name] = dev
        _Driver.record(done, stream)
        it.slot, it.event = j, self._done[j]
        return out

    def _at_epoch_end(self):
        """Would the twin's next serve open a new epoch (and shuffle)?"""
        tw = self._twin
        return not tw.failed_minibatches and \
            tw._global_offset >= tw.effective_total

    def _work_once(self, idle_polls):
        """One produce-or-enqueue cycle; the next idle count.  An idle
        worker sleeps until woken (``_wake``), its timeout backing off
        while the consumer is away, so it costs next to nothing."""
        # cleared before the checks: a wake-up after them is not lost
        self._wake.clear()
        if self._carry is None:
            if self._at_epoch_end() and self.requested <= self.produced:
                # open the next epoch only once the consumer asks for it
                self._wake.wait(min(_POLL_S * (1 + idle_polls), 1.0))
                return idle_polls + 1
            self._carry = self._produce()
            self.produced += 1
        try:
            self._queue.put_nowait(self._carry)
        except queue_mod.Full:
            self._wake.wait(min(_POLL_S * (1 + idle_polls), 1.0))
            return idle_polls + 1
        self._carry = None
        return 0

    # -- consumption (the training thread) -----------------------------------
    def _ensure_worker(self):
        t = self._thread
        if t is not None and t.is_alive():
            return
        if self._failure is not None:
            # a dead worker's queue drains, but it never restarts: the
            # twin's serving state is suspect
            if self._queue.empty():
                self._reraise()
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            if self.produced > 0:
                self.restarts += 1
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=_worker_main,
                args=(weakref.ref(self), self._stop_evt), daemon=True,
                name="veles-prefetch-%s" % getattr(
                    self._loader, "name", "loader"))
            self._thread.start()

    def _reraise(self):
        exc, self._failure = self._failure, PrefetchError(
            "prefetch worker for %s already died" % self._loader)
        raise exc

    def _consume(self):
        if self._read_slot is not None:
            # the step that read the last item's slot is queued now: the
            # worker's next copy into that slot waits for it
            _Driver.record(self._free[self._read_slot].cuda_event,
                           torch.cuda.current_stream(
                               self.device).cuda_stream)
            self._read_slot = None
        self.requested += 1
        self._wake.set()
        self._ensure_worker()
        t0 = time.perf_counter()
        while True:
            try:
                it = self._queue.get(timeout=_POLL_S)
                self._wake.set()    # room in the queue
                break
            except queue_mod.Empty:
                if self._failure is not None and self._queue.empty():
                    self._reraise()
                self._ensure_worker()
        waited = time.perf_counter() - t0
        self.wait_s += waited
        self._c_wait.inc(waited)
        self._c_items.inc()
        self._g_queue.set(self._queue.qsize())
        self._install(it)

    def _install(self, it):
        ld = self._loader
        if it.event is not None:
            # order the step after the staged copies (the driver's call:
            # PyTorch's would hand the GIL to the worker), and keep their
            # memory from the allocator until the steps that read it are
            # done: a ring buffer is marked once a consumer stream, since
            # the mark holds back its free until the stream's work then
            stream = torch.cuda.current_stream(self.device)
            _Driver.wait(stream.cuda_stream, it.event.cuda_event)
            for t in (it.staged or ()) + tuple(
                    dev for _, _, dev in it.arrays if dev is not None):
                key = (t.data_ptr(), stream.cuda_stream)
                if key not in self._marked:
                    t.record_stream(stream)
                    self._marked.add(key)
            self._read_slot = it.slot
        ld.minibatch_offset = it.offset
        ld.minibatch_size = it.size
        ld.minibatch_class = it.cls
        ld.epoch_number = it.epoch
        ld.samples_served = it.served
        ld._global_offset = it.global_offset
        for name, host, dev in it.arrays:
            arr = getattr(ld, name)
            if dev is not None:
                arr.devmem = dev        # the host copy is read lazily
            elif host is not None:
                arr.mem = host
        if it.raw_labels is not None:
            ld.raw_minibatch_labels[:len(it.raw_labels)] = it.raw_labels
        if it.padded is not None:
            ld._padded_indices_ = it.padded
        ld.prefetch_staged_ = it.staged
        # the flags last: a Bool expression downstream sees a complete
        # minibatch when an edge fires
        for name, value in zip(_OUT_FLAGS, it.flags):
            flag = getattr(ld, name)
            flag <<= value
        self.consumed += 1

    # -- lifecycle -----------------------------------------------------------
    def stop(self):
        """Join the worker; queued items are kept and served first when
        serving resumes."""
        self._stop_evt.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10)
        self._thread = None

    def detach(self, reason=None):
        """Give the loader its synchronous serving back.  Items not yet
        consumed are dropped; the generator resumes from the last
        consumed minibatch, where the synchronous path would be."""
        self.stop()
        ld = self._loader
        for name, fn in self._wrappers.items():
            if ld.__dict__.get(name) is fn:
                del ld.__dict__[name]
                orig = self._origs.get(name)
                if orig is not None:
                    ld.__dict__[name] = orig
        # the loader's _global_offset is the last CONSUMED minibatch's,
        # so synchronous serving generates again (never skips) what was
        # still queued; prng draws the twin spent on a shuffle ahead are
        # not rewound (a valid, possibly other permutation of the epoch)
        ld.prefetch_staged_ = None
        ld.prefetcher_ = None
        if reason:
            logger.debug("prefetcher for %s detached (%s)", ld, reason)

    def stats(self):
        return {"depth": self.depth,
                "produced": self.produced,
                "consumed": self.consumed,
                "queued": self._queue.qsize(),
                "restarts": int(self.restarts),
                "consumer_wait_s": round(self.wait_s, 4),
                "staging": bool(self._stage)}

    def __repr__(self):
        return ("<MinibatchPrefetcher depth=%d of %r (%d/%d "
                "produced/consumed)>" % (self.depth, self._loader,
                                         self.produced, self.consumed))
