"""Dynamic micro-batching over power-of-two shape buckets.

The port of ``veles_tpu/serving/scheduler.py``: the request-granularity
:class:`BucketScheduler` behind ``POST /api/<model>``, the model
adapters, and the vocabulary the decode path shares (the bucket ladder,
the backpressure and drain exceptions, the deadline check).

- concurrent requests are concatenated into one batch and **padded to
  the next power-of-two bucket**, so the steady state only ever sees
  ``log2(max_batch)+1`` distinct shapes;
- every bucket is **warmed once at startup**: a :class:`TorchModel`
  runs its forward once on zeros of the bucket's shape, which builds
  the CUDA kernels (``nvcc`` at first use) and loads the library
  handles before the first request.  PyTorch runs eagerly, so the JAX
  scheduler's AOT executables have no counterpart; its persistent cache
  is the port's build cache (``cache``, default the configured one;
  :mod:`~veles_tpu_torch.compilecache`), whose kernel libraries a
  restart loads instead of building, and its warmup manifest
  (``manifest``) orders a restart's warmup and carries the tuned
  ladder;
- the ladder is an autotune site (``serving.bucket_ladder``): an
  explicit ``buckets`` list pins it, else a tuning record for this
  ``max_batch`` picks the measured shape, and with the tuner off it is
  :func:`bucket_sizes`;
- batching is **continuous**: a dispatch worker drains whatever is
  queued and executes immediately; while a batch runs, the next one
  accumulates;
- backpressure is a bounded count of outstanding requests: when full,
  :meth:`BucketScheduler.submit` raises :class:`SchedulerOverflow` and
  the server answers 429.

A model is an exported package (a path or a
:class:`~veles_tpu_torch.export.PackageLoader`: its forward chain
rebuilt from the port's units on the scheduler's device), a live
workflow with a ``forwards`` chain (its units' ``apply`` over the
parameters, copied once to the scheduler's device), a pre-built
:class:`TorchModel` / :class:`OpaqueModel`, or a bare callable
``fn(x) -> y`` on numpy batches.  A :class:`TorchModel` counts the hand
kernels its dispatched batches launch (``stats()["kernel_launches"]``,
over ``GET /metrics``).
"""

import functools
import queue
import threading
import time
from concurrent.futures import Future

import numpy
import torch

from .. import _build
from ..compilecache import WarmupManifest, default_cache
from ..device import resolve_device
from ..export import PackageLoader, forward_fn
from ..logger import events
from ..observability import trace as _trace
from ..observability.flight import RECORDER as _flight
from .metrics import ServingMetrics

__all__ = ["SchedulerOverflow", "SchedulerClosed", "DeadlineExpired",
           "deadline_expired", "bucket_sizes", "TorchModel",
           "OpaqueModel", "adapt_model", "forward_fn", "warm_kernels",
           "kernel_wrappers", "BucketScheduler"]


class SchedulerOverflow(RuntimeError):
    """The bounded request queue is full — shed load (HTTP 429)."""


class SchedulerClosed(RuntimeError):
    """The scheduler is draining or stopped — no new requests."""


class DeadlineExpired(RuntimeError):
    """The request's end-to-end deadline passed before it reached the
    device — shed (HTTP 504) instead of spending batch rows on an
    answer nobody is waiting for."""


def deadline_expired(deadline, now=None):
    """True when an absolute ``time.monotonic()`` deadline has passed
    (None = no deadline)."""
    if deadline is None:
        return False
    return (time.monotonic() if now is None else now) >= deadline


def bucket_sizes(max_size):
    """The power-of-two bucket ladder: 1, 2, 4, ... max_size."""
    if max_size < 1:
        raise ValueError("max_size must be >= 1")
    sizes, b = [], 1
    while b < max_size:
        sizes.append(b)
        b <<= 1
    sizes.append(int(max_size))   # top bucket even when not a power of two
    return sizes


def warm_kernels(cache, device):
    """With a build cache on the card, load every kernel library from it
    now (a warm cache: no ``nvcc``), so a scheduler's warmup and first
    requests build nothing -> ``(libraries built, libraries found
    built)``; ``(0, 0)`` without a cache or off the card."""
    if cache is None or device.type != "cuda":
        return 0, 0
    compiles = _build.build.compiles
    names = _build.load_all(cache)
    built = _build.build.compiles - compiles
    return built, len(names) - built


@functools.lru_cache(maxsize=None)
def kernel_wrappers():
    """``{name: wrapper}`` of every hand kernel's wrapper; each counts
    its launches on the card in ``wrapper.launches`` (read only)."""
    from ..znicz import flash_attention as fa
    from ..znicz import gemm, lrn
    from ..znicz import paged_attention as pa
    return {"precise_matmul": gemm.precise_matmul,
            "quantized_matmul": gemm.quantized_matmul,
            "lrn_fwd": lrn.lrn, "lrn_bwd": lrn.lrn_backward,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv,
            "paged_attention": pa.paged_attention,
            "kv_append_int8": pa.kv_append_int8}


#: one dispatched forward at a time a process while its launches are
#: counted, so the wrappers' process-wide counters move for that batch
#: alone (two schedulers' batches share the card's stream anyway)
_LAUNCH_LOCK = threading.Lock()


# -- model adapters ----------------------------------------------------------
# One scheduler serves an exported package or a live StandardWorkflow
# (their forward chains), a pure fn(params, x) over tensors, or an
# opaque callable on numpy batches.


def _on_device(tree, device):
    """A copy of a params tree (dicts, lists, tensors, arrays) on
    ``device``: later in-place updates of the source never reach it."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on_device(v, device) for v in tree]
    return torch.as_tensor(tree).detach().to(device, copy=True)


class TorchModel:
    """A pure ``fn(params, x)`` over params held on the device once;
    each bucket's batch crosses to the device, its output back.

    ``static_batch``: the one batch size the model takes (a static-batch
    package), else None.  ``launches`` counts, by
    :func:`kernel_wrappers` name, the hand-kernel launches of the
    dispatched batches (the warmup's not), read off the wrappers'
    counters around each batch under a process-wide lock."""

    def __init__(self, fn, params, sample_shape, device=None,
                 static_batch=None):
        self._fn = fn
        self.device = resolve_device(device)
        # params live on the device once; per-dispatch host<->device
        # traffic is the padded batch and its output only
        self._params = _on_device(params, self.device)
        self.sample_shape = tuple(int(d) for d in sample_shape)
        self.static_batch = (None if static_batch is None
                             else int(static_batch))
        self.launches = {name: 0 for name in kernel_wrappers()}

    def _forward(self, xs):
        if self.static_batch is not None and \
                xs.shape[0] != self.static_batch:
            raise ValueError("a static-batch model takes %d rows, given %d"
                             % (self.static_batch, xs.shape[0]))
        with torch.no_grad():
            x = torch.from_numpy(numpy.ascontiguousarray(xs)).to(
                self.device)
            return self._fn(self._params, x).cpu().numpy()  # D2H sync

    def _run(self, xs):
        wrappers = kernel_wrappers()
        with _LAUNCH_LOCK:
            before = {name: fn.launches for name, fn in wrappers.items()}
            out = self._forward(xs)
            for name, fn in wrappers.items():
                self.launches[name] += fn.launches - before[name]
        return out

    def compile(self, bucket):
        """-> (runner, cache_hit=None), the JAX adapters' contract.
        Runs the forward once on zeros of the bucket's shape (the
        kernels build and load there, before the first request);
        nothing compiles and no cache exists, so the hit is None."""
        self._forward(numpy.zeros((int(bucket),) + self.sample_shape,
                                  numpy.float32))
        return self._run, None

    def jit_cache_size(self):
        """No eager-jit cache to miss: always 0."""
        return 0


class OpaqueModel:
    """An opaque callable ``fn(x) -> y`` on numpy batches; nothing to
    warm (the callable is never run before the first request), no
    launches counted."""

    static_batch = None
    launches = {}

    def __init__(self, fn, sample_shape=None):
        self._fn = fn
        self.sample_shape = (tuple(int(d) for d in sample_shape)
                             if sample_shape is not None else None)

    def compile(self, bucket):
        return self._fn, None

    def jit_cache_size(self):
        return None


def adapt_model(model, sample_shape=None, device=None):
    """model -> adapter with ``compile(bucket)`` + ``sample_shape``.

    Accepts a pre-built adapter, a package path or a ``PackageLoader``
    (its chain rebuilt on ``device``, its parameters copied there
    once), anything with a non-empty ``forwards`` chain (a
    StandardWorkflow: its params are copied to ``device``), or a bare
    callable.
    """
    if isinstance(model, (TorchModel, OpaqueModel)):
        return model                # pre-built adapter (tests, tools)
    if isinstance(model, str):
        model = PackageLoader(model)
    if isinstance(model, PackageLoader):
        dev = resolve_device(device)
        return TorchModel(forward_fn(model.forwards(dev)),
                          model.unit_params(), model.sample_shape,
                          device=dev, static_batch=model.static_batch)
    forwards = getattr(model, "forwards", None)
    if forwards:
        return TorchModel(forward_fn(forwards),
                          [f.params for f in forwards],
                          forwards[0].input_shape[1:], device=device)
    if callable(model):
        return OpaqueModel(model, sample_shape)
    raise TypeError("cannot serve %r: want a package path, a "
                    "PackageLoader, a workflow with forwards, a "
                    "TorchModel or OpaqueModel, or a callable" % (model,))


class _Pending:
    __slots__ = ("x", "n", "future", "enqueued", "trace", "deadline")

    def __init__(self, x, deadline=None):
        self.x = x
        self.n = int(x.shape[0])
        self.future = Future()
        self.enqueued = time.perf_counter()
        # the submitting thread's trace context (the HTTP handler's
        # request span): the dispatch worker links the batch span back
        # to every request it served
        self.trace = _trace.current()
        # absolute time.monotonic() end-to-end deadline (None = none):
        # checked at admission AND again just before batching, so work
        # that expired in the queue never reaches the executable
        self.deadline = deadline


_STOP = object()


class BucketScheduler:
    """Collect concurrent requests into padded power-of-two batches.

    ``workers`` dispatch threads pull from one queue; each drains what
    is available (continuous batching), pads to the smallest bucket
    that fits, and runs that bucket's warm runner.  ``queue_limit``
    bounds *outstanding* requests (queued + in a forming batch); beyond
    it :meth:`submit` raises :class:`SchedulerOverflow`.  ``device``
    (default: the card, raising without one) is where a workflow's
    forward runs; ``device="cpu"`` runs the kernels' plain versions.
    ``buckets`` pins the ladder (it must end at ``max_batch``); without
    it the ``serving.bucket_ladder`` site resolves it (tuner off: the
    power-of-two ladder).  ``cache``: a build cache, ``False`` for none
    (default: the configured one); ``manifest``: a warmup manifest or
    its path (default: the cache's).
    """

    def __init__(self, model, max_batch=64, queue_limit=256, workers=1,
                 max_wait=0.0, warmup=True, name="default",
                 metrics=None, sample_shape=None, cache=None,
                 manifest=None, background_warmup=None, buckets=None,
                 device=None):
        from ..autotune import dispatch as _autotune
        from ..autotune import space as _space
        from ..config import root
        self.name = name
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.queue_limit = int(queue_limit)
        self.max_wait = float(max_wait)
        self.metrics = metrics or ServingMetrics(name)
        self._adapter = adapt_model(model, sample_shape, self.device)
        self.sample_shape = self._adapter.sample_shape
        if buckets is not None:
            self.buckets = sorted({int(b) for b in buckets})
            if self.buckets[-1] != self.max_batch or self.buckets[0] < 1:
                raise ValueError(
                    "buckets %r must be >= 1 and end at max_batch %d"
                    % (buckets, self.max_batch))
            self.bucket_config = {"shape": "explicit"}
            self.config_source = "explicit"
        else:
            cfg, self.config_source = _autotune.resolve(
                "serving.bucket_ladder", "mb%d" % self.max_batch,
                default={"shape": "pow2"})
            self.buckets = _space.ladder(cfg["shape"], self.max_batch)
            self.bucket_config = dict(cfg)
        static = self._adapter.static_batch
        if static is not None:
            # a static-batch package takes one batch size: its ladder is
            # that bucket alone (the JAX scheduler ends at the same
            # ladder by dropping every bucket its artifact fails to
            # compile for); a ladder without it serves nothing
            if static not in self.buckets:
                raise ValueError(
                    "model %r takes batches of %d rows only, which the "
                    "ladder %s lacks" % (name, static, self.buckets))
            self.buckets = [static]
            self.max_batch = static
        self._executables = {}
        self._compile_seconds = 0.0     # warm-run wall seconds
        self._compiles = 0              # nvcc runs of the warmup
        self._cache_hits = 0            # kernel libraries found built
        self._compile_lock = threading.Lock()
        if cache is None:
            cache = default_cache()
        self._cache = cache or None     # cache=False forces it off
        if manifest is None:
            self._manifest = (self._cache.manifest
                              if self._cache is not None else None)
        elif isinstance(manifest, str):
            self._manifest = WarmupManifest(manifest)
        else:
            self._manifest = manifest or None
        if self._manifest is not None and self.config_source == "tuned":
            # the winner rides the warmup manifest: a restart reads back
            # the ladder it served
            self._manifest.record_config(
                self.name, "serving.bucket_ladder",
                dict(self.bucket_config, buckets=list(self.buckets)))
        if background_warmup is None:
            background_warmup = bool(root.common.compile_cache.get(
                "background_warmup", False))
        self._background_warmup = bool(background_warmup)
        self._warmup_thread = None
        self._queue = queue.Queue()     # unbounded; bound enforced below
        self._depth = 0                 # outstanding requests
        self._depth_lock = threading.Lock()
        self._closed = False
        if warmup:
            self.warmup()
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name="veles-serve-%s-%d" % (name, i))
            for i in range(max(int(workers), 1))]
        for t in self._workers:
            t.start()

    # -- warmup ---------------------------------------------------------------
    def _warmup_order(self):
        """The ladder, the manifest's recorded buckets first: a restart
        warms the shapes real traffic used before the speculative tail."""
        order = list(self.buckets)
        if self._manifest is None:
            return order
        first = [b for b in self._manifest.buckets(self.name)
                 if b in order]
        return first + [b for b in order if b not in first]

    def warmup(self, background=None):
        """Warm every bucket up front (a :class:`TorchModel` runs each
        once on zeros), so no request pays for a kernel build.

        A bucket that fails to warm fails the model, on every device: on
        the card a dropped bucket would hide a kernel that fails at one
        row count.  (The JAX scheduler drops the buckets a static-batch
        package's artifact cannot take; here that package's ladder is
        its one batch size from the start.)  With ``background`` (default: the
        ``background_warmup`` argument) the tail of the ladder warms on
        a daemon thread after the first bucket, so a server answers its
        first warm bucket before the tail finishes; a tail bucket that
        fails there emits ``serving.warmup_failed``, and its requests
        fail with the error when they reach it.
        """
        if background is None:
            background = self._background_warmup
        built, hits = warm_kernels(self._cache, self.device)
        self._compiles += built
        self._cache_hits += hits
        order = self._warmup_order()
        self._get_executable(order[0])
        pending = order[1:]
        if background and pending:
            self._warmup_thread = threading.Thread(
                target=self._warmup_tail, args=(pending,), daemon=True,
                name="veles-serve-%s-warmup" % self.name)
            self._warmup_thread.start()
            return
        for b in pending:
            self._get_executable(b)

    def _warmup_tail(self, pending):
        """Background tail: warm the rest of the ladder."""
        for b in pending:
            if self._closed:
                return
            try:
                self._get_executable(b)
            except Exception as exc:  # noqa: BLE001 — a daemon thread
                events.event("serving.warmup_failed", model=self.name,
                             bucket=b, error=str(exc)[:200])
                return

    def _get_executable(self, bucket):
        run = self._executables.get(bucket)
        if run is not None:
            return run
        with self._compile_lock:
            run = self._executables.get(bucket)
            if run is None:
                t0 = time.perf_counter()
                run, _ = self._adapter.compile(bucket)
                dt = time.perf_counter() - t0
                self._compile_seconds += dt
                self.metrics.record_compile(dt)
                self._executables[bucket] = run
                events.span("serving.compile", dt, model=self.name,
                            bucket=int(bucket), cache_hit=None)
                if self._manifest is not None:
                    self._manifest.record(self.name, bucket,
                                          self.sample_shape)
        return run

    def _bucket_for(self, rows):
        for b in self.buckets:
            if b >= rows:
                return b
        return self.buckets[-1]

    # -- request side --------------------------------------------------------
    def validate(self, x):
        """Shape-check a request batch; raises ValueError (client error)."""
        if x.ndim < 2:
            raise ValueError("input must be a batch of samples")
        if self.sample_shape is not None and \
                tuple(x.shape[1:]) != self.sample_shape:
            raise ValueError(
                "sample shape %s does not match the model's %s"
                % (list(x.shape[1:]), list(self.sample_shape)))

    def submit(self, x, deadline=None):
        """Enqueue one request batch (≤ max_batch rows) → Future of the
        output rows.  Raises SchedulerOverflow / SchedulerClosed /
        DeadlineExpired / ValueError (bad shape)."""
        x = numpy.ascontiguousarray(x, numpy.float32)
        self.validate(x)
        if x.shape[0] > self.max_batch:
            raise ValueError("request of %d rows exceeds max_batch=%d "
                             "(use infer(), which chunks)"
                             % (x.shape[0], self.max_batch))
        return self._enqueue(x, deadline)

    def _enqueue(self, x, deadline=None):
        """The validated hot path: bound check, depth accounting, queue."""
        if self._closed:
            raise SchedulerClosed("scheduler %r is shut down" % self.name)
        if deadline_expired(deadline):
            self.metrics.record_expired()
            raise DeadlineExpired(
                "deadline passed before admission to %r" % self.name)
        with self._depth_lock:
            if self._depth >= self.queue_limit:
                self.metrics.record_reject()
                raise SchedulerOverflow(
                    "queue full (%d outstanding, limit %d)"
                    % (self._depth, self.queue_limit))
            self._depth += 1
        req = _Pending(x, deadline)
        if req.trace is not None:
            _flight.record(req.trace.trace_id, "queue.enter",
                           model=self.name, rows=int(x.shape[0]))
        self._queue.put(req)
        return req.future

    def infer(self, x, timeout=None, deadline=None):
        """Blocking inference of any batch size: chunk to ≤ max_batch,
        submit, concatenate.  Returns the output as a numpy array."""
        x = numpy.ascontiguousarray(x, numpy.float32)
        self.validate(x)
        t0 = time.perf_counter()
        futures = [self._enqueue(x[i:i + self.max_batch], deadline)
                   for i in range(0, x.shape[0], self.max_batch)]
        try:
            parts = [f.result(timeout) for f in futures]
        except Exception:
            self.metrics.record_request(
                x.shape[0], time.perf_counter() - t0, ok=False)
            raise
        out = parts[0] if len(parts) == 1 else numpy.concatenate(parts)
        self.metrics.record_request(x.shape[0], time.perf_counter() - t0)
        return out

    # -- dispatch side -------------------------------------------------------
    def _take_next(self, deadline):
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            if deadline is None:
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                return self._queue.get(timeout=remaining)
            except queue.Empty:
                return None

    def _worker_loop(self):
        carry = None
        while True:
            req = carry if carry is not None else self._queue.get()
            carry = None
            if req is _STOP:
                return
            batch, rows = [req], req.n
            # optional linger (off by default): continuous batching
            # self-clocks under load — while this batch runs, the next
            # accumulates — so waiting only ever adds latency
            deadline = (time.monotonic() + self.max_wait
                        if self.max_wait > 0 else None)
            while rows < self.max_batch:
                nxt = self._take_next(deadline)
                if nxt is None:
                    break
                if nxt is _STOP:
                    carry = _STOP
                    break
                if rows + nxt.n > self.max_batch:
                    carry = nxt     # starts the next batch
                    break
                batch.append(nxt)
                rows += nxt.n
            self._execute(batch, rows)

    def _execute(self, batch, rows):
        # pre-batch deadline check: a request that expired while queued
        # is shed HERE — it never occupies a bucket row or device time
        now = time.monotonic()
        expired = [r for r in batch if deadline_expired(r.deadline, now)]
        if expired:
            exc = DeadlineExpired("deadline passed in queue")
            for r in expired:
                self.metrics.record_expired()
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
                rows -= r.n
            self._release(len(expired))
            batch = [r for r in batch if r not in expired]
            if not batch:
                return
        t0 = time.perf_counter()
        try:
            bucket = self._bucket_for(rows)
            run = self._executables.get(bucket) or \
                self._get_executable(bucket)
            if len(batch) == 1 and batch[0].n == bucket:
                xs = batch[0].x
            else:
                parts = [r.x for r in batch]
                if bucket > rows:
                    parts.append(numpy.zeros(
                        (bucket - rows,) + batch[0].x.shape[1:],
                        numpy.float32))
                xs = numpy.concatenate(parts)
            out = numpy.asarray(run(xs))
        except Exception as exc:
            for r in batch:
                if not r.future.set_running_or_notify_cancel():
                    continue
                r.future.set_exception(exc)
            self._release(len(batch))
            return
        off = 0
        for r in batch:
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(out[off:off + r.n])
            off += r.n
        self._release(len(batch))
        dt = time.perf_counter() - t0
        # request span ids riding this batch (bounded: a full 64-batch
        # of tiny requests must not bloat every span record)
        links = [r.trace.span_id for r in batch
                 if r.trace is not None][:16] or None
        # per-request flight share: batch cost split by row count, so
        # co-batched requests attribute the device time fairly
        for r in batch:
            if r.trace is not None:
                _flight.record(r.trace.trace_id, "queue.admit",
                               bucket=int(bucket))
                _flight.record(r.trace.trace_id, "batch.execute",
                               seconds=round(dt * r.n / max(rows, 1),
                                             6),
                               bucket=int(bucket), rows=int(rows))
        self.metrics.record_batch(bucket, rows, dt, len(batch),
                                  links=links)

    def _release(self, n):
        with self._depth_lock:
            self._depth -= n

    # -- lifecycle / introspection -------------------------------------------
    def close(self, drain=True, timeout=10.0):
        """Stop accepting requests; by default finish everything queued
        (graceful drain), then stop the dispatch workers."""
        if self._closed:
            return
        self._closed = True
        if not drain:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is _STOP:
                    continue
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(
                        SchedulerClosed("scheduler shut down"))
                self._release(1)
        for _ in self._workers:
            self._queue.put(_STOP)
        for t in self._workers:
            t.join(timeout)
        # a submit that raced the closed flag could still be queued with
        # no worker left to serve it — fail it rather than hang its client
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _STOP:
                continue
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    SchedulerClosed("scheduler shut down"))
            self._release(1)

    @property
    def queue_depth(self):
        return self._depth

    @property
    def ready(self):
        """True once the warmup ladder is fully warm (background tail
        included) and the scheduler is accepting — the signal
        behind ``GET /readyz`` and fleet-router admission."""
        if self._closed or not self._executables:
            return False
        t = self._warmup_thread
        return t is None or not t.is_alive()

    def load(self):
        """Cheap backpressure snapshot for routers: no locks beyond
        int reads, safe to poll at high frequency."""
        depth = self._depth
        return {"kind": "bucket",
                "queue_depth": depth,
                "queue_limit": self.queue_limit,
                "utilization": round(depth / self.queue_limit, 4)}

    def retry_after_s(self, cap=30):
        """Seconds until the current backlog plausibly drains: queued
        batches ahead x the recent per-batch wall time, spread over the
        dispatch workers.  The shed response's ``Retry-After`` — a
        computed hint instead of the old hardcoded ``1``."""
        batch_p50 = self.metrics.batch_latency.summary().get("p50_ms")
        if not batch_p50:
            return 1
        batches_ahead = -(-self._depth // self.max_batch)  # ceil
        est = batches_ahead * (batch_p50 / 1e3) / len(self._workers)
        return max(1, min(int(cap), int(est + 0.999)))

    def join_warmup(self, timeout=None):
        """Block until a background warmup tail finishes (no-op when
        warmup was synchronous).  Returns True when nothing is left
        warming."""
        t = self._warmup_thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    def stats(self):
        """Warm-bucket accounting.  ``executables`` counts the warmed
        buckets; ``compiles`` the ``nvcc`` runs of the warmup against a
        build cache (a warm restart: 0) and ``cache_hits`` the kernel
        libraries it found built (both 0 without a cache or off the
        card); every build happens in the warmup, so
        ``warmup_compiles`` is ``compiles`` and ``post_warmup_compiles``
        0.  ``compile_seconds`` is the warm runs' wall time.
        ``kernel_launches``: the hand kernels' launches of the dispatched
        batches by wrapper (:class:`TorchModel`; ``{}`` for an opaque
        callable; 0 off the card)."""
        return {
            "buckets": list(self.buckets),
            "bucket_config": dict(self.bucket_config,
                                  config_source=self.config_source),
            "executables": len(self._executables),
            "compiles": self._compiles,
            "cache_hits": self._cache_hits,
            "compile_seconds": round(self._compile_seconds, 4),
            "warmup_compiles": self._compiles,
            "post_warmup_compiles": 0,
            "warming": (self._warmup_thread.is_alive()
                        if self._warmup_thread is not None else False),
            "jit_cache_size": self._adapter.jit_cache_size(),
            "kernel_launches": dict(self._adapter.launches),
            "queue_depth": self._depth,
            "queue_limit": self.queue_limit,
            "max_batch": self.max_batch,
            "workers": len(self._workers),
            "device": str(self.device),
            "ready": self.ready,
            "closed": self._closed,
        }
