"""Snapshotter: periodic whole-workflow snapshots and resume.

The port of ``veles_tpu/snapshotter.py`` (a re-design of the
reference's SnapshotterToFile, veles/snapshotter.py:360-426: a pickle
of the whole workflow, compressed none/gz/bz2/xz, with a
``<prefix>_current`` symlink; throttling :159-175; size diagnostics
:203-226; restore :522-535).  A snapshot carries no device: every
``memory.Array`` pulls its device value to the host in
``__getstate__``, a unit's other device tensors reach the pickle as
host tensors (``Pickleable.__getstate__``, the GD units' solver state
as numpy), and the fused step's parameters and solver state are synced
into the units first, so a snapshot restores into either execution
mode on any device.

Every shot is split into

- a **capture phase** on the training thread: sync the fused step's
  weights and solver state into the units (the only part that must see
  a quiescent step) and deep-copy the workflow's picklable state (the
  ``Pickleable.__getstate__`` machinery pickle uses, so ``*_`` state
  and ``transient_`` wrappers are dropped alike); then training goes
  on; and
- a **durable-write phase** on one writer thread
  (:class:`SnapshotWriter`): pickle + compression + ``*.tmp`` write +
  fsync + atomic ``os.rename`` + the ``_current`` symlink flip (or the
  SQLite insert of :class:`SnapshotterToDB`).

The writer's queue coalesces periodic shots (drop-oldest: at most one
periodic shot is pending) and never drops improvement shots; a writer
exception re-raises on the next :meth:`SnapshotterBase.run`; the end of
a run flushes and joins the writer.  ``root.common.snapshot.async_write
= False`` (or ``async_write=False`` per unit) is the synchronous path,
atomic too.  A capture that fails (an object ``deepcopy`` refuses)
falls back to the synchronous write of the live workflow, logged.

The port runs one process until ``parallel/`` lands (ROADMAP queue A
item 11), so :func:`_writer_process` is True; the hook stays for the
multi-process skip.

The best metric lands in the file name, e.g.
``mnist_validation_1.48.4.pickle.gz``.
"""

import bz2
import collections
import copy
import gzip
import lzma
import os
import pickle
import threading
import time
import weakref

from .config import root
from .logger import Logger, events
from .mutable import Bool
from .observability.registry import REGISTRY
from .registry import MappedObjectsRegistry, UnitRegistry
from .result_provider import IResultProvider
from .units import Unit

__all__ = ["CODECS", "DECODERS", "SnapshotWriter", "SnapshotterRegistry",
           "SnapshotterBase", "SnapshotterToFile", "SnapshotterToDB",
           "restore"]

#: compression -> (fileobj, level) codec factory + file name extension
CODECS = {
    None: (lambda f, lvl: f, ""),
    "": (lambda f, lvl: f, ""),
    "gz": (lambda f, lvl: gzip.GzipFile(fileobj=f, mode="wb",
                                        compresslevel=lvl), ".gz"),
    "bz2": (lambda f, lvl: bz2.BZ2File(f, "wb",
                                       compresslevel=max(lvl, 1)), ".bz2"),
    "xz": (lambda f, lvl: lzma.LZMAFile(f, "wb", preset=lvl), ".xz"),
}

DECODERS = {
    ".gz": gzip.open,
    ".bz2": bz2.open,
    ".xz": lzma.open,
    ".pickle": open,
}

#: how long blocked writer waits sleep before re-checking stop/failure
_POLL_S = 0.05

_is_writer_process = None
_scalars_atomic = False


def _register_atomic_scalars():
    """Teach ``copy.deepcopy`` that numpy number/bool scalars are
    immutable, shared into the copy like Python's int instead of boxed
    again one by one (the loader's label lists hold thousands of
    them).  Registered with ``setdefault`` (user overrides win) and only
    for scalar types that are immutable (``numpy.void`` is not)."""
    global _scalars_atomic
    if _scalars_atomic:
        return
    try:
        import numpy
        atomic = copy._deepcopy_atomic
        for t in set(numpy.sctypeDict.values()):
            if isinstance(t, type) and \
                    issubclass(t, (numpy.number, numpy.bool_)):
                copy._deepcopy_dispatch.setdefault(t, atomic)
    except Exception:  # noqa: BLE001 — an optimization, never a failure
        pass
    _scalars_atomic = True


def _writer_process():
    """True on the one process that writes snapshots.  The port runs
    one process (ROADMAP queue A item 11 brings ranks), so always True
    unless a caller sets ``_is_writer_process``."""
    global _is_writer_process
    if _is_writer_process is None:
        _is_writer_process = True
    return _is_writer_process


class _WriteJob:
    __slots__ = ("fn", "improved", "label")

    def __init__(self, fn, improved, label):
        self.fn = fn
        self.improved = improved
        self.label = label


def _writer_main(ref, stop_evt):
    """Writer thread entry.  Holds only a weak reference between jobs,
    so an abandoned snapshotter stays collectable."""
    while True:
        self = ref()
        if self is None:
            return
        if not self._work_once():
            del self
            if stop_evt.wait(_POLL_S):
                return


class SnapshotWriter:
    """One background thread owning the durable-write phase.

    The queue is depth-1 for periodic shots: a new periodic shot
    replaces a pending one (drop-oldest: the newest weights are the
    useful ones), while improvement shots are never dropped (at most
    one per validation epoch).  A job's exception parks the writer and
    is handed back by :meth:`take_failure` (the snapshotter raises it on
    its next run); the rest of the queue is retried when the writer
    restarts on the next submit.
    """

    def __init__(self, name="snapshot", registry=None):
        self.name = name
        self._jobs = collections.deque()
        self._lock = threading.Lock()
        self._busy = False
        self._thread = None
        self._stop_evt = threading.Event()
        self._failure = None
        self.written = 0
        self.coalesced = 0
        reg = registry or REGISTRY
        lbl = {"snapshotter": name}
        self._g_queue = reg.gauge(
            "veles_snapshot_writer_queue",
            "Snapshot write jobs queued behind the writer thread",
            ("snapshotter",)).labels(**lbl)
        self._c_coalesced = reg.counter(
            "veles_snapshot_coalesced_total",
            "Periodic snapshots dropped by drop-oldest queue coalescing",
            ("snapshotter",)).labels(**lbl)

    # -- producer side (training thread) -------------------------------------
    def submit(self, fn, improved=False, label=None):
        """Enqueue one durable-write job and return at once."""
        with self._lock:
            if not improved:
                for i in range(len(self._jobs)):
                    if not self._jobs[i].improved:
                        del self._jobs[i]
                        self.coalesced += 1
                        self._c_coalesced.inc()
                        break
            self._jobs.append(_WriteJob(fn, improved, label))
            self._g_queue.set(len(self._jobs))
            self._ensure_thread()

    def _ensure_thread(self):
        # caller holds self._lock
        t = self._thread
        if t is not None and t.is_alive():
            return
        if self._failure is not None:
            return  # parked until take_failure() delivers the exception
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=_writer_main,
            args=(weakref.ref(self), self._stop_evt), daemon=True,
            name="veles-snapwriter-%s" % self.name)
        self._thread.start()

    # -- consumer side (writer thread) ---------------------------------------
    def _work_once(self):
        """Run one queued job; False when the queue was empty."""
        with self._lock:
            if not self._jobs:
                return False
            job = self._jobs.popleft()
            self._busy = True
            self._g_queue.set(len(self._jobs))
        try:
            job.fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised at run()
            with self._lock:
                self._failure = exc
                self._busy = False
            return False
        with self._lock:
            self._busy = False
            self.written += 1
        return True

    # -- lifecycle -----------------------------------------------------------
    def flush(self, timeout=60.0):
        """Block until every queued job is durably done (True), or the
        writer failed or the timeout expired (False)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._failure is not None:
                    return False
                if not self._jobs and not self._busy:
                    return True
                self._ensure_thread()
            time.sleep(0.01)
        return False

    def stop(self, timeout=60.0):
        """Flush, then join the thread; the writer restarts on the next
        submit."""
        ok = self.flush(timeout)
        self._stop_evt.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10)
        with self._lock:
            self._thread = None
        return ok

    def take_failure(self):
        """Pop the stored writer exception (or None); popping un-parks
        the writer, so the rest of the queue is retried on the next
        submit."""
        with self._lock:
            exc, self._failure = self._failure, None
            return exc

    def stats(self):
        with self._lock:
            return {"written": self.written,
                    "coalesced": self.coalesced,
                    "queued": len(self._jobs),
                    "busy": self._busy}


class SnapshotterRegistry(UnitRegistry, MappedObjectsRegistry):
    """Units that are also a string-keyed family ("file", "db", ...)."""


class SnapshotterBase(Unit, IResultProvider, Logger,
                      metaclass=SnapshotterRegistry):
    """Base: throttling and the gate protocol (runs when the decision
    has improved and validation has ended, unless ``skip``)."""

    mapping = "snapshotter"
    hide_from_registry = True

    #: the pickle backends write on the writer process only; sharded
    #: checkpoints (checkpoint/snapshot.py) write on every process
    WRITES_ON_ALL_PROCESSES = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.prefix = kwargs.get("prefix", "wf")
        self.interval = kwargs.get("interval", 1)     # epochs between shots
        self.time_interval = kwargs.get("time_interval", 15)  # seconds
        self.compression = kwargs.get("compression", "gz")
        # None = follow the root.common.snapshot.* config defaults
        self.async_write = kwargs.get("async_write")
        self.compression_level = kwargs.get("compression_level")
        self.report_size_threshold = kwargs.get("report_size_threshold")
        self.suffix = None
        self.destination = None
        self.skip = Bool(False)
        self.decision = None
        self._counter = 0
        self._last_exported_best = None
        self.stall_s = 0.0        # cumulative training-thread stall
        self.last_stall_s = 0.0

    def init_unpickled(self):
        super().init_unpickled()
        # monotonic-clock bookkeeping from another process means
        # nothing here: the first shot after a restore is not throttled
        self._last_time_ = None

    def link_decision(self, decision):
        """Wire a decision: improved-model snapshots carry the best
        validation metric in the file name (``validation_1.48``) and
        bypass the time throttle (never the ``interval`` counter)."""
        self.decision = decision
        return self

    def _decision_best(self):
        d = self.decision
        return (getattr(d, "best_n_err_pt", None),
                getattr(d, "best_rmse", None),
                getattr(d, "best_epoch", None))

    def _decision_suffix(self):
        best_pt, best_rmse, _ = self._decision_best()
        if best_pt is not None:
            return "validation_%.2f" % best_pt
        if best_rmse is not None:
            return "validation_%.4f" % best_rmse
        return None

    def _fresh_improvement(self):
        """Edge-triggered improvement: ``improved`` stays True for an
        epoch after a validation win, so compare the current best with
        the best at the last export instead of reading the level."""
        d = self.decision
        if d is None or not bool(d.improved):
            return False
        return self._decision_best() != self._last_exported_best

    # -- config-or-kwarg knobs ----------------------------------------------
    def _async_enabled(self):
        v = self.async_write
        if v is None:
            v = root.common.snapshot.get("async_write", True)
        return bool(v)

    def _compression_level(self):
        lvl = self.compression_level
        if lvl is None:
            lvl = root.common.snapshot.get("compression_level", 6)
        return max(0, min(9, int(lvl)))

    # -- writer / metrics plumbing (transient, recreated lazily) -------------
    def _get_writer(self):
        w = getattr(self, "_writer_", None)
        if w is None:
            w = self._writer_ = SnapshotWriter(name=self.prefix)
        return w

    def _obs(self):
        m = getattr(self, "_obs_", None)
        if m is None:
            lbl = {"snapshotter": self.prefix}
            m = self._obs_ = {
                "stall": REGISTRY.counter(
                    "veles_snapshot_stall_seconds_total",
                    "Training-thread seconds stalled per snapshot "
                    "(capture + submit; the full write when synchronous)",
                    ("snapshotter",)).labels(**lbl),
                "bytes": REGISTRY.counter(
                    "veles_snapshot_bytes_written_total",
                    "Snapshot bytes durably written",
                    ("snapshotter",)).labels(**lbl),
                "written": REGISTRY.counter(
                    "veles_snapshots_written_total",
                    "Snapshots durably written",
                    ("snapshotter",)).labels(**lbl),
            }
        return m

    def _sync_step(self):
        """Pull the fused step's parameters and solver state into the
        units (the only part that must see a quiescent step)."""
        fused = getattr(self.workflow, "fused_step", None)
        if fused is not None:
            fused.sync_weights()
            fused.sync_solver_state()

    def _capture(self, target):
        """Capture phase: deep-copy the workflow's picklable state on
        the training thread (the ``Pickleable.__getstate__`` machinery:
        ``*_`` state dropped, Arrays on the host), so the writer thread
        serializes a frozen twin while training mutates the original.
        None (the synchronous fallback) when the copy fails."""
        _register_atomic_scalars()
        t0 = time.perf_counter()
        try:
            snapshot = copy.deepcopy(target)
        except Exception as exc:  # noqa: BLE001 — never lose a shot
            self.warning(
                "snapshot capture failed (%s: %s); falling back to a "
                "synchronous write", type(exc).__name__, exc)
            return None
        events.span("snapshot.capture", time.perf_counter() - t0,
                    snapshotter=self.prefix)
        return snapshot

    def run(self):
        w = getattr(self, "_writer_", None)
        if w is not None:
            exc = w.take_failure()
            if exc is not None:
                raise exc
        if bool(self.skip):
            return
        self._counter += 1
        if self._counter % max(self.interval, 1):
            return
        fresh = self._fresh_improvement()
        # the monotonic clock: a wall-clock step never suppresses (or
        # forces) a shot
        last = self._last_time_
        if not fresh and last is not None and \
                time.monotonic() - last < self.time_interval:
            return
        self._last_time_ = time.monotonic()
        if fresh:
            # the suffix names the metric these weights achieved; a later
            # periodic shot has trained past it, so it clears the suffix
            self.suffix = self._decision_suffix()
            self._last_exported_best = self._decision_best()
        elif self.decision is not None:
            self.suffix = None
        if not (_writer_process() or self.WRITES_ON_ALL_PROCESSES):
            # another process owns the shared file system: keep the same
            # throttle state, write nothing
            return
        self._exporting_improvement_ = fresh
        t0 = time.perf_counter()
        try:
            self.export()
        finally:
            self._exporting_improvement_ = False
            stall = time.perf_counter() - t0
            self.last_stall_s = stall
            self.stall_s += stall
            self._obs()["stall"].inc(stall)

    def export(self):
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------
    def flush(self, timeout=60.0):
        """Block until every queued snapshot is durably written."""
        w = getattr(self, "_writer_", None)
        return w.flush(timeout) if w is not None else True

    def stop(self):
        """The workflow finished: flush and join the writer, so no
        thread (and no queued shot) outlives ``Workflow.run()``."""
        w = getattr(self, "_writer_", None)
        if w is None:
            return
        if not w.stop():
            self.error("snapshot writer did not drain cleanly at "
                       "workflow finish: %s", w.stats())

    def writer_stats(self):
        w = getattr(self, "_writer_", None)
        return w.stats() if w is not None else None

    def get_metric_values(self):
        """The last snapshot's path (``result.get("Snapshot")``)."""
        return {"Snapshot": self.destination}


class SnapshotterToFile(SnapshotterBase):
    """Pickle the whole workflow to disk with a ``_current`` symlink."""

    MAPPING = "file"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.directory = kwargs.get(
            "directory", os.path.expanduser(
                root.common.dirs.get("snapshots", ".")))

    def export(self):
        os.makedirs(self.directory, exist_ok=True)
        target = self.workflow
        self._sync_step()
        name = "%s%s.%d.pickle" % (
            self.prefix, ("_" + self.suffix) if self.suffix else "",
            self._counter)
        path = os.path.join(
            self.directory, name + CODECS[self.compression or None][1])
        payload = self._capture(target) if self._async_enabled() else None
        if payload is None:
            self._write_file(target, path)
        else:
            self._get_writer().submit(
                lambda: self._write_file(payload, path),
                improved=bool(getattr(self, "_exporting_improvement_",
                                      False)),
                label=name)
        self.destination = path
        return path

    def _write_file(self, obj, path):
        """Durable-write phase (the writer thread; inline when
        synchronous): pickle and compress into ``<path>.tmp``, fsync,
        rename, then flip ``_current``; a kill at any point leaves the
        old snapshots intact or the new file complete."""
        t0 = time.perf_counter()
        codec, _ = CODECS[self.compression or None]
        tmp = path + ".tmp"
        with open(tmp, "wb") as raw:
            stream = codec(raw, self._compression_level())
            try:
                pickle.dump(obj, stream,
                            protocol=pickle.HIGHEST_PROTOCOL)
            finally:
                if stream is not raw:
                    stream.close()
            raw.flush()
            os.fsync(raw.fileno())
        os.replace(tmp, path)
        self._fsync_dir()
        self._flip_current(path)
        size = os.path.getsize(path)
        obs = self._obs()
        obs["bytes"].inc(size)
        obs["written"].inc()
        self.last_write_s = time.perf_counter() - t0
        events.span("snapshot.write", self.last_write_s,
                    snapshotter=self.prefix, path=path, bytes=size)
        # the diagnostic pickles every unit again: only past the threshold
        threshold = self._size_threshold()
        if threshold > 0 and size >= threshold:
            self._report_size(path, size, obj)
        return path

    def _size_threshold(self):
        threshold = self.report_size_threshold
        if threshold is None:
            threshold = root.common.snapshot.get(
                "report_size_threshold", 64 << 20)
        return int(threshold)

    def _fsync_dir(self):
        try:
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _flip_current(self, path):
        """Repoint ``<prefix>_current`` atomically: a new symlink beside
        it renamed over, so readers never see a missing link."""
        link = os.path.join(self.directory, "%s_current" % self.prefix)
        tmp_link = link + ".tmp"
        try:
            if os.path.lexists(tmp_link):
                os.remove(tmp_link)
            os.symlink(os.path.basename(path), tmp_link)
            os.replace(tmp_link, link)
        except OSError:
            pass

    def _report_size(self, path, size, workflow, top=5):
        """The fattest units (reference snapshotter.py:203-226); runs on
        the writer thread in async mode."""
        sizes = []
        for unit in workflow:
            try:
                sizes.append((len(pickle.dumps(unit, -1)), unit.name))
            except Exception:  # noqa: BLE001 — diagnostics never raise
                pass
        lines = ["  %-30s %.1f MiB" % (name, sz / 1048576)
                 for sz, name in sorted(sizes, reverse=True)[:top]]
        self.warning("snapshot %s is %.1f MiB; fattest units:\n%s",
                     path, size / 1048576, "\n".join(lines))

    @staticmethod
    def import_file(path):
        """Load a snapshot back into its workflow (reference
        snapshotter.py:522-535); a sharded checkpoint directory goes to
        its own importer."""
        path = os.path.realpath(os.path.expanduser(path))
        if os.path.isdir(path):
            from .checkpoint import import_dir
            return import_dir(path)
        ext = os.path.splitext(path)[1]
        opener = DECODERS.get(ext, open)
        with opener(path, "rb") as f:
            wf = pickle.load(f)
        wf._restored_from_snapshot = True
        return wf


class SnapshotterToDB(SnapshotterBase):
    """Snapshots into a SQLite database (the reference's
    SnapshotterToDB, snapshotter.py:428-520, used ODBC): the same pickle
    blobs, a queryable history, one file.  The async path uses the
    file snapshotter's single writer thread, so database access is
    serialized."""

    MAPPING = "db"

    SCHEMA = ("CREATE TABLE IF NOT EXISTS snapshots ("
              "id INTEGER PRIMARY KEY AUTOINCREMENT, "
              "prefix TEXT, suffix TEXT, counter INTEGER, "
              "timestamp REAL, blob BLOB)")

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.database = kwargs.get("database") or os.path.join(
            os.path.expanduser(root.common.dirs.get("snapshots", ".")),
            "snapshots.sqlite3")

    def export(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.database)),
                    exist_ok=True)
        target = self.workflow
        self._sync_step()
        # the wall clock on purpose: a history column, not a throttle
        row = (self.prefix, self.suffix, self._counter, time.time())
        payload = self._capture(target) if self._async_enabled() else None
        if payload is None:
            self._write_db(target, row)
        else:
            self._get_writer().submit(
                lambda: self._write_db(payload, row),
                improved=bool(getattr(self, "_exporting_improvement_",
                                      False)),
                label="%s.%d" % (self.prefix, self._counter))
        self.destination = "sqlite://%s#%s" % (self.database, self.prefix)
        return self.destination

    def _write_db(self, obj, row):
        import sqlite3
        t0 = time.perf_counter()
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        with sqlite3.connect(self.database) as conn:
            conn.execute(self.SCHEMA)
            conn.execute(
                "INSERT INTO snapshots (prefix, suffix, counter, "
                "timestamp, blob) VALUES (?, ?, ?, ?, ?)",
                row + (sqlite3.Binary(blob),))
        obs = self._obs()
        obs["bytes"].inc(len(blob))
        obs["written"].inc()
        self.last_write_s = time.perf_counter() - t0
        events.span("snapshot.write", self.last_write_s,
                    snapshotter=self.prefix, database=self.database,
                    bytes=len(blob))

    @staticmethod
    def import_db(uri):
        """``sqlite://<path>[#prefix]`` -> the newest matching
        snapshot."""
        import sqlite3
        body = uri[len("sqlite://"):]
        path, _, prefix = body.partition("#")
        if not os.path.exists(path):
            # connect() would create an empty database at a mistyped path
            raise ValueError("no such snapshot database: %s" % path)
        with sqlite3.connect(path) as conn:
            if prefix:
                row = conn.execute(
                    "SELECT blob FROM snapshots WHERE prefix = ? "
                    "ORDER BY id DESC LIMIT 1", (prefix,)).fetchone()
            else:
                row = conn.execute(
                    "SELECT blob FROM snapshots "
                    "ORDER BY id DESC LIMIT 1").fetchone()
        if row is None:
            raise ValueError("no snapshot in %s" % uri)
        wf = pickle.loads(row[0])
        wf._restored_from_snapshot = True
        return wf


def restore(path):
    """The resume entry: the restored, uninitialized workflow; call
    ``.initialize(device=...)`` (no device: the card) and ``.run()``.

    Sources (reference __main__.py:539-589): a snapshot file, a sharded
    checkpoint directory (or its root, ``_current`` link or
    ``manifest.json``), ``sqlite://db.sqlite3[#prefix]``, or an
    ``http(s)://`` URL (fetched to a temporary file first)."""
    if path.startswith("sqlite://"):
        return SnapshotterToDB.import_db(path)
    if path.startswith(("http://", "https://")):
        import tempfile
        import urllib.request
        suffix = os.path.splitext(path)[1] or ".pickle"
        fd, tmp = tempfile.mkstemp(suffix=suffix)
        os.close(fd)
        try:
            urllib.request.urlretrieve(path, tmp)
            return SnapshotterToFile.import_file(tmp)
        finally:
            os.unlink(tmp)
    real = os.path.realpath(os.path.expanduser(path))
    if os.path.isdir(real) or os.path.basename(real) == "manifest.json":
        from .checkpoint import import_dir
        return import_dir(path)
    return SnapshotterToFile.import_file(path)
