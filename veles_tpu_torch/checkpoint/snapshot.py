"""Sharded, content-addressed checkpoints of workflows and objects.

The port of ``veles_tpu/checkpoint/snapshot.py``.  Layout under one
root (``directory``)::

    chunks/<sha256>.chunk            content-addressed tensor chunks,
                                     shared by ALL checkpoints (dedupe)
    <prefix>[_suffix].<n>.ckpt/      one complete checkpoint
        manifest.json                tensors -> chunk lists
        topology.pickle.gz           the workflow's (or object's)
                                     pickle, tensors replaced by
                                     references
    <prefix>_current                 symlink to the newest complete dir

:class:`SnapshotterToShards` keeps the snapshotter's capture / writer
split: the training thread deep-copies the workflow inside an
:func:`~.tensors.extracting` context, so each large tensor is copied
to the host once, into the sink, and returns; the writer thread chunks,
hashes and fsyncs the tensors, writes the manifest and the topology
into ``*.ckpt.tmp``, renames the directory into place and flips
``_current``.  A kill at any point leaves the previous checkpoints
intact or the new directory complete, never a torn checkpoint at a
listed name; partials left by a kill are quarantined when the next
snapshotter starts (:func:`quarantine_partials`).  :func:`import_dir`
restores a workflow with every tensor assembled on the host.

The port runs one process until ``parallel/`` lands (ROADMAP queue A
item 11): :func:`_proc` is ``(0, 1)``, and the multi-process fragments
(``part-<k>.json``, :meth:`SnapshotterToShards._merge_parts`) wait for
it, as does the reference's ``TensorReader.restore_array`` (a sharded
restore onto a mesh).

:func:`save_state` / :func:`load_state` checkpoint any picklable object
the same way (the decode scheduler's ``checkpoint_kv`` / ``restore_kv``
and its session spill).  Each save and restore records
``checkpoint.save`` / ``checkpoint.restore`` spans on the event log and
the ``veles_checkpoint_*`` counters on the metrics registry, as the
reference does.
"""

import gzip
import os
import shutil
import time

from ..config import root
from ..logger import events
from ..observability.registry import REGISTRY
from ..snapshotter import SnapshotterBase
from .manifest import (CHUNKS_DIR, CKPT_SUFFIX, MANIFEST, TOPOLOGY,
                       Manifest, list_checkpoints)
from .store import ChunkStore
from .tensors import (ResolvingUnpickler, TensorReader, TensorSink,
                      dumps_extracting, extracting, restoring,
                      write_tensors)

__all__ = ["save_state", "load_state", "open_checkpoint",
           "resolve_checkpoint", "delete_checkpoint", "is_shard_checkpoint",
           "quarantine_partials", "import_dir", "SnapshotterToShards"]

_PARTS_SUFFIX = ".parts"
_PART_WAIT_S = 120.0

_metrics = None


def _obs():
    global _metrics
    if _metrics is None:
        _metrics = {
            "bytes": REGISTRY.counter(
                "veles_checkpoint_bytes_written_total",
                "New (non-deduplicated) chunk bytes durably written"),
            "deduped": REGISTRY.counter(
                "veles_checkpoint_chunks_deduped_total",
                "Chunks skipped because identical content was already "
                "stored (cross-checkpoint dedupe hits)"),
            "seconds": REGISTRY.counter(
                "veles_checkpoint_seconds_total",
                "Wall seconds spent in checkpoint save/restore",
                ("op",)),
        }
    return _metrics


def _proc():
    """(process index, process count): one process until the port's
    ``parallel/`` lands (ROADMAP queue A item 11)."""
    return 0, 1


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def quarantine_partials(directory):
    """Rename the ``*.ckpt.tmp`` / ``*.ckpt.parts`` partials of a
    crashed save aside (``.quarantine``), so they never shadow a
    complete checkpoint and the evidence survives.  Returns the new
    paths."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.endswith(CKPT_SUFFIX + ".tmp") or
                name.endswith(CKPT_SUFFIX + _PARTS_SUFFIX)):
            continue
        src = os.path.join(directory, name)
        dst = src + ".quarantine"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = "%s.quarantine.%d" % (src, n)
        try:
            os.replace(src, dst)
            out.append(dst)
        except OSError:
            continue
    return out


def resolve_checkpoint(path):
    """Accepts a checkpoint dir, its ``manifest.json``, a ``_current``
    symlink, or a root (→ ``_current``, else the newest complete
    checkpoint); returns the checkpoint dir."""
    real = os.path.realpath(os.path.expanduser(path))
    if os.path.isfile(real):
        if os.path.basename(real) == MANIFEST:
            return os.path.dirname(real)
        raise ValueError("%s is not a sharded checkpoint" % path)
    if real.endswith(CKPT_SUFFIX) and \
            os.path.exists(os.path.join(real, MANIFEST)):
        return real
    try:
        names = os.listdir(real)
    except OSError:
        raise ValueError("no such checkpoint: %s" % path)
    for name in sorted(names):
        if name.endswith("_current"):
            target = os.path.realpath(os.path.join(real, name))
            if os.path.exists(os.path.join(target, MANIFEST)):
                return target
    ckpts = list_checkpoints(real)
    if ckpts:
        return ckpts[-1]
    raise ValueError("no complete sharded checkpoint under %s" % path)


def is_shard_checkpoint(path):
    """True when ``path`` resolves to a sharded checkpoint dir."""
    try:
        resolve_checkpoint(path)
        return True
    except (ValueError, OSError):
        return False


def open_checkpoint(path):
    """(ckpt_dir, Manifest, TensorReader) for inspection or restore."""
    ckpt = resolve_checkpoint(path)
    man = Manifest.load_dir(ckpt)
    store = ChunkStore(os.path.join(os.path.dirname(ckpt), CHUNKS_DIR))
    return ckpt, man, TensorReader(store, man)


def _load_topology(path):
    """(object, ckpt dir, seconds) of the checkpoint at ``path``, every
    tensor resolved on the host."""
    ckpt, man, reader = open_checkpoint(path)
    t0 = time.perf_counter()
    with restoring(reader):
        with gzip.open(os.path.join(ckpt, TOPOLOGY), "rb") as f:
            obj = ResolvingUnpickler(f, reader).load()
    dt = time.perf_counter() - t0
    _obs()["seconds"].labels(op="restore").inc(dt)
    events.span("checkpoint.restore", dt, path=ckpt,
                tensors=len(man.tensors), bytes=reader.bytes_read)
    return obj


def import_dir(path):
    """Load a sharded checkpoint back into its workflow (the mirror of
    ``SnapshotterToFile.import_file``)."""
    wf = _load_topology(path)
    wf._restored_from_snapshot = True
    return wf


class SnapshotterToShards(SnapshotterBase):
    """Sharded content-addressed checkpoints behind the snapshotter's
    capture / writer split.  ``root.common.snapshot.format = "shards"``
    (or ``snapshotter={"format": "shards"}``) chooses it."""

    MAPPING = "shards"
    #: every process writes its own tensors (the pickle backends write
    #: on the writer process only)
    WRITES_ON_ALL_PROCESSES = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.directory = kwargs.get(
            "directory", os.path.expanduser(
                root.common.dirs.get("snapshots", ".")))
        # None = follow root.common.snapshot.* defaults
        self.chunk_bytes = kwargs.get("chunk_bytes")
        self.min_tensor_bytes = kwargs.get("min_tensor_bytes")
        quarantine_partials(self.directory)

    def _chunk_bytes(self):
        v = self.chunk_bytes
        if v is None:
            v = root.common.snapshot.get("chunk_bytes", 16 << 20)
        return max(int(v), 4096)

    def _min_tensor_bytes(self):
        v = self.min_tensor_bytes
        if v is None:
            v = root.common.snapshot.get("min_tensor_bytes", 65536)
        return max(int(v), 1)

    def export(self):
        os.makedirs(self.directory, exist_ok=True)
        target = self.workflow
        self._sync_step()
        name = "%s%s.%d%s" % (
            self.prefix, ("_" + self.suffix) if self.suffix else "",
            self._counter, CKPT_SUFFIX)
        path = os.path.join(self.directory, name)
        sink = TensorSink(min_bytes=self._min_tensor_bytes())
        if self._async_enabled():
            with extracting(sink):
                payload = self._capture(target)
        else:
            payload = None
        if payload is None:
            # synchronous (or capture-failed): extract while pickling the
            # live workflow on this thread, no twin
            self._write_ckpt(target, TensorSink(
                min_bytes=self._min_tensor_bytes()), path,
                extract_live=True)
        else:
            self._get_writer().submit(
                lambda: self._write_ckpt(payload, sink, path),
                improved=bool(getattr(self, "_exporting_improvement_",
                                      False)),
                label=name)
        self.destination = path
        return path

    # -- durable-write phase (writer thread; inline when synchronous) --------
    def _write_ckpt(self, obj, sink, path, extract_live=False):
        t0 = time.perf_counter()
        pidx, pcount = _proc()
        store = ChunkStore(os.path.join(self.directory, CHUNKS_DIR))
        # plain host ndarrays (solver state) divert at pickle time;
        # extract_live also arms the Array.__getstate__ hook
        if extract_live:
            with extracting(sink):
                blob = dumps_extracting(obj, sink)
        else:
            blob = dumps_extracting(obj, sink)
        entries, stats = write_tensors(store, sink, self._chunk_bytes())
        store.fsync_dir()
        man = Manifest(tensors=entries, meta={
            "prefix": self.prefix, "suffix": self.suffix,
            "counter": self._counter, "created": time.time(),
            "process_count": pcount})
        if pcount > 1:
            parts = path + _PARTS_SUFFIX
            os.makedirs(parts, exist_ok=True)
            man.dump(os.path.join(parts, "part-%d.json" % pidx))
            if pidx != 0:
                return path
            man = self._merge_parts(parts, man, pcount)
        self._finalize(path, man, blob)
        dt = time.perf_counter() - t0
        obs = self._obs()
        obs["bytes"].inc(stats["bytes_written"])
        obs["written"].inc()
        ck = _obs()
        ck["bytes"].inc(stats["bytes_written"])
        ck["deduped"].inc(stats["chunks_deduped"])
        ck["seconds"].labels(op="save").inc(dt)
        events.span("checkpoint.save", dt, snapshotter=self.prefix,
                    path=path, bytes_written=stats["bytes_written"],
                    bytes_total=stats["bytes_total"],
                    chunks_deduped=stats["chunks_deduped"],
                    tensors=len(entries))
        self._report_tensor_sizes(path, man, stats)
        self.last_write_s = dt
        self._last_write_stats_ = stats
        return path

    def _merge_parts(self, parts, man, pcount):
        """Process 0: wait on the shared file system for every
        process's fragment, then union them."""
        deadline = time.monotonic() + _PART_WAIT_S
        want = {"part-%d.json" % k for k in range(pcount)}
        while time.monotonic() < deadline:
            try:
                have = set(os.listdir(parts))
            except OSError:
                have = set()
            if want <= have:
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(
                "checkpoint parts missing after %.0fs: %s"
                % (_PART_WAIT_S, sorted(want - have)))
        for k in range(1, pcount):
            man.merge(Manifest.load(
                os.path.join(parts, "part-%d.json" % k)))
        return man

    def _finalize(self, path, man, blob):
        """Write the manifest and the topology into ``*.tmp``, fsync,
        rename the directory into place, flip ``_current``, drop the
        staging."""
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        topo = os.path.join(tmp, TOPOLOGY)
        with open(topo, "wb") as raw:
            with gzip.GzipFile(
                    fileobj=raw, mode="wb",
                    compresslevel=self._compression_level()) as gz:
                gz.write(blob)
            raw.flush()
            os.fsync(raw.fileno())
        man.dump(os.path.join(tmp, MANIFEST))
        _fsync_dir(tmp)
        if os.path.isdir(path):
            shutil.rmtree(path)     # a re-export of the same counter
        os.rename(tmp, path)
        _fsync_dir(self.directory)
        self._flip_current(path)
        shutil.rmtree(path + _PARTS_SUFFIX, ignore_errors=True)

    def _flip_current(self, path):
        link = os.path.join(self.directory, "%s_current" % self.prefix)
        tmp_link = link + ".tmp"
        try:
            if os.path.lexists(tmp_link):
                os.remove(tmp_link)
            os.symlink(os.path.basename(path), tmp_link)
            os.replace(tmp_link, link)
        except OSError:
            pass

    def _report_tensor_sizes(self, path, man, stats, top=5):
        """The fattest tensors, read off the manifest (no second
        pickle)."""
        threshold = self.report_size_threshold
        if threshold is None:
            threshold = root.common.snapshot.get(
                "report_size_threshold", 64 << 20)
        threshold = int(threshold)
        if threshold <= 0 or stats["bytes_total"] < threshold:
            return
        sizes = sorted(((man.tensor_bytes(ref), ref,
                         tuple(man.tensors[ref]["shape"]))
                        for ref in man.tensors), reverse=True)
        lines = ["  %-12s %-20s %.1f MiB" % (ref, shape, sz / 1048576)
                 for sz, ref, shape in sizes[:top]]
        self.warning(
            "checkpoint %s is %.1f MiB (%.1f new after dedupe); "
            "fattest tensors:\n%s", path,
            stats["bytes_total"] / 1048576,
            stats["bytes_written"] / 1048576, "\n".join(lines))

    def gc(self, keep=None):
        """Drop the chunks no retained checkpoint references; ``keep``
        limits which checkpoint dirs are retained (default: every
        complete one under the root)."""
        live = set()
        for ckpt in (keep if keep is not None
                     else list_checkpoints(self.directory)):
            live |= Manifest.load_dir(ckpt).digests()
        store = ChunkStore(os.path.join(self.directory, CHUNKS_DIR))
        return store.gc(live)

    @staticmethod
    def import_dir(path):
        return import_dir(path)


def save_state(directory, name, obj, min_tensor_bytes=1,
               chunk_bytes=None, meta=None, compresslevel=6):
    """Checkpoint an arbitrary picklable object whose tensor leaves
    (numpy arrays, torch tensors on any device) are chunked into the
    content-addressed store under ``directory``.  Returns the checkpoint
    dir path.  An existing checkpoint of the same name is replaced.
    ``chunk_bytes`` defaults to ``root.common.snapshot.chunk_bytes``."""
    os.makedirs(directory, exist_ok=True)
    t0 = time.perf_counter()
    store = ChunkStore(os.path.join(directory, CHUNKS_DIR))
    sink = TensorSink(min_bytes=max(int(min_tensor_bytes), 1))
    with extracting(sink):
        blob = dumps_extracting(obj, sink)
    if chunk_bytes is None:
        chunk_bytes = root.common.snapshot.get("chunk_bytes", 16 << 20)
    entries, stats = write_tensors(store, sink, int(chunk_bytes))
    store.fsync_dir()
    man = Manifest(tensors=entries, meta=dict(
        meta or {}, name=name, created=time.time()))
    path = os.path.join(directory, name + CKPT_SUFFIX)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, TOPOLOGY), "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb",
                           compresslevel=compresslevel) as gz:
            gz.write(blob)
        raw.flush()
        os.fsync(raw.fileno())
    man.dump(os.path.join(tmp, MANIFEST))
    _fsync_dir(tmp)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _fsync_dir(directory)
    dt = time.perf_counter() - t0
    ck = _obs()
    ck["bytes"].inc(stats["bytes_written"])
    ck["deduped"].inc(stats["chunks_deduped"])
    ck["seconds"].labels(op="save").inc(dt)
    events.span("checkpoint.save", dt, path=path,
                bytes_written=stats["bytes_written"],
                chunks_deduped=stats["chunks_deduped"],
                tensors=len(entries))
    return path


def delete_checkpoint(path):
    """Remove one ``*.ckpt`` directory (a consumed session spill).  Only
    the manifest and topology go: the chunks are content-addressed and
    possibly shared.  Returns True when something was deleted."""
    path = resolve_checkpoint(path)
    existed = os.path.isdir(path)
    shutil.rmtree(path, ignore_errors=True)
    return existed


def load_state(path):
    """Mirror of :func:`save_state`: the object with every tensor leaf
    resolved as host numpy (the caller moves it to its device)."""
    return _load_topology(path)
