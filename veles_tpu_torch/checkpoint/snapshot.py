"""Object checkpoints over the content-addressed chunk store.

The part of ``veles_tpu/checkpoint/snapshot.py`` the decode scheduler's
``checkpoint_kv`` / ``restore_kv`` and its session spill stand on.
Layout under one root (``directory``)::

    chunks/<sha256>.chunk            content-addressed tensor chunks,
                                     shared by ALL checkpoints (dedupe)
    <name>.ckpt/                     one complete checkpoint
        manifest.json                tensors -> chunk lists
        topology.pickle.gz           the object's pickle, tensors
                                     replaced by references

A save writes ``<name>.ckpt.tmp`` and renames it into place, so a kill
at any point leaves the previous checkpoint of that name or the new one
complete, never a torn one at a listed name.  The workflow snapshotter
of the reference (``SnapshotterToShards``, ``import_dir``) is not
ported: it waits for the port's snapshotter (ROADMAP queue A item 8).

Each save and restore records ``checkpoint.save`` / ``checkpoint.restore``
spans on the event log and the ``veles_checkpoint_*`` counters on the
metrics registry, as the reference does.
"""

import gzip
import os
import shutil
import time

from ..config import root
from ..logger import events
from ..observability.registry import REGISTRY
from .manifest import (CHUNKS_DIR, CKPT_SUFFIX, MANIFEST, TOPOLOGY,
                       Manifest, list_checkpoints)
from .store import ChunkStore
from .tensors import (ResolvingUnpickler, TensorReader, TensorSink,
                      dumps_extracting, extracting, restoring,
                      write_tensors)

__all__ = ["save_state", "load_state", "open_checkpoint",
           "resolve_checkpoint", "delete_checkpoint"]

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


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


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


def open_checkpoint(path):
    """(ckpt_dir, Manifest, TensorReader) for inspection or restore."""
    ckpt = resolve_checkpoint(path)
    man = Manifest.load_dir(ckpt)
    store = ChunkStore(os.path.join(os.path.dirname(ckpt), CHUNKS_DIR))
    return ckpt, man, TensorReader(store, man)


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
