"""Tensor extraction, chunked serialization and restore.

The host half of ``veles_tpu/checkpoint/tensors.py``.  A save walks the
object with pickle: every large tensor — a plain ``numpy.ndarray`` or a
``torch.Tensor`` (:class:`ExtractingPickler`), or a ``memory.Array``
payload inside an :func:`extracting` context (``Array.__getstate__``) —
is diverted into a :class:`TensorSink` and replaced by a reference, so
the pickle carries no tensor bytes; :func:`write_tensors` stores the
sink's tensors as content-addressed chunks instead.  Restore is the
mirror: :class:`ResolvingUnpickler` (and :class:`TensorStub` through the
:func:`restoring` context) rebuilds every tensor on the host from the
manifest's chunks, as numpy.

torch tensors are mutable where the reference's ``jax.Array`` is not,
so the sink copies every tensor once, when it is extracted: a CUDA
tensor is pulled to the host there and nowhere else.  The manifest,
the chunk bands and their digests are the reference's, so a checkpoint
of plain tensors written by either package loads in the other.
"""

import contextlib
import io
import pickle
import threading

import numpy
import torch

__all__ = ["TensorSink", "TensorStub", "ExtractingPickler",
           "ResolvingUnpickler", "TensorReader", "extracting", "restoring",
           "active_sink", "active_source", "dumps_extracting",
           "write_tensors"]

_TLS = threading.local()


def _host_copy(value):
    """A host numpy copy of ``value``, taken now (a CUDA tensor moves to
    the host here, once)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return numpy.array(value)


class TensorSink:
    """Collects the tensor payloads extracted during one save.

    Every payload is a host numpy copy taken at extraction, except a
    numpy array the caller declares frozen (``copy=False``), which is
    kept zero-copy."""

    def __init__(self, min_bytes=65536):
        self.min_bytes = int(min_bytes)
        self.tensors = {}            # ref -> host numpy
        self._n = 0
        self._by_id = {}             # id(value) -> (ref, value): dedupe

    def add(self, value, copy=False):
        hit = self._by_id.get(id(value))
        if hit is not None and hit[1] is value:
            return hit[0]
        stored = (_host_copy(value)
                  if copy or isinstance(value, torch.Tensor) else value)
        ref = "t%05d" % self._n
        self._n += 1
        self.tensors[ref] = stored
        # the original is held too, so its id cannot be reused mid-save
        self._by_id[id(value)] = (ref, value)
        return ref


def active_sink():
    return getattr(_TLS, "sink", None)


def active_source():
    return getattr(_TLS, "source", None)


@contextlib.contextmanager
def extracting(sink):
    """Divert large ``memory.Array`` payloads seen by pickle/deepcopy
    into ``sink`` (consulted by ``Array.__getstate__``)."""
    prev = active_sink()
    _TLS.sink = sink
    try:
        yield sink
    finally:
        _TLS.sink = prev


@contextlib.contextmanager
def restoring(source):
    """Resolve :class:`TensorStub` references through ``source``
    (anything with a ``resolve(ref)`` method) during ``pickle.load``."""
    prev = active_source()
    _TLS.source = source
    try:
        yield source
    finally:
        _TLS.source = prev


def _resolve(ref):
    src = active_source()
    if src is None:
        raise RuntimeError(
            "TensorStub %r resolved outside a checkpoint restore context "
            "— load checkpoints via checkpoint.load_state(), not bare "
            "pickle.load" % ref)
    return src.resolve(ref)


class TensorStub:
    """Pickles as a call to ``_resolve(ref)``: restore rebuilds the
    tensor in place, even inside tuples/dicts pickle reconstructs."""

    __slots__ = ("ref",)

    def __init__(self, ref):
        self.ref = ref

    def __reduce__(self):
        return (_resolve, (self.ref,))

    def __deepcopy__(self, memo):
        return self                  # immutable marker

    def __repr__(self):
        return "<TensorStub %s>" % self.ref


class ExtractingPickler(pickle.Pickler):
    """Pickler diverting large tensors — plain host ndarrays and torch
    tensors on any device — into the sink via pickle's persistent-id
    protocol.  A numpy array is taken zero-copy (the caller pickles a
    frozen object); a torch tensor is copied to the host by the sink."""

    def __init__(self, file, sink, protocol=pickle.HIGHEST_PROTOCOL):
        super().__init__(file, protocol)
        self._sink = sink

    def persistent_id(self, obj):
        sink = self._sink
        if isinstance(obj, numpy.ndarray):
            if obj.dtype != numpy.object_ and \
                    obj.nbytes >= sink.min_bytes:
                return sink.add(obj)
            return None
        if isinstance(obj, torch.Tensor) and \
                obj.numel() * obj.element_size() >= sink.min_bytes:
            return sink.add(obj)
        return None


def dumps_extracting(obj, sink):
    buf = io.BytesIO()
    ExtractingPickler(buf, sink).dump(obj)
    return buf.getvalue()


class ResolvingUnpickler(pickle.Unpickler):
    """Mirror of :class:`ExtractingPickler`: persistent ids resolve
    through a :class:`TensorReader`."""

    def __init__(self, file, reader):
        super().__init__(file)
        self._reader = reader

    def persistent_load(self, ref):
        return self._reader.resolve(ref)


# -- chunk planning -----------------------------------------------------------

def iter_block_chunks(base, block, chunk_bytes):
    """Split one contiguous block (at global offset ``base``) into
    leading-axis bands of ~``chunk_bytes`` each."""
    if block.size == 0:
        return
    if block.ndim == 0:
        yield base, block
        return
    row_bytes = max(block.nbytes // max(len(block), 1), 1)
    rows = max(int(chunk_bytes // row_bytes), 1)
    for off in range(0, len(block), rows):
        piece = block[off:off + rows]
        yield (base[0] + off,) + tuple(base[1:]), piece


def write_tensors(store, sink, chunk_bytes):
    """Serialize every sink tensor into ``store``; returns
    ``(entries, stats)`` where ``entries`` maps ref -> manifest entry.
    One process writes every tensor whole (the reference's per-shard
    split of a sharded ``jax.Array`` has no counterpart here)."""
    entries = {}
    stats = {"bytes_written": 0, "bytes_total": 0,
             "chunks_written": 0, "chunks_deduped": 0}
    for ref, value in sink.tensors.items():
        # NOT ascontiguousarray: it promotes 0-d to shape (1,)
        block = numpy.asarray(value)
        chunks = []
        for off, piece in iter_block_chunks((0,) * block.ndim, block,
                                            chunk_bytes):
            if not piece.flags.c_contiguous:
                piece = numpy.ascontiguousarray(piece)
            digest, written = store.put(piece.data)
            stats["bytes_total"] += piece.nbytes
            if written:
                stats["bytes_written"] += written
                stats["chunks_written"] += 1
            else:
                stats["chunks_deduped"] += 1
            chunks.append({"offset": list(off),
                           "shape": list(piece.shape),
                           "digest": digest,
                           "bytes": piece.nbytes})
        entries[ref] = {"shape": [int(d) for d in block.shape],
                        "dtype": block.dtype.name,
                        "sharding": None,
                        "chunks": chunks}
    return entries, stats


# -- restore ------------------------------------------------------------------

class TensorReader:
    """Resolves manifest tensors from a chunk store: ``resolve(ref)``
    assembles the full tensor on the host (peak memory is one tensor,
    not the whole object twice)."""

    def __init__(self, store, manifest):
        self.store = store
        self.manifest = manifest
        self.bytes_read = 0

    def entry(self, ref):
        try:
            return self.manifest.tensors[ref]
        except KeyError:
            raise KeyError("checkpoint manifest has no tensor %r" % ref)

    def _chunk_array(self, chunk, dtype):
        data = self.store.get(chunk["digest"])
        self.bytes_read += len(data)
        return numpy.frombuffer(data, dtype).reshape(chunk["shape"])

    def resolve(self, ref):
        e = self.entry(ref)
        dtype = numpy.dtype(e["dtype"])
        shape = tuple(e["shape"])
        out = numpy.empty(shape, dtype)
        for c in e["chunks"]:
            if not shape:
                out[...] = self._chunk_array(c, dtype)
                continue
            region = tuple(slice(o, o + s)
                           for o, s in zip(c["offset"], c["shape"]))
            out[region] = self._chunk_array(c, dtype)
        return out

    # The reference's ``restore_array(ref, sharding)`` builds a sharded
    # ``jax.Array`` straight onto a mesh, reading only the chunks that
    # overlap each local shard.  It has no counterpart until the port's
    # ``parallel/`` lands (ROADMAP queue A item 11): the port restores
    # every tensor whole on the host and moves it to its device after.
