"""Content-addressed tensor checkpoints: the port of
``veles_tpu/checkpoint``'s tensor store.

Public surface:

- :func:`save_state` / :func:`load_state` — checkpoint arbitrary
  objects whose numpy / torch tensor leaves are chunked into a
  content-addressed store (the decode scheduler's ``checkpoint_kv``);
- :class:`SnapshotterToShards` / :func:`import_dir` — the workflow
  snapshotter's sharded backend and its restore
  (``veles_tpu_torch.snapshotter.restore`` routes directories here);
- :func:`open_checkpoint` / :func:`resolve_checkpoint` — open a
  manifest for inspection; :func:`quarantine_partials` sets a crashed
  save's partials aside;
- :class:`ChunkStore`, :class:`Manifest`, :class:`TensorReader` — the
  storage primitives (the tiered KV cache's disk tier sits on
  :class:`ChunkStore`).

The reference's ``TensorReader.restore_array`` (a sharded restore onto
a mesh) waits for the port's ``parallel/`` (ROADMAP queue A item 11).
"""

from .manifest import (CHUNKS_DIR, CKPT_SUFFIX, MANIFEST, TOPOLOGY,
                       Manifest, list_checkpoints)
from .snapshot import (SnapshotterToShards, delete_checkpoint,
                       import_dir, is_shard_checkpoint, load_state,
                       open_checkpoint, quarantine_partials,
                       resolve_checkpoint, save_state)
from .store import ChunkStore, CorruptChunkError
from .tensors import (ExtractingPickler, ResolvingUnpickler,
                      TensorReader, TensorSink, TensorStub,
                      extracting, restoring)

__all__ = [
    "CHUNKS_DIR", "CKPT_SUFFIX", "MANIFEST", "TOPOLOGY",
    "Manifest", "list_checkpoints",
    "SnapshotterToShards", "delete_checkpoint", "import_dir",
    "is_shard_checkpoint", "load_state", "open_checkpoint",
    "quarantine_partials", "resolve_checkpoint", "save_state",
    "ChunkStore", "CorruptChunkError",
    "ExtractingPickler", "ResolvingUnpickler",
    "TensorReader", "TensorSink", "TensorStub",
    "extracting", "restoring",
]
