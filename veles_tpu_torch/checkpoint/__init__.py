"""Content-addressed tensor checkpoints: the port of
``veles_tpu/checkpoint``'s tensor store.

Public surface:

- :func:`save_state` / :func:`load_state` — checkpoint arbitrary
  objects whose numpy / torch tensor leaves are chunked into a
  content-addressed store (the decode scheduler's ``checkpoint_kv``);
- :func:`open_checkpoint` / :func:`resolve_checkpoint` — open a
  manifest for inspection;
- :class:`ChunkStore`, :class:`Manifest`, :class:`TensorReader` — the
  storage primitives (the tiered KV cache's disk tier sits on
  :class:`ChunkStore`).

The workflow snapshotter (``SnapshotterToShards``, ``import_dir``) is
not ported yet (ROADMAP queue A item 8).
"""

from .manifest import (CHUNKS_DIR, CKPT_SUFFIX, MANIFEST, TOPOLOGY,
                       Manifest, list_checkpoints)
from .snapshot import (delete_checkpoint, load_state, open_checkpoint,
                       resolve_checkpoint, save_state)
from .store import ChunkStore, CorruptChunkError
from .tensors import (ExtractingPickler, ResolvingUnpickler,
                      TensorReader, TensorSink, TensorStub,
                      extracting, restoring)

__all__ = [
    "CHUNKS_DIR", "CKPT_SUFFIX", "MANIFEST", "TOPOLOGY",
    "Manifest", "list_checkpoints",
    "delete_checkpoint", "load_state", "open_checkpoint", "resolve_checkpoint", "save_state",
    "ChunkStore", "CorruptChunkError",
    "ExtractingPickler", "ResolvingUnpickler",
    "TensorReader", "TensorSink", "TensorStub",
    "extracting", "restoring",
]
