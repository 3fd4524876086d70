"""Checkpoint manifests: what tensors a checkpoint holds, as which chunks.

The port's copy of ``veles_tpu/checkpoint/manifest.py``, format 1
unchanged: a checkpoint written by either package opens in the other.

One checkpoint is a directory ``<prefix>[_suffix].<counter>.ckpt/``
containing

- ``manifest.json`` — per-tensor global shape/dtype/sharding plus the
  chunk list (global-coordinate offsets/shapes, sha256 digests, sizes);
- ``topology.pickle.gz`` — the saved object's pickle with every tensor
  replaced by a persistent reference (:mod:`.tensors`);
- ``part-<k>.json`` staging fragments while a multi-process save is in
  flight (merged into ``manifest.json`` by process 0).

Chunks themselves live in a SIBLING ``chunks/`` directory shared by all
checkpoints under one snapshot root — that sharing is what makes
unchanged tensors dedupe across consecutive checkpoints.  The directory
is written as ``*.ckpt.tmp`` and atomically renamed; a torn save can
only ever leave a ``.tmp`` partial (quarantined by the next writer) and
orphan chunks (garbage-collectable), never a listed-but-incomplete
checkpoint.
"""

import json
import os

__all__ = ["FORMAT", "MANIFEST", "TOPOLOGY", "CHUNKS_DIR", "CKPT_SUFFIX",
           "Manifest", "list_checkpoints"]

FORMAT = 1
MANIFEST = "manifest.json"
TOPOLOGY = "topology.pickle.gz"
CHUNKS_DIR = "chunks"
CKPT_SUFFIX = ".ckpt"


class Manifest:
    def __init__(self, tensors=None, meta=None):
        self.tensors = dict(tensors or {})
        self.meta = dict(meta or {})

    def add(self, ref, entry):
        self.tensors[ref] = entry

    def digests(self):
        out = set()
        for e in self.tensors.values():
            for c in e["chunks"]:
                out.add(c["digest"])
        return out

    def tensor_bytes(self, ref):
        return sum(c["bytes"] for c in self.tensors[ref]["chunks"])

    def total_bytes(self):
        return sum(self.tensor_bytes(ref) for ref in self.tensors)

    def to_json(self):
        return {"format": FORMAT, "meta": self.meta,
                "tensors": self.tensors}

    def dump(self, path):
        """Plain write + fsync: atomicity comes from the enclosing
        ``*.ckpt.tmp`` directory rename, not per-file renames."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())

    @classmethod
    def load(cls, path):
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != FORMAT:
            raise ValueError("unsupported checkpoint manifest format %r "
                             "in %s" % (doc.get("format"), path))
        return cls(tensors=doc.get("tensors", {}),
                   meta=doc.get("meta", {}))

    @classmethod
    def load_dir(cls, ckpt_dir):
        return cls.load(os.path.join(ckpt_dir, MANIFEST))

    def merge(self, other):
        """Union another process's part into this one (refs are
        process-disjoint except replicated tensors, where every process
        planned identical chunk lists — last wins)."""
        for ref, entry in other.tensors.items():
            mine = self.tensors.get(ref)
            if mine is None or not mine["chunks"]:
                self.tensors[ref] = entry
            elif entry["chunks"] and mine["chunks"] != entry["chunks"]:
                # disjoint shards of the same tensor: concatenate
                seen = {tuple(c["offset"]) for c in mine["chunks"]}
                mine["chunks"].extend(
                    c for c in entry["chunks"]
                    if tuple(c["offset"]) not in seen)
        return self


def list_checkpoints(directory):
    """Complete checkpoint dirs under a snapshot root, oldest first by
    counter (``*.ckpt`` containing a manifest; ``.tmp``/quarantined
    partials never listed)."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not name.endswith(CKPT_SUFFIX):
            continue
        path = os.path.join(directory, name)
        if not os.path.isdir(path) or \
                not os.path.exists(os.path.join(path, MANIFEST)):
            continue
        try:
            counter = int(name[:-len(CKPT_SUFFIX)].rsplit(".", 1)[1])
        except (IndexError, ValueError):
            counter = -1
        out.append((counter, path))
    return [path for _, path in sorted(out)]
