"""ShardedBatchLoader: stream an on-disk sharded dataset through a
bounded read-ahead window, so the dataset may outgrow host RAM.

The port of ``veles_tpu/loader/shards.py``.  On-disk layout (written by
:func:`write_shards`, byte for byte the JAX package's)::

    index.json            format, class lengths, sample shape/dtype,
                          per-shard row counts
    shard-00000.npy       rows [0, r0) in dataset order [test|valid|train]
    shard-00001.npy       rows [r0, r0+r1) ...
    labels.npy            one label per sample (small; RAM-resident)

Only the data rows stream: the labels and the index stay in RAM.  The
loader keeps at most ``window_bytes`` of decoded shards; eviction is
Belady's rule (the epoch's permutation is known once ``shuffle()`` has
run, so the shard whose next use lies farthest ahead is dropped).

Two shuffle modes:

- ``shuffle_mode="global"`` (default): :meth:`Loader.shuffle` permutes
  the train segment as a FullBatchLoader does, so the minibatch stream
  is bit-identical to a FullBatchLoader over the same arrays (a window
  smaller than the dataset reads shards again; correctness never
  depends on the window);
- ``shuffle_mode="windowed"``: shard order and the rows within each
  shard are permuted instead, so each shard is read once per epoch, in
  sequence (deterministic under the loader's prng, not stream-equal to
  the global mode).

Normalization is applied to each minibatch from the statistics a
FullBatchLoader computes (the train segment, float64, dataset order),
and the normalizer pickles with them, so a restored snapshot resumes
with the same transform.  The loader serves minibatches on the host:
in a fused workflow the step runs on its ``minibatch_data``, uploaded
to the step's device (staged there ahead of the step by a
``MinibatchPrefetcher``, whose twin serves from the same window).
"""

import bisect
import json
import os

import numpy

from .. import normalization
from ..backends import Device
from .base import Loader, LoaderError, TRAIN, VALID

__all__ = ["ShardedBatchLoader", "write_shards", "INDEX", "LABELS",
           "SHARD_FMT", "FORMAT"]

INDEX = "index.json"
LABELS = "labels.npy"
SHARD_FMT = "shard-%05d.npy"
FORMAT = 1


def write_shards(directory, data, labels=None, class_lengths=None,
                 rows_per_shard=None, shard_bytes=64 << 20):
    """Materialize an in-RAM dataset as a sharded on-disk dataset.

    ``data`` is the full ``[test|valid|train]``-ordered array (anything
    numpy can view row-wise); ``class_lengths`` the usual 3-list.  Shard
    size comes from ``rows_per_shard`` or a ``shard_bytes`` budget.
    Returns the index path."""
    data = numpy.asarray(data)
    if data.ndim < 1 or not len(data):
        raise ValueError("empty dataset")
    if class_lengths is None:
        class_lengths = [0, 0, len(data)]
    if sum(class_lengths) != len(data):
        raise ValueError("class_lengths %s != %d rows"
                         % (class_lengths, len(data)))
    if rows_per_shard is None:
        rows_per_shard = max(1, int(shard_bytes) // max(data[:1].nbytes, 1))
    os.makedirs(directory, exist_ok=True)
    shards = []
    for k, start in enumerate(range(0, len(data), rows_per_shard)):
        block = numpy.ascontiguousarray(data[start:start + rows_per_shard])
        name = SHARD_FMT % k
        numpy.save(os.path.join(directory, name), block)
        shards.append({"file": name, "rows": int(len(block))})
    if labels is not None:
        if len(labels) != len(data):
            raise ValueError("labels length mismatch")
        numpy.save(os.path.join(directory, LABELS), numpy.asarray(labels))
    index = {
        "format": FORMAT,
        "class_lengths": [int(c) for c in class_lengths],
        "sample_shape": [int(s) for s in data.shape[1:]],
        "dtype": data.dtype.str,
        "labels": LABELS if labels is not None else None,
        "shards": shards,
    }
    path = os.path.join(directory, INDEX)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class ShardedBatchLoader(Loader):
    """Minibatches from an on-disk sharded dataset through a bounded
    shard window (``window_bytes``, default 256 MiB)."""

    MAPPING = "sharded_batch"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.path = kwargs["path"]
        self.window_bytes = int(kwargs.get("window_bytes", 256 << 20))
        self.shuffle_mode = kwargs.get("shuffle_mode", "global")
        if self.shuffle_mode not in ("global", "windowed"):
            raise ValueError("shuffle_mode must be global|windowed")
        self._dtype = kwargs.get("dtype", numpy.float32)
        self.original_labels = []

    def initialize(self, device=None, **kwargs):
        # the minibatches it serves go to the card unless the CPU is
        # asked for (Device() raises without a card)
        super().initialize(device=Device() if device is None else device,
                           **kwargs)

    def init_unpickled(self):
        super().init_unpickled()
        # one mutable holder for all window state, transient: a pickle
        # carries no shard, and a restored loader starts with an empty
        # window (a MinibatchPrefetcher's serving twin shares this dict,
        # so the window the worker fills is the loader's)
        self._window_ = {"cache": {}, "bytes": 0, "loads": 0,
                         "positions": None}

    # -- dataset geometry ----------------------------------------------------
    def load_data(self):
        with open(os.path.join(self.path, INDEX)) as f:
            index = json.load(f)
        if index.get("format") != FORMAT:
            raise LoaderError("unsupported shard index format: %r"
                              % index.get("format"))
        self._index = index
        self._shard_files = [s["file"] for s in index["shards"]]
        rows = [int(s["rows"]) for s in index["shards"]]
        starts = numpy.zeros(len(rows) + 1, numpy.int64)
        numpy.cumsum(rows, out=starts[1:])
        self._shard_starts = starts          # starts[k] .. starts[k+1]
        self.class_lengths = list(index["class_lengths"])
        if int(starts[-1]) != sum(self.class_lengths):
            raise LoaderError("index rows != class lengths")
        self._sample_shape = tuple(index["sample_shape"])
        self._raw_dtype = numpy.dtype(index["dtype"])
        if index.get("labels"):
            self.original_labels = list(
                numpy.load(os.path.join(self.path, index["labels"]),
                           allow_pickle=True))
            self.has_labels = True
        else:
            self.has_labels = False

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self._sample_shape, self._dtype))

    # -- the bounded shard window --------------------------------------------
    def _shard(self, k):
        w = self._window_
        block = w["cache"].get(k)
        if block is None:
            block = numpy.load(
                os.path.join(self.path, self._shard_files[k]))
            w["loads"] += 1
            # room first: the window never holds more than its budget,
            # even while a load lands (a prefetch worker loads while the
            # training thread may read the window's fill)
            self._evict(incoming=block.nbytes)
            w["cache"][k] = block
            w["bytes"] += block.nbytes
        return block

    def _evict(self, incoming):
        """Make room for a shard of ``incoming`` bytes within the budget,
        dropping the cached shard whose next use is farthest away (Belady
        — the epoch's access sequence is fully known from
        ``shuffled_indices``); a shard larger than the budget still
        loads, alone."""
        w = self._window_
        while w["bytes"] + incoming > self.window_bytes and w["cache"]:
            victim = max(w["cache"], key=self._next_use)
            w["bytes"] -= w["cache"][victim].nbytes
            del w["cache"][victim]

    def _next_use(self, shard):
        positions = self._use_positions().get(shard)
        if positions is None or not len(positions):
            return numpy.inf
        i = numpy.searchsorted(positions, self._global_offset)
        return numpy.inf if i == len(positions) else int(positions[i])

    def _use_positions(self):
        """shard id -> sorted serving positions for the current epoch's
        permutation (rebuilt whenever ``shuffle()`` reorders)."""
        if self._window_["positions"] is None:
            if not self.shuffled_indices:
                return {}   # analyze pass: sequential walk, any victim ok
            order = numpy.asarray(self.shuffled_indices.mem)
            sid = numpy.searchsorted(
                self._shard_starts, order, side="right") - 1
            self._window_["positions"] = {
                int(s): numpy.flatnonzero(sid == s)
                for s in numpy.unique(sid)}
        return self._window_["positions"]

    # -- serving -------------------------------------------------------------
    def shuffle(self):
        if self.shuffle_mode == "windowed" and self.shuffle_limit > 0 and \
                self.class_lengths[TRAIN]:
            self._windowed_shuffle()
        else:
            super().shuffle()
        self._window_["positions"] = None

    def _windowed_shuffle(self):
        """Permute shard ORDER and rows within each shard (train segment
        only): every shard is read exactly once per epoch, in sequence.
        Deterministic under the loader prng; NOT stream-identical to the
        global shuffle."""
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=self.INDEX_DTYPE)
        self.shuffle_limit -= 1
        lo = self.class_end_offsets[VALID]
        hi = self.class_end_offsets[TRAIN]
        starts = self._shard_starts
        groups = []
        for k in range(len(self._shard_files)):
            a, b = max(int(starts[k]), lo), min(int(starts[k + 1]), hi)
            if a < b:
                groups.append(numpy.arange(a, b, dtype=self.INDEX_DTYPE))
        order = numpy.arange(len(groups))
        self.prng.shuffle(order)
        out = []
        for g in order:
            rows = groups[g]
            self.prng.shuffle(rows)
            out.append(rows)
        self.shuffled_indices.map_write()[lo:hi] = numpy.concatenate(out)

    def fill_indices(self, start_offset, count):
        """The indices only: the minibatch is always served on the host,
        from the shard window (``fill_minibatch``)."""
        super().fill_indices(start_offset, count)
        return False

    def fill_minibatch(self):
        idx = numpy.asarray(
            self.minibatch_indices.map_read()[:self.minibatch_size],
            numpy.int64)
        out = self.minibatch_data.map_write()
        sid = numpy.searchsorted(self._shard_starts, idx, side="right") - 1
        for s in numpy.unique(sid):
            block = self._shard(int(s))
            rows = numpy.flatnonzero(sid == s)
            out[rows] = block[idx[rows] - int(self._shard_starts[s])]

    # -- normalization / labels (FullBatchLoader-parity) ---------------------
    def analyze_dataset(self):
        """Same statistics FullBatchLoader computes — train segment,
        float64, dataset order — accumulated shard by shard."""
        if self.class_lengths[TRAIN] and not isinstance(
                self.normalizer, normalization.StatelessNormalizer):
            lo = self.class_end_offsets[VALID]
            hi = self.class_end_offsets[TRAIN]
            for k in range(len(self._shard_files)):
                a = max(int(self._shard_starts[k]), lo)
                b = min(int(self._shard_starts[k + 1]), hi)
                if a >= b:
                    continue
                block = self._shard(k)
                off = int(self._shard_starts[k])
                self.normalizer.analyze(
                    block[a - off:b - off].astype(numpy.float64))
        elif len(self._shard_files):
            self.normalizer.analyze(self._shard(0))
        self.prepare_restored_dataset()

    def prepare_restored_dataset(self):
        """Dense label table in DATASET order (identical id assignment
        to FullBatchLoader, which maps before shuffling)."""
        if self.has_labels:
            self._dense_labels = numpy.zeros(len(self.original_labels),
                                             self.LABEL_DTYPE)
            for i, raw in enumerate(self.original_labels):
                self._dense_labels[i] = self.labels_mapping.setdefault(
                    raw, len(self.labels_mapping))

    def map_minibatch_labels(self):
        if not self.has_labels:
            return
        idx = self.minibatch_indices.map_read()[:self.minibatch_size]
        self.minibatch_labels.map_write()[:self.minibatch_size] = \
            self._dense_labels[idx]

    # -- introspection -------------------------------------------------------
    @property
    def window_used_bytes(self):
        return self._window_["bytes"]

    @property
    def shard_loads(self):
        return self._window_["loads"]

    @property
    def shards_cached(self):
        return sorted(self._window_["cache"])

    def shard_of(self, sample):
        return bisect.bisect_right(self._shard_starts.tolist(), sample) - 1

    def get_metric_values(self):
        vals = super().get_metric_values()
        vals["Shard loads"] = self.shard_loads
        return vals
