"""FullBatchLoader: the whole dataset resident in device memory.

The port's copy of ``veles_tpu/loader/fullbatch.py`` (a re-design of the
reference's FullBatchLoader, veles/loader/fullbatch.py:79, with its
on-device gather kernel ``cuda/fullbatch_loader.cu``).  Normalization is
baked into the dataset once at initialize (train-statistics analyze pass
first), then the dataset is uploaded to the device once, so the
per-step path is a pure gather.  The fused train step gathers inside
itself (``torch.index_select``; ``FusedTrainStep.link_fused_gather``
sets ``defer_device_gather``, the JAX package's mode): the loader then
computes the indices only.  Otherwise (graph mode) the loader serves
``minibatch_data`` and ``minibatch_labels`` (``minibatch_targets`` for
:class:`FullBatchLoaderMSE`) itself, padded rows zero (labels -1), as
the JAX loader does:

- on the device the dataset lives on: one ``index_select`` per source
  into device tensors (the JAX package's standalone device gather);
- with ``force_numpy=True``, or initialized without a device, on the
  host: ``fill_minibatch``, the JAX package's host twin of the gather,
  uploaded at the consumer's first ``devmem`` read.

A ``MinibatchPrefetcher``'s twin serves through the same methods: with
the gather in the step it stages ``_padded_indices_`` and the size on
the card, on the host path the served Arrays.  The epoch scan
(``ScanEpochStep``) gathers each class's minibatches from the resident
dataset itself.
"""

import numpy
import torch

from ..memory import Array
from .. import normalization
from .base import Loader, TRAIN, VALID

__all__ = ["FullBatchLoader", "FullBatchLoaderMSE", "cast_normalized"]

#: row-band size for the cast+normalize pass (bounds the transient)
CAST_CHUNK_BYTES = 64 << 20


def cast_normalized(arr, dtype, normalizer, chunk_bytes=CAST_CHUNK_BYTES):
    """Cast the dataset Array ``arr`` to ``dtype`` and bake ``normalizer``
    in WITHOUT a second full-size copy: a same-dtype dataset is
    normalized in place, band by band; a dtype change allocates the
    destination exactly once and converts row bands through a small
    transient.  Every normalizer transforms rows independently, so
    banding is bit-exact vs the whole-array pass.  Returns the resident
    ndarray (also assigned back to ``arr.mem``)."""
    src = arr.map_write()
    apply = not isinstance(normalizer, normalization.NoneNormalizer)
    dtype = numpy.dtype(dtype)
    row_bytes = max(int(src[:1].nbytes), 1) if len(src) else 1
    rows = max(1, int(chunk_bytes) // row_bytes)
    if src.dtype == dtype:
        if apply:
            for i in range(0, len(src), rows):
                normalizer.normalize(src[i:i + rows])
        arr.mem = src
        return src
    dst = numpy.empty(src.shape, dtype)
    for i in range(0, len(src), rows):
        band = src[i:i + rows].astype(dtype)
        if apply:
            normalizer.normalize(band)
        dst[i:i + rows] = band
    arr.mem = dst
    return dst


class FullBatchLoader(Loader):
    """Dataset-as-one-Array loader.

    Subclasses implement ``load_data()`` filling ``original_data`` (and
    ``original_labels`` when ``has_labels``) plus ``class_lengths``.
    Each minibatch's shuffled indices, padded with the first one, are
    ``_padded_indices_``; a consumer that gathers on the device
    (``defer_device_gather``) reads them and ``original_data``, which
    lives on the device given to ``initialize``, and the dense labels.
    Otherwise the loader gathers the minibatch on that device, or on the
    host (``fill_minibatch``) with ``force_numpy``.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_data = Array(shallow_pickle=True)
        self.original_labels = []
        self.force_numpy = bool(kwargs.get("force_numpy", False))
        self._dtype = kwargs.get("dtype", numpy.float32)

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.original_data.shape[1:],
            self._dtype))

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        if device is not None:
            # the resident dataset uploads once, at its first devmem read:
            # here, unless a consumer gathers or the host path serves
            self.original_data.initialize(device)
        self._on_device = device is not None
        self._labels_dev_ = None
        if self._on_device and not (self.defer_device_gather or
                                    self.force_numpy):
            self._gather_sources()      # reads (uploads) every source

    def analyze_dataset(self):
        """Analyze train statistics, then bake normalization into the
        resident dataset so the hot path is gather-only."""
        if self.class_lengths[TRAIN] and not isinstance(
                self.normalizer, normalization.StatelessNormalizer):
            train = self.original_data.map_read()[
                self.class_end_offsets[VALID]:self.class_end_offsets[TRAIN]]
            self.normalizer.analyze(train.astype(numpy.float64))
        else:
            self.normalizer.analyze(self.original_data.mem)
        self.prepare_restored_dataset()

    def prepare_restored_dataset(self):
        """Bake the (current or restored) normalizer state into the
        resident dataset and build the dense label table."""
        cast_normalized(self.original_data, self._dtype, self.normalizer)
        if self.has_labels:     # labels → dense int mapping once, host-side
            self._dense_labels = numpy.zeros(len(self.original_labels),
                                             self.LABEL_DTYPE)
            for i, raw in enumerate(self.original_labels):
                self._dense_labels[i] = self.labels_mapping.setdefault(
                    raw, len(self.labels_mapping))

    def fill_indices(self, start_offset, count):
        idx = numpy.zeros(self.max_minibatch_size, self.INDEX_DTYPE)
        idx[:count] = self.shuffled_indices[start_offset:start_offset + count]
        if count < self.max_minibatch_size:
            idx[count:] = idx[0]  # pad with a valid index; masked downstream
        self._padded_indices_ = idx
        if super().fill_indices(start_offset, count):
            return True     # the consumer gathers
        if self.force_numpy or not self._on_device:
            return False    # the host path: fill_minibatch
        self.minibatch_indices.map_write()[count:] = -1
        dev = self.original_data.devmem.device
        index = torch.from_numpy(idx)
        if dev.type == "cuda":
            # pinned and asynchronous: the host runs ahead of the card
            index = index.pin_memory()
        index = index.to(dev, non_blocking=True)
        for src, dst, pad in self._gather_sources():
            out = torch.index_select(src, 0, index)
            if count < len(idx):
                out[count:] = pad
            dst.devmem = out
        return True

    def _gather_sources(self):
        """(resident device source, destination Array, padding value)
        for the device gather: the single point subclasses extend."""
        pairs = [(self.original_data.devmem, self.minibatch_data, 0)]
        if self.has_labels:
            if self._labels_dev_ is None:
                self._labels_dev_ = torch.from_numpy(
                    self._dense_labels).to(self.original_data.devmem.device)
            pairs.append((self._labels_dev_, self.minibatch_labels, -1))
        return pairs

    def fill_minibatch(self):
        """The host twin of the device gather: the rows at
        ``minibatch_indices`` of the baked dataset, and their raw
        labels."""
        idx = self.minibatch_indices.map_read()[:self.minibatch_size]
        self.minibatch_data.map_write()[:self.minibatch_size] = \
            self.original_data[idx]
        if self.has_labels:
            for i, sample_idx in enumerate(idx):
                self.raw_minibatch_labels[i] = \
                    self.original_labels[sample_idx]

    def normalize_minibatch(self):
        pass  # already baked into the resident dataset

    def map_minibatch_labels(self):
        if not self.has_labels:
            return
        idx = self.minibatch_indices.map_read()[:self.minibatch_size]
        self.minibatch_labels.map_write()[:self.minibatch_size] = \
            self._dense_labels[idx]


class FullBatchLoaderMSE(FullBatchLoader):
    """FullBatch variant with regression targets (the reference's
    fullbatch.py:467-563): subclasses fill ``original_targets`` too.
    The targets get a normalizer of their own
    (``target_normalization_type``), baked in as the data's is; they
    live on the loader's device for the fused step's gather."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_targets = Array(shallow_pickle=True)
        self.minibatch_targets = Array()
        self.has_labels = False
        self.targets_normalizer = normalization.factory(
            kwargs.get("target_normalization_type", "none"),
            **kwargs.get("target_normalization_parameters", {}))

    def create_minibatch_data(self):
        super().create_minibatch_data()
        self.minibatch_targets.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.original_targets.shape[1:],
            self._dtype))

    def initialize(self, device=None, **kwargs):
        if device is not None:
            self.original_targets.initialize(device)
            self.minibatch_targets.initialize(device)
        super().initialize(device=device, **kwargs)

    def analyze_dataset(self):
        self.targets_normalizer.analyze(
            self.original_targets.map_read().astype(self._dtype))
        super().analyze_dataset()

    def prepare_restored_dataset(self):
        super().prepare_restored_dataset()
        cast_normalized(self.original_targets, self._dtype,
                        self.targets_normalizer)

    def _gather_sources(self):
        return [(self.original_data.devmem, self.minibatch_data, 0),
                (self.original_targets.devmem, self.minibatch_targets, 0)]

    def fill_minibatch(self):
        idx = self.minibatch_indices.map_read()[:self.minibatch_size]
        self.minibatch_data.map_write()[:self.minibatch_size] = \
            self.original_data[idx]
        targets = self.minibatch_targets.map_write()
        targets[:self.minibatch_size] = self.original_targets[idx]
        targets[self.minibatch_size:] = 0
