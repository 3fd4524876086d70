"""FullBatchLoader: the whole dataset resident in device memory.

The port's copy of ``veles_tpu/loader/fullbatch.py`` (a re-design of the
reference's FullBatchLoader, veles/loader/fullbatch.py:79, with its
on-device gather kernel ``cuda/fullbatch_loader.cu``).  Normalization is
baked into the dataset once at initialize (train-statistics analyze pass
first), then the dataset is uploaded to the device once, so the
per-step path is a pure gather: the loader computes the indices only
and the train step gathers them (``torch.index_select``) inside itself
(``FusedTrainStep.link_fused_gather``; the JAX package's
``defer_device_gather`` mode).  The JAX package's standalone device
gather, host-side ``fill_minibatch`` and ``force_numpy`` path have no
caller in the port and are not ported.
"""

import numpy

from ..memory import Array
from .. import normalization
from .base import Loader, TRAIN, VALID

__all__ = ["FullBatchLoader", "cast_normalized"]

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
    The loader serves indices only (``_padded_indices_``, the
    minibatch's shuffled indices padded with the first one) and the
    consumer gathers from ``original_data``, which lives on the device
    given to ``initialize``, and from the dense labels.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.original_data = Array(shallow_pickle=True)
        self.original_labels = []
        self._dtype = kwargs.get("dtype", numpy.float32)

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.original_data.shape[1:],
            self._dtype))

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        if device is not None:
            # the resident dataset uploads once, at its first devmem read
            self.original_data.initialize(device)

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
