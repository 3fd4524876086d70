"""Loader: the minibatch-serving unit at the head of every training loop.

The port's copy of ``veles_tpu/loader/base.py`` (a re-design of the
reference's Loader, veles/loader/base.py: ILoader :100-120, TEST/VALID/
TRAIN triage :73-80, shuffling :711-724, the normalization analysis pass
:760-800).

Epoch model: the dataset is three classes laid out ``[test | validation
| train]``; a global offset walks the concatenated ``shuffled_indices``
and the minibatch class is the segment the offset falls in.  The last
minibatch of a class is short (``minibatch_size`` < the maximum) and
the buffers are padded.  ``last_minibatch``/``epoch_ended``/
``train_ended``/``valid_ended`` are :class:`Bool` gates that downstream
Decision units link on.  Seeded alike, the port serves the JAX
package's minibatches in the same order.

Each minibatch's indices go to ``minibatch_indices`` (``fill_indices``).
A consumer that gathers the minibatch itself on the device (the fused
train step, ``FusedTrainStep.link_fused_gather``) sets
``defer_device_gather`` and the loader stops there.  A loader that
gathers on its device (``FullBatchLoader``) stops there too, the
minibatch served.  Otherwise the loader serves the minibatch on the
host, as the JAX package's host-side loaders do: ``fill_minibatch``
fills ``minibatch_data`` (and the raw labels), ``normalize_minibatch``
and ``map_minibatch_labels`` follow, and the padded rows of a short
minibatch are zero (labels and indices -1).  The consumer reads the
Arrays' ``devmem``, uploaded to the loader's device.

A :class:`~veles_tpu_torch.loader.prefetch.MinibatchPrefetcher` may
serve ``run()`` ahead on a worker thread (``supports_prefetch``;
``prefetcher_`` while one is attached, and ``prefetch_staged_`` the
minibatch it staged on the device).  ``failed_minibatches`` holds
``(end offset, size)`` pairs served again before the generator moves
on, and no class ends while one waits.  Not ported yet: the master/slave
index distribution (the ``IDistributable`` half, ROADMAP queue A item
11).
"""

import collections

import numpy

from ..config import root
from ..memory import Array
from ..mutable import Bool
from ..result_provider import IResultProvider
from ..units import Unit
from .. import normalization
from .. import prng

__all__ = ["Loader", "LoaderError", "TEST", "VALID", "TRAIN", "TRIAGE",
           "CLASS_NAME"]

TRAIN = 2
VALID = 1
TEST = 0
TRIAGE = {"train": TRAIN, "validation": VALID, "valid": VALID, "test": TEST}
CLASS_NAME = ["test", "validation", "train"]


class LoaderError(Exception):
    pass


class Loader(Unit, IResultProvider):
    """Serves the indices of minibatches of a 3-class dataset.

    Subclasses implement (reference ILoader, base.py:100-120):

    - ``load_data()`` — fill ``class_lengths``;
    - ``create_minibatch_data()`` — allocate ``minibatch_data``, which
      gives the first forward its input shape;
    - ``analyze_dataset()`` — the normalization analysis pass
      (``prepare_restored_dataset()`` in its place after a restore);
    - ``fill_indices(start, count)`` — serve
      ``shuffled_indices[start:start + count]``; True when the minibatch
      needs no host fill (the consumer gathers it, or the loader did on
      its device);
    - ``fill_minibatch()`` — the host-side gather of the minibatch at
      ``minibatch_indices`` into ``minibatch_data`` (and
      ``raw_minibatch_labels``).
    """

    LABEL_DTYPE = numpy.int32
    INDEX_DTYPE = numpy.int32

    hide_from_registry = True
    #: ``run()`` may be served ahead by a MinibatchPrefetcher; a loader
    #: whose ``run()`` does more than serve minibatches opts out
    supports_prefetch = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "LOADER"
        self.max_minibatch_size = kwargs.get("minibatch_size", 100)
        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]
        self.minibatch_data = Array()
        self.minibatch_labels = Array()
        self.minibatch_indices = Array()
        self.raw_minibatch_labels = []
        #: set by a consumer that gathers on the device itself (the fused
        #: step): the loader then serves indices only
        self.defer_device_gather = False
        self.minibatch_size = 0
        self.minibatch_offset = 0
        self.minibatch_class = TRAIN
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        self.train_ended = Bool(False)
        self.valid_ended = Bool(False)
        self.epoch_number = 0
        self.samples_served = 0
        self.shuffled_indices = Array()
        self.shuffle_limit = kwargs.get(
            "shuffle_limit", numpy.iinfo(numpy.uint32).max)
        self.prng = kwargs.get("prng", prng.get())
        self.normalizer = normalization.factory(
            kwargs.get("normalization_type", "none"),
            **kwargs.get("normalization_parameters", {}))
        # ensemble training subsets (root.common.ensemble.train_ratio);
        # the per-loader kwarg wins
        self.train_ratio = float(kwargs.get(
            "train_ratio",
            root.common.ensemble.get("train_ratio", 1.0) or 1.0))
        self.has_labels = True
        self.labels_mapping = {}
        #: a testing loader analyzes and shuffles again when restored
        self.testing = bool(kwargs.get("testing", False))
        self._global_offset = 0
        #: minibatch definitions (end offset, size) to serve again first
        self.failed_minibatches = []

    def init_unpickled(self):
        super().init_unpickled()
        self.pending_minibatches_ = collections.defaultdict(list)
        # set by an attached MinibatchPrefetcher; a restored workflow
        # attaches a new one at initialize
        self.prefetcher_ = None
        self.prefetch_staged_ = None

    def __setstate__(self, state):
        # snapshots written before the requeue list existed restore
        state.setdefault("failed_minibatches", [])
        super().__setstate__(state)

    # -- derived sizes -------------------------------------------------------
    @property
    def total_samples(self):
        return sum(self.class_lengths)

    @property
    def effective_train_length(self):
        return int(self.class_lengths[TRAIN] * self.train_ratio)

    @property
    def effective_total(self):
        return (self.class_lengths[TEST] + self.class_lengths[VALID] +
                self.effective_train_length)

    def class_of_offset(self, offset):
        """Which class the (1-based end) offset falls in."""
        for cls in (TEST, VALID, TRAIN):
            if offset <= self.class_end_offsets[cls] and \
                    self.class_lengths[cls]:
                return cls
        return TRAIN

    # -- ILoader interface ---------------------------------------------------
    #: methods every concrete loader must implement (reference ILoader,
    #: checked at initialize by verified.verify_contract)
    CONTRACT = ("load_data", "create_minibatch_data", "analyze_dataset",
                "fill_indices", "fill_minibatch")

    def load_data(self):
        raise NotImplementedError

    def create_minibatch_data(self):
        raise NotImplementedError

    def analyze_dataset(self):
        raise NotImplementedError

    def fill_indices(self, start_offset, count):
        """Copy ``shuffled_indices[start_offset:start_offset + count]``
        into ``minibatch_indices``; True when the data gather is the
        consumer's (reference base.py:736-744)."""
        self.minibatch_indices.map_write()[:count] = \
            self.shuffled_indices[start_offset:start_offset + count]
        return self.defer_device_gather

    def fill_minibatch(self):
        raise NotImplementedError

    def prepare_restored_dataset(self):
        """Apply the restored normalizer state after a snapshot restore
        (loaders that bake normalization into a resident dataset
        override)."""

    def normalize_minibatch(self):
        self.normalizer.normalize(
            self.minibatch_data.map_write()[:self.minibatch_size])

    def materialize_minibatch(self):
        """Make ``minibatch_data`` / ``minibatch_labels`` hold the
        current minibatch on the host: a no-op where the loader served
        it there; a loader whose gather is the consumer's fills them on
        demand.  Host-side readers call it before reading the Arrays."""
        if self.defer_device_gather:
            self.fill_minibatch()
            self.map_minibatch_labels()

    def map_minibatch_labels(self):
        """Raw labels → dense ints (``labels_mapping``) into
        ``minibatch_labels``."""
        if not self.has_labels:
            return
        mem = self.minibatch_labels.map_write()
        for i, raw in enumerate(
                self.raw_minibatch_labels[:self.minibatch_size]):
            if raw is None:
                continue
            mem[i] = self.labels_mapping.setdefault(
                raw, len(self.labels_mapping))

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, device=None, **kwargs):
        from ..verified import verify_contract
        verify_contract(self, Loader)
        super().initialize(**kwargs)
        self.load_data()
        if sum(self.class_lengths) == 0:
            raise LoaderError("empty dataset")
        offset = 0
        for cls in (TEST, VALID, TRAIN):
            offset += self.class_lengths[cls]
            self.class_end_offsets[cls] = offset
        self.max_minibatch_size = min(self.max_minibatch_size,
                                      max(self.class_lengths))
        self.minibatch_labels.reset(
            numpy.zeros(self.max_minibatch_size, self.LABEL_DTYPE)
            if self.has_labels else None)
        self.minibatch_indices.reset(
            numpy.zeros(self.max_minibatch_size, self.INDEX_DTYPE))
        self.raw_minibatch_labels = [None] * self.max_minibatch_size
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise LoaderError(
                "minibatch_data MUST be initialized in "
                "create_minibatch_data()")
        restored = getattr(self.workflow, "restored_from_snapshot", False)
        if not restored or self.testing:
            self.analyze_dataset()
            self.shuffle()
            self._global_offset = 0
        else:
            # the normalizer's statistics, the shuffle order, the
            # offset and the prng came back with the snapshot: analyzing
            # or shuffling again would move the run off its course; only
            # apply the restored state to the reloaded data
            self.prepare_restored_dataset()
        if device is not None:
            for arr in (self.minibatch_data, self.minibatch_labels,
                        self.minibatch_indices):
                arr.initialize(device)

    def run(self):
        """Serve one minibatch (with a MinibatchPrefetcher attached, this
        runs ahead on its worker and ``run()`` installs the next one)."""
        self.serve_next_minibatch()
        # served and consumed at once: nothing is outstanding
        self.pending_minibatches_.pop(None, None)
        self._on_successful_serve()

    # -- serving -------------------------------------------------------------
    def shuffle(self):
        """Shuffle the train segment only (reference base.py:711-724)."""
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=self.INDEX_DTYPE)
        if self.shuffle_limit <= 0 or self.class_lengths[TRAIN] == 0:
            return
        self.shuffle_limit -= 1
        self.prng.shuffle(
            self.shuffled_indices.map_write()[self.class_end_offsets[VALID]:])

    def _advance_global_offset(self):
        """Next (end_offset, size) pair; wraps into a new epoch."""
        if self._global_offset >= self.effective_total:
            self._global_offset = 0
            self.epoch_number += 1
            self.shuffle()
        cls = self.class_of_offset(self._global_offset + 1)
        size = min(self.max_minibatch_size,
                   self._class_end(cls) - self._global_offset)
        self._global_offset += size
        return self._global_offset, size

    def serve_next_minibatch(self, slave_id=None):
        try:
            minibatch_def = self.failed_minibatches.pop()
        except IndexError:
            minibatch_def = self._advance_global_offset()
        self.pending_minibatches_[slave_id].append(minibatch_def)
        self.minibatch_offset, self.minibatch_size = minibatch_def
        self.minibatch_class = self.class_of_offset(self.minibatch_offset)
        if self.fill_indices(self.minibatch_offset - self.minibatch_size,
                             self.minibatch_size):
            return
        self.fill_minibatch()
        self.normalize_minibatch()
        self.map_minibatch_labels()
        if self.minibatch_size < self.max_minibatch_size:
            self.minibatch_data.map_write()[self.minibatch_size:] = 0
            if self.has_labels:
                self.minibatch_labels.map_write()[self.minibatch_size:] = -1
            self.minibatch_indices.map_write()[self.minibatch_size:] = -1

    def _class_end(self, cls):
        if cls == TRAIN:
            return (self.class_end_offsets[VALID] +
                    self.effective_train_length)
        return self.class_end_offsets[cls]

    def _on_successful_serve(self):
        self.samples_served += self.minibatch_size
        # no class ends while a minibatch is outstanding or requeued
        # (reference base.py:863-871); the class is judged at the
        # generator's position
        if self.failed_minibatches or any(
                self.pending_minibatches_.values()):
            for flag in (self.last_minibatch, self.train_ended,
                         self.valid_ended, self.epoch_ended):
                flag <<= False
            return
        cls = self.class_of_offset(self._global_offset)
        done = self._global_offset >= self._class_end(cls)
        self.last_minibatch <<= done
        self.train_ended <<= done and cls == TRAIN
        self.valid_ended <<= done and cls == VALID
        # epoch ends once the last class with samples completes
        last_cls = TRAIN if self.class_lengths[TRAIN] else (
            VALID if self.class_lengths[VALID] else TEST)
        self.epoch_ended <<= done and cls == last_cls

    # -- IResultProvider -----------------------------------------------------
    def get_metric_values(self):
        return {"Total epochs": self.epoch_number}
