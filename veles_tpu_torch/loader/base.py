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

A loader serves indices only: the consumer (the fused train step)
gathers the minibatch from the dataset on the device, the JAX
package's ``defer_device_gather`` mode.  Not ported yet: the host-side
serving path (``fill_minibatch`` and its normalize / label-mapping
steps, which the JAX package's graph mode and non-resident loaders
run), the master/slave index distribution (the ``IDistributable``
half, with slice 4's distribution) and the background prefetcher.
"""

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
    - ``analyze_dataset()`` — the normalization analysis pass;
    - ``fill_indices(start, count)`` — serve
      ``shuffled_indices[start:start + count]`` to the consumer that
      gathers them (FullBatchLoader).
    """

    LABEL_DTYPE = numpy.int32
    INDEX_DTYPE = numpy.int32

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "LOADER"
        self.max_minibatch_size = kwargs.get("minibatch_size", 100)
        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]
        self.minibatch_data = Array()
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
        self._global_offset = 0

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
                "fill_indices")

    def load_data(self):
        raise NotImplementedError

    def create_minibatch_data(self):
        raise NotImplementedError

    def analyze_dataset(self):
        raise NotImplementedError

    def fill_indices(self, start_offset, count):
        """Serve ``shuffled_indices[start_offset:start_offset + count]``
        (reference base.py:736-744)."""
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, **kwargs):
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
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise LoaderError(
                "minibatch_data MUST be initialized in "
                "create_minibatch_data()")
        self.analyze_dataset()
        self.shuffle()
        self._global_offset = 0

    def run(self):
        """Serve one minibatch."""
        self.serve_next_minibatch()
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

    def serve_next_minibatch(self):
        self.minibatch_offset, self.minibatch_size = \
            self._advance_global_offset()
        self.minibatch_class = self.class_of_offset(self.minibatch_offset)
        self.fill_indices(self.minibatch_offset - self.minibatch_size,
                          self.minibatch_size)

    def _class_end(self, cls):
        if cls == TRAIN:
            return (self.class_end_offsets[VALID] +
                    self.effective_train_length)
        return self.class_end_offsets[cls]

    def _on_successful_serve(self):
        self.samples_served += self.minibatch_size
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
