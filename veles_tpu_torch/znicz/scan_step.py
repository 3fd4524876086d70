"""ScanEpochStep: one whole dataset class per ``run()``, as CUDA-graph
replays on the card.

The port of ``veles_tpu/znicz/scan_step.py``.  The per-step fused path
pays the host's Python and launch time on every minibatch (some 90
launches a step); the JAX unit folds a whole class (every train, or
every validation, minibatch of the epoch) into one ``lax.scan``.  Its
form here is one CUDA graph of the train step and one of the eval step
(``torch.cuda.CUDAGraph``), each replayed once per minibatch of the
class:

- **Inputs read in the graph.**  The step's body reads its minibatch
  from static device buffers: the class's index matrix ``[rows, B]``,
  ``sizes [rows]``, ``seeds [rows]`` and a 0-d int64 position ``pos``.
  Its first operations select row ``pos``; its last is ``pos += 1``.  A
  class is one upload into the buffers (pinned, asynchronous),
  ``pos.zero_()``, a replay per minibatch and one metric flush.
- **State written in place.**  Parameters, solver state
  (``FusedTrainStep._train_step(in_place=True)``), the metric
  accumulator and the per-row losses stay the tensors the graph was
  captured with.  The learning rate is the host's product, as in the
  per-step path, so a graph is captured for one ``lr_scale`` and again
  when it moves.
- **Warm-up spends no state twice.**  The first ``WARMUP_ROWS`` rows a
  graph ever runs are real steps, run eagerly on a side stream (the
  lazy initialization of autograd, cuDNN and the autotuner's sites
  happens there); then the graph is captured and replays the rest.  A
  capture that fails raises: the card never loops eager steps instead.
- **Launch counts.**  The kernel wrappers count on the host, once while
  a graph captures and never while it replays: the capture's counts are
  taken back and added again at every replay (:mod:`.._build`), so they
  stay what the card ran.
- **Transient.**  Graphs, buffers and the warm-up record end in ``_``:
  a pickle drops them, and ``load_state()`` (a restore, a new
  ``initialize``) and a ``train_epochs`` run longer than the buffers
  drop them too; the next class captures again.

On the CPU the same body runs eagerly, row by row, through the same
buffers and position counter: the plain version, equal bit for bit to
the per-step path.  Like the JAX unit it gathers from a
``FullBatchLoader``'s resident dataset and drives the loader's counters,
shuffle and ``last_minibatch`` / ``train_ended`` / ``valid_ended`` /
``epoch_ended`` flags itself, so a Decision sees the per-step protocol
at class granularity; ``StandardWorkflow(epoch_scan=True)`` blocks the
loader and links this unit from the repeater.
"""

import gc
import time

import numpy
import torch

from .. import _build
from .. import loader as loader_mod
from ..loader.fullbatch import FullBatchLoader
from .fused import FusedTrainStep

__all__ = ["ScanEpochStep", "WARMUP_ROWS"]

#: the eager rows that warm each graph's kernels up before its capture
WARMUP_ROWS = 2


class ScanEpochStep(FusedTrainStep):
    """FusedTrainStep that consumes one whole class per ``run()``."""

    def __init__(self, workflow, forwards, gd_units, loss="softmax",
                 **kwargs):
        super().__init__(workflow, forwards, gd_units, loss=loss, **kwargs)
        self.loader = None          # set by link_scan_loader
        self._class_cursor = 0
        self._epochs_done = 0
        #: graphs captured, rows replayed, rows run eagerly (the CPU's,
        #: and the card's warm-up), and the host's seconds in the replay
        #: loops
        self.captures = 0
        self.replays = 0
        self.eager_rows = 0
        self.replay_s = 0.0

    def init_unpickled(self):
        super().init_unpickled()
        self._drop_graphs()

    def _drop_graphs(self):
        self._graphs_ = {}      # "train" / "eval" -> (key, graph, launches)
        self._buf_ = None       # the static inputs (_buffers)
        self._warm_ = set()     # the kinds whose rows ran eagerly once

    def link_scan_loader(self, loader):
        """Drive ``loader`` (a FullBatchLoader) and gather from its
        resident dataset."""
        if not isinstance(loader, FullBatchLoader):
            raise TypeError(
                "the epoch scan gathers each class from a resident "
                "dataset and needs a FullBatchLoader, got %r; train it "
                "per step (epoch_scan=False)" % (loader,))
        self.loader = loader
        # the attribute links a Decision reads stay coherent
        self.link_loader(loader)
        self.gather_loader = loader
        loader.defer_device_gather = True
        return self

    def initialize(self, device=None, **kwargs):
        if not self.loader.is_initialized:
            # normally the loader precedes this unit in the dependency
            # walk; this covers hand-built workflows
            self.loader.initialize(device=device, **kwargs)
        super().initialize(device=device, **kwargs)
        self._graphed_ = self._dev_.type == "cuda"

    def load_state(self):
        super().load_state()
        # new parameter, solver and accumulator tensors: no graph reads
        # them yet
        self._drop_graphs()

    # -- the static inputs and the body --------------------------------------
    def _buffers(self, rows):
        """The static inputs, for at least ``rows`` minibatches and for
        the largest class (so both graphs read one set); growing them
        drops every graph (they read the old tensors)."""
        buf = self._buf_
        if buf is not None and buf["rows"] >= rows:
            return buf
        B = self.loader.max_minibatch_size
        rows = max([rows] + [
            -(-(self.loader._class_end(c) - (
                0 if c == loader_mod.TEST else
                self.loader.class_end_offsets[c - 1])) // B)
            for c in self._classes_with_samples()])
        dev = self._dev_
        self._graphs_ = {}
        self._buf_ = buf = {
            "rows": rows,
            "idx": torch.zeros((rows, B), dtype=torch.int32, device=dev),
            "sizes": torch.zeros(rows, dtype=torch.int64, device=dev),
            "seeds": torch.zeros(rows, dtype=torch.int64, device=dev),
            "losses": torch.zeros(rows, dtype=torch.float32, device=dev),
            "pos": torch.zeros((), dtype=torch.int64, device=dev)}
        return buf

    def _upload(self, idx, sizes, seeds):
        """One copy of each host array into the buffers (pinned and
        asynchronous on the card); ``pos`` back to row 0."""
        buf = self._buffers(len(sizes))
        n = len(sizes)
        for name, host in (("idx", idx), ("sizes", sizes),
                           ("seeds", seeds)):
            if host is None:
                continue
            src = torch.from_numpy(numpy.ascontiguousarray(host))
            if self._dev_.type == "cuda":
                src = src.pin_memory()
            buf[name][:n].copy_(src, non_blocking=True)
        buf["pos"].zero_()
        return buf

    def _row(self, buf, train):
        """One minibatch: row ``pos`` of the buffers, then ``pos += 1``.
        Every value it reads lives on the step's device."""
        pos = buf["pos"].view(1)
        idx = buf["idx"].index_select(0, pos)[0]
        size = buf["sizes"].index_select(0, pos)[0]
        x, y = self._gather(idx)
        mask = self._mask(x.shape[0], size)
        if train:
            seed = buf["seeds"].index_select(0, pos)[0]
            loss, _ = self._train_step(x, y, mask, seed, in_place=True)
        else:
            loss, _ = self._eval_step(x, y, mask)
        buf["losses"].index_copy_(0, pos, loss.view(1))
        buf["pos"].add_(1)

    def _capture(self, buf, train):
        """One CUDA graph of :meth:`_row`; -> (graph, the launches one
        replay makes).  Capturing runs nothing: its counts are taken
        back.  Python's cyclic collector is off during the capture: a
        dead workflow's graphs collected there would reset on the
        capturing stream, which CUDA refuses (fault C17); what it would
        have collected waits for its next run."""
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._row(buf, train)
        finally:
            if collecting:
                gc.enable()
        delta = _build.launch_delta(before)
        _build.add_launches(delta, -1)
        self.captures += 1
        return graph, delta

    def _run_rows(self, kind, buf, n):
        """Rows 0..n-1 of the uploaded class: replays of the ``kind``
        graph on the card (after the warm-up rows of its first class),
        eager rows on the CPU."""
        train = kind == "train"
        if not self._graphed_:
            for _ in range(n):
                self._row(buf, train)
            self.eager_rows += n
            return
        done = 0
        if kind not in self._warm_:
            done = min(WARMUP_ROWS, n)
            current = torch.cuda.current_stream(self._dev_)
            side = torch.cuda.Stream(self._dev_)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(done):
                    self._row(buf, train)
            current.wait_stream(side)
            self._warm_.add(kind)
            self.eager_rows += done
        if done == n:
            return
        key = float(self.lr_scale) if train else None
        entry = self._graphs_.get(kind)
        if entry is None or entry[0] != key:
            entry = self._graphs_[kind] = (key,) + self._capture(buf, train)
        graph, delta = entry[1:]
        t0 = time.perf_counter()
        for _ in range(n - done):
            graph.replay()
        self.replay_s += time.perf_counter() - t0
        _build.add_launches(delta, n - done)
        self.replays += n - done

    def _run_class(self, idx, sizes, seeds=None):
        """Train (``seeds`` given) or evaluate over one class's index
        matrix; ``loss`` is its last minibatch's."""
        n = len(sizes)
        buf = self._upload(idx, sizes.astype(numpy.int64), seeds)
        train = seeds is not None
        self._run_rows("train" if train else "eval", buf, n)
        self.loss = buf["losses"][n - 1].clone()
        if train:
            self.train_steps += n
        else:
            self.eval_steps += n

    def _next_seeds(self, n):
        """The consecutive per-minibatch seeds the per-step path's
        counter would give, and the counter moved past them."""
        seeds = numpy.arange(self._seed_counter + 1,
                             self._seed_counter + 1 + n,
                             dtype=numpy.int64) % 0x7FFF0000
        self._seed_counter = (self._seed_counter + n) % 0x7FFF0000
        return seeds

    # -- epoch driving -------------------------------------------------------
    def _classes_with_samples(self):
        return [c for c in (loader_mod.TEST, loader_mod.VALID,
                            loader_mod.TRAIN)
                if self.loader.class_lengths[c] > 0]

    def _class_index_matrix(self, cls):
        """(idx [nb, B], sizes [nb]) over the class's shuffled span; a
        short last row is padded with its own first index, as the
        per-step loader pads (masked by its size)."""
        ld = self.loader
        start = 0 if cls == loader_mod.TEST else ld.class_end_offsets[
            cls - 1]
        end = ld._class_end(cls)
        span = numpy.asarray(ld.shuffled_indices.map_read()[start:end])
        B = ld.max_minibatch_size
        nb = (len(span) + B - 1) // B
        idx = numpy.empty((nb, B), ld.INDEX_DTYPE)
        sizes = numpy.empty(nb, numpy.int32)
        for i in range(nb):
            chunk = span[i * B:(i + 1) * B]
            sizes[i] = len(chunk)
            idx[i, :len(chunk)] = chunk
            if len(chunk) < B:
                idx[i, len(chunk):] = chunk[0]
        return idx, sizes

    def run(self):
        ld = self.loader
        classes = self._classes_with_samples()
        if self._class_cursor == 0 and self._epochs_done:
            # where the per-step loader wraps: a new epoch
            ld.epoch_number += 1
            ld.shuffle()
        cls = classes[self._class_cursor]
        idx, sizes = self._class_index_matrix(cls)
        self._run_class(idx, sizes, self._next_seeds(len(sizes))
                        if cls == loader_mod.TRAIN else None)
        ld.samples_served += int(sizes.sum())
        # the loader protocol, so a Decision sees normal class ends
        ld.minibatch_class = cls
        ld.minibatch_size = int(sizes[-1])
        last = self._class_cursor == len(classes) - 1
        self._class_cursor = 0 if last else self._class_cursor + 1
        ld.last_minibatch <<= True
        ld.train_ended <<= cls == loader_mod.TRAIN
        ld.valid_ended <<= cls == loader_mod.VALID
        ld.epoch_ended <<= last
        if last:
            self._epochs_done += 1
        self._flush_metrics()
        self.sync_weights()

    # -- bulk training -------------------------------------------------------
    def train_epochs(self, n_epochs):
        """Train ``n_epochs`` whole TRAIN classes in one upload and one
        run of replays, with one metric flush: the epochs' shuffles are
        made on the host first and their index matrices stacked.  No
        Decision runs between them."""
        ld = self.loader
        chunks = []
        for _ in range(n_epochs):
            if self._epochs_done:
                ld.epoch_number += 1
                ld.shuffle()
            chunks.append(self._class_index_matrix(loader_mod.TRAIN))
            self._epochs_done += 1
        idx = numpy.concatenate([c[0] for c in chunks])
        sizes = numpy.concatenate([c[1] for c in chunks])
        self._run_class(idx, sizes, self._next_seeds(len(sizes)))
        ld.samples_served += int(sizes.sum())
        ld.minibatch_class = loader_mod.TRAIN
        self._flush_metrics()
        self.sync_weights()
