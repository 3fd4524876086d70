"""The port's ShardedBatchLoader and ``write_shards``, held against the
JAX package.

Mirrors tests/test_shards_loader.py (all seven) with the port's loaders
on the CPU: the on-disk layout and its validation, the minibatch stream
bitwise equal to a FullBatchLoader's over the same arrays through a
window a tenth of the dataset, the window's budget, Belady's single load
per shard under a full window, the windowed shuffle's sequential reads,
the window as transient state, and a ``StandardWorkflow`` trained
bitwise alike with either loader (fused and graph mode).  The dataset
is integer-valued float32, so the float64 analyze pass sums exactly and
every comparison is bitwise.  Beyond the mirrors:

- ``write_shards`` of either package writes byte-identical directories;
- over one directory, each package's ``ShardedBatchLoader`` serves the
  same indices, data, labels, classes and epoch flags as the other's,
  in both shuffle modes;
- a fused workflow fed by a ``ShardedBatchLoader`` snapshotted after 2
  epochs and restored resumes bitwise to the uninterrupted run, its
  window rebuilt empty.
"""

import json
import os
import pickle

import numpy
import pytest

from veles_tpu_torch.backends import Device
from veles_tpu_torch.loader import (FullBatchLoader, ShardedBatchLoader,
                                    TEST, TRAIN, VALID, write_shards)
from veles_tpu_torch.loader.shards import INDEX, SHARD_FMT
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.workflow import Workflow

CLASSES = [10, 20, 60]          # [test|valid|train] of 90 rows, dim 8
CPU = Device(backend="cpu")


def _dataset():
    rng = numpy.random.RandomState(11)
    data = rng.randint(0, 9, (90, 8)).astype(numpy.float32)
    labels = list(int(x) for x in rng.randint(0, 4, 90))
    return data, labels


class _RefLoader(FullBatchLoader):
    """The in-RAM oracle over the same arrays."""

    hide_from_registry = True

    def load_data(self):
        data, labels = _dataset()
        self.original_data.mem = data
        self.original_labels = labels
        (self.class_lengths[TEST], self.class_lengths[VALID],
         self.class_lengths[TRAIN]) = CLASSES


def _write(tmp_path, rows_per_shard=7, write=write_shards, name="ds"):
    data, labels = _dataset()
    return write(str(tmp_path / name), data, labels=labels,
                 class_lengths=CLASSES, rows_per_shard=rows_per_shard)


def _sharded(tmp_path, **kwargs):
    kwargs.setdefault("minibatch_size", 16)
    kwargs.setdefault("prng", RandomGenerator().seed(5))
    kwargs.setdefault("path", str(tmp_path / "ds"))
    loader = ShardedBatchLoader(Workflow(name="w"), **kwargs)
    loader.initialize(device=CPU)
    return loader


def _reference(**kwargs):
    kwargs.setdefault("minibatch_size", 16)
    kwargs.setdefault("prng", RandomGenerator().seed(5))
    loader = _RefLoader(Workflow(name="w"), force_numpy=True, **kwargs)
    loader.initialize(device=CPU)
    return loader


# -- on-disk format -----------------------------------------------------------

def test_write_shards_layout(tmp_path):
    path = _write(tmp_path)
    assert os.path.basename(path) == INDEX
    with open(path) as f:
        index = json.load(f)
    assert [s["rows"] for s in index["shards"]] == [7] * 12 + [6]
    assert index["class_lengths"] == CLASSES
    for k, s in enumerate(index["shards"]):
        assert s["file"] == SHARD_FMT % k
        block = numpy.load(os.path.join(os.path.dirname(path), s["file"]))
        assert block.shape == (s["rows"], 8)
    data, _ = _dataset()
    whole = numpy.concatenate(
        [numpy.load(os.path.join(os.path.dirname(path), s["file"]))
         for s in index["shards"]])
    assert numpy.array_equal(whole, data)


def test_write_shards_validation(tmp_path):
    data, labels = _dataset()
    with pytest.raises(ValueError, match="empty"):
        write_shards(str(tmp_path / "e"), data[:0])
    with pytest.raises(ValueError, match="class_lengths"):
        write_shards(str(tmp_path / "c"), data, class_lengths=[0, 0, 1])
    with pytest.raises(ValueError, match="labels"):
        write_shards(str(tmp_path / "l"), data, labels=labels[:-1],
                     class_lengths=CLASSES)


# -- stream parity ------------------------------------------------------------

def test_stream_bit_identical_to_fullbatch(tmp_path):
    _write(tmp_path)
    ref = _reference(normalization_type="mean_disp")
    sub = _sharded(tmp_path, window_bytes=3 * 7 * 32,   # ~3 of 13 shards
                   normalization_type="mean_disp")
    for step in range(40):                               # > 2 epochs
        ref.run()
        sub.run()
        assert sub.minibatch_class == ref.minibatch_class
        assert sub.minibatch_size == ref.minibatch_size
        assert bool(sub.epoch_ended) == bool(ref.epoch_ended)
        assert sub.epoch_number == ref.epoch_number
        n = ref.minibatch_size
        assert numpy.array_equal(sub.minibatch_data.map_read()[:n],
                                 ref.minibatch_data.map_read()[:n]), step
        assert numpy.array_equal(sub.minibatch_labels.map_read()[:n],
                                 ref.minibatch_labels.map_read()[:n])
    assert sub.window_used_bytes <= 3 * 7 * 32
    assert sub.shard_loads > 13          # tiny window: shards read again


def test_window_never_exceeds_budget(tmp_path):
    _write(tmp_path)
    budget = 2 * 7 * 32
    sub = _sharded(tmp_path, window_bytes=budget)
    for _ in range(30):
        sub.run()
        assert sub.window_used_bytes <= budget
        assert len(sub.shards_cached) <= 2


def test_full_window_loads_each_shard_once(tmp_path):
    _write(tmp_path)
    sub = _sharded(tmp_path, window_bytes=1 << 20)
    for _ in range(40):
        sub.run()
    assert sub.shard_loads == 13


def _stream(loader, steps):
    seen = []
    for _ in range(steps):
        loader.run()
        seen.append(numpy.array(
            loader.minibatch_data.map_read()[:loader.minibatch_size]))
    return seen


def test_windowed_mode_sequential_io_and_determinism(tmp_path):
    _write(tmp_path)
    budget = 2 * 7 * 32
    win = _sharded(tmp_path, window_bytes=budget, shuffle_mode="windowed")
    seen_a = _stream(win, 21)    # 3 epochs of 7 steps
    seen_b = _stream(_sharded(tmp_path, window_bytes=budget,
                              shuffle_mode="windowed"), 21)
    glob = _sharded(tmp_path, window_bytes=budget, shuffle_mode="global")
    _stream(glob, 21)
    for a, b in zip(seen_a, seen_b, strict=True):
        assert numpy.array_equal(a, b)
    assert win.shard_loads < glob.shard_loads / 2
    data, _ = _dataset()
    epoch = numpy.concatenate(seen_a[:7])
    assert numpy.array_equal(numpy.sort(epoch.ravel()),
                             numpy.sort(data.ravel()))


def test_window_state_is_transient(tmp_path):
    _write(tmp_path)
    sub = _sharded(tmp_path, window_bytes=1 << 20)
    for _ in range(5):
        sub.run()
    assert sub.shard_loads > 0
    assert "_window_" not in sub.__getstate__()
    blob = pickle.dumps(sub)
    assert len(blob) < 64 << 10
    back = pickle.loads(blob)
    assert back.shard_loads == 0 and not back.shards_cached


# -- end to end under StandardWorkflow ----------------------------------------

def _blobs_dir(tmp_path):
    from test_torch_snapshot import BlobLoader
    probe = BlobLoader(Workflow(name="probe"),
                       prng=RandomGenerator().seed(5))
    probe.load_data()
    write_shards(str(tmp_path / "blobs"),
                 numpy.asarray(probe.original_data.mem),
                 labels=probe.original_labels,
                 class_lengths=list(probe.class_lengths),
                 rows_per_shard=16)
    return str(tmp_path / "blobs")


def _build(factory, loader_kwargs, fused=True, epochs=4, snap=None):
    from test_torch_snapshot import LAYERS
    import veles_tpu_torch.prng.random_generator as rg
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    rg._generators.clear()
    rg.get(0).seed(77)
    kwargs = dict(minibatch_size=25, prng=RandomGenerator().seed(5))
    kwargs.update(loader_kwargs)
    extra = {"snapshotter": snap} if snap else {}
    wf = StandardWorkflow(
        None, name="std", loader_factory=factory, loader=kwargs,
        layers=LAYERS, loss_function="softmax",
        decision={"max_epochs": epochs, "silent": True}, fused=fused,
        **extra)
    wf.initialize(device=CPU)
    return wf


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
def test_standard_workflow_trains_bitwise_vs_fullbatch(tmp_path, fused):
    """The loader swapped under an unmodified StandardWorkflow: the
    trained weights equal the FullBatchLoader run's bit for bit (in
    fused mode the step runs on the loader's host minibatches)."""
    from test_torch_snapshot import BlobLoader
    path = _blobs_dir(tmp_path)
    ref = _build(BlobLoader, {}, fused)
    ref.run()
    sub = _build(ShardedBatchLoader,
                 {"path": path, "window_bytes": 3 * 16 * 32}, fused)
    if fused:
        assert not sub.fused_step._use_gather_
    sub.run()
    assert sub.loader.shard_loads > 0
    assert sub.loader.window_used_bytes <= 3 * 16 * 32
    for a, b in zip(ref.forwards, sub.forwards):
        assert numpy.array_equal(a.weights.map_read(), b.weights.map_read())
        assert numpy.array_equal(a.bias.map_read(), b.bias.map_read())


def test_sharded_workflow_resumes_bitwise(tmp_path):
    from veles_tpu_torch.snapshotter import restore
    path = _blobs_dir(tmp_path)
    loader = {"path": path, "window_bytes": 3 * 16 * 32}
    ref = _build(ShardedBatchLoader, loader, epochs=6)
    ref.run()
    _build(ShardedBatchLoader, loader, epochs=2, snap={
        "prefix": "s", "directory": str(tmp_path / "snaps"),
        "time_interval": 0}).run()
    resumed = restore(str(tmp_path / "snaps" / "s_current"))
    assert resumed.loader.shard_loads == 0
    resumed.decision.max_epochs = 6
    resumed.initialize(device=CPU)
    resumed.run()
    assert resumed.loader.shard_loads > 0
    assert resumed.decision.epoch_n_err == ref.decision.epoch_n_err
    for a, b in zip(ref.forwards, resumed.forwards):
        assert numpy.array_equal(a.weights.map_read(), b.weights.map_read())
        assert numpy.array_equal(a.bias.map_read(), b.bias.map_read())


# -- the port against the JAX package -----------------------------------------

def test_write_shards_directories_are_byte_identical(tmp_path):
    from veles_tpu.loader import write_shards as jax_write_shards
    for rows in (7, 90):
        port = os.path.dirname(_write(tmp_path, rows, name="port%d" % rows))
        jax = os.path.dirname(_write(tmp_path, rows, jax_write_shards,
                                     name="jax%d" % rows))
        names = sorted(os.listdir(port))
        assert names == sorted(os.listdir(jax))
        for name in names:
            with open(os.path.join(port, name), "rb") as a, \
                    open(os.path.join(jax, name), "rb") as b:
                assert a.read() == b.read(), name


@pytest.mark.parametrize("mode", ["global", "windowed"])
def test_each_package_serves_the_same_stream(tmp_path, mode):
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.loader import ShardedBatchLoader as JaxSharded
    from veles_tpu.prng import RandomGenerator as JaxRandom
    from veles_tpu.workflow import Workflow as JaxWorkflow
    _write(tmp_path)
    kwargs = dict(minibatch_size=16, path=str(tmp_path / "ds"),
                  window_bytes=3 * 7 * 32, shuffle_mode=mode,
                  normalization_type="mean_disp")
    port = _sharded(tmp_path, **kwargs)
    jax = JaxSharded(JaxWorkflow(name="w"), prng=JaxRandom().seed(5),
                     **kwargs)
    jax.initialize(device=JaxDevice(backend="numpy"))
    for step in range(40):
        port.run()
        jax.run()
        assert (port.minibatch_class, port.minibatch_size,
                port.epoch_number, bool(port.epoch_ended)) == \
            (jax.minibatch_class, jax.minibatch_size, jax.epoch_number,
             bool(jax.epoch_ended)), step
        n = port.minibatch_size
        for name in ("minibatch_indices", "minibatch_data",
                     "minibatch_labels"):
            assert numpy.array_equal(
                getattr(port, name).map_read()[:n],
                numpy.asarray(getattr(jax, name).map_read())[:n]), \
                (step, name)
    assert port.shard_loads == jax.shard_loads
