"""The port's snapshotter and resumed training, held against the JAX
package.

Mirrors tests/test_snapshotter.py (all nine), tests/test_snapshot_async.py
(ten of eleven: ``test_roundtrip_with_prefetcher_and_distributed_step``
waits for ``parallel/``, ROADMAP queue A item 11; its half without a
mesh is in tests/test_torch_scan_prefetch.py) and
tests/test_snapshot_crash.py (a child process that imports only the
port is killed mid-write), on the JAX tests' gaussian blobs from the
same seeds, with the port's ``StandardWorkflow`` on the CPU.  Beyond
the mirrors:

- fault C11: a fused workflow pickled after one epoch initializes again
  and trains on (the parent raised ``TypeError`` in ``initialize``);
- fault C12: a restored fused step goes on from the snapshot's
  confusion matrix (the parent started it again from zero);
- resume equals the uninterrupted run BIT FOR BIT in fused and graph
  mode, with the pickle and the sharded backend, for the MNIST sample
  (600 + 200 digits), the LRN convnet with dropout (every dropout mask
  of the resumed epochs equal to the uninterrupted run's), the
  attention unit and the MSE regression;
- the port against the JAX package: the MNIST sample from the same
  seeds, 3 epochs, a snapshot, a restore and 3 more, in each package:
  weights within the MNIST tests' 2e-6 (f32 summation order, XLA's dot
  against torch's matmul), each class's n_err equal;
- ``restore`` over ``sqlite://``, a directory, ``manifest.json`` and
  ``http://`` (an ``http.server`` on 127.0.0.1);
- the normalizers' snapshot ``state`` equals the JAX normalizers' on
  the same data, and survives a pickle.
"""

import glob
import http.server
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy
import pytest
import torch

from veles_tpu_torch import loader as loader_mod
from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import root
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.snapshotter import (SnapshotterToDB, SnapshotterToFile,
                                         SnapshotWriter, restore)
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = Device(backend="cpu")
#: the MNIST tests' cross-package tolerance (tests/test_torch_mnist.py)
JAX_WEIGHT_ATOL = 2e-6

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 20},
     "<-": {"learning_rate": 0.2, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.2, "gradient_moment": 0.9}},
]


class BlobLoader(loader_mod.FullBatchLoader):
    """tests/test_standard_workflow.py's gaussian blobs: 4 classes in 8
    dimensions, 50 validation and 150 train samples."""

    hide_from_registry = True

    def load_data(self):
        rng = numpy.random.RandomState(4)
        centers = rng.uniform(-2, 2, (4, 8))
        data, labels = [], []
        for c in range(4):
            data.append(centers[c] + 0.35 * rng.standard_normal((50, 8)))
            labels += [c] * 50
        data = numpy.concatenate(data).astype(numpy.float32)
        order = rng.permutation(len(data))
        self.original_data.mem = data[order]
        self.original_labels = list(numpy.array(labels)[order])
        self.class_lengths[loader_mod.TEST] = 0
        self.class_lengths[loader_mod.VALID] = 50
        self.class_lengths[loader_mod.TRAIN] = 150


def build(max_epochs, tmp_path=None, fused=True, seed=31, snap_kwargs=None,
          minibatch=25, **wf_kwargs):
    """The JAX tests' ``build``: the blob workflow on the CPU, with a
    snapshotter into ``tmp_path`` when it is given."""
    import veles_tpu_torch.prng.random_generator as rg
    rg._generators.clear()
    rg.get(0).seed(seed)
    if tmp_path is not None:
        cfg = {"prefix": "blob", "directory": str(tmp_path),
               "time_interval": 0, "compression": "gz"}
        cfg.update(snap_kwargs or {})
        wf_kwargs["snapshotter"] = cfg
    wf = StandardWorkflow(
        None, name="snapwf", loader_factory=BlobLoader,
        loader={"minibatch_size": minibatch,
                "prng": RandomGenerator().seed(5)},
        layers=LAYERS, loss_function="softmax",
        decision={"max_epochs": max_epochs, "silent": True},
        fused=fused, **wf_kwargs)
    wf.initialize(device=CPU)
    return wf


def _resume(path, max_epochs):
    wf = restore(path)
    assert wf.restored_from_snapshot
    wf.decision.max_epochs = max_epochs
    wf.initialize(device=CPU)
    wf.run()
    return wf


def _params(wf):
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def _assert_bitwise(got, want):
    for g, w in zip(got, want, strict=True):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype
            assert numpy.array_equal(g[name], w[name]), name


def _writer_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("veles-snapwriter")}


# -- tests/test_snapshotter.py ------------------------------------------------

def test_snapshot_resume_equals_uninterrupted(tmp_path):
    ref = build(6)
    ref.run()
    part = build(3, tmp_path)
    part.run()
    assert glob.glob(str(tmp_path / "blob*.pickle.gz")), "no snapshot"
    current = str(tmp_path / "blob_current")
    assert os.path.islink(current)
    resumed = _resume(current, 6)
    assert resumed.loader.epoch_number == ref.loader.epoch_number
    for fr, fu in zip(resumed.forwards, ref.forwards):
        assert numpy.allclose(fr.weights.map_read(), fu.weights.map_read(),
                              atol=1e-5), type(fr).__name__
    assert resumed.decision.epoch_n_err_pt[1] == \
        pytest.approx(ref.decision.epoch_n_err_pt[1], abs=1e-9)


def test_snapshot_resume_graph_mode(tmp_path):
    part = build(2, tmp_path, fused=False)
    part.run()
    resumed = _resume(str(tmp_path / "blob_current"), 4)
    assert resumed.is_finished
    assert resumed.loader.epoch_number == 3
    assert resumed.decision.best_n_err_pt is not None


def test_snapshotter_unit_throttling(tmp_path):
    wf = build(2, tmp_path)
    snap = wf.snapshotter
    snap.interval = 2
    snap.time_interval = 0
    wf.run()
    assert len(glob.glob(str(tmp_path / "blob*.pickle.gz"))) <= 2


def test_snapshot_best_metric_suffix(tmp_path):
    wf = build(3, tmp_path)
    wf.snapshotter.time_interval = 10 ** 6   # drops every shot but the
    wf.run()                                 # improvements
    names = [os.path.basename(p)
             for p in glob.glob(str(tmp_path / "blob*.pickle.gz"))]
    assert names, "improvement snapshots were throttled away"
    best = "validation_%.2f" % wf.decision.best_n_err_pt
    assert any(best in n for n in names), (best, names)


def test_snapshot_weights_scored_the_named_metric(tmp_path):
    import re
    wf = build(4, tmp_path)
    wf.snapshotter.time_interval = 0
    wf.run()

    def metric(p):
        return float(re.search(r"validation_([0-9.]+?)\.\d+\.pickle",
                               os.path.basename(p)).group(1))
    best = sorted(glob.glob(str(tmp_path / "blob_validation_*.pickle.gz")),
                  key=metric)[0]
    resumed = restore(best)
    resumed.decision.max_epochs = resumed.loader.epoch_number + 1
    for gd in resumed.gds:
        gd.learning_rate = 0.0
        gd.learning_rate_bias = 0.0
    resumed.initialize(device=CPU)
    resumed.run()
    assert resumed.decision.epoch_n_err_pt[1] <= metric(best) + 1e-6


def test_import_rejects_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        SnapshotterToFile.import_file(str(tmp_path / "nope.pickle"))


def test_throttle_uses_monotonic_clock(tmp_path, monkeypatch):
    import veles_tpu_torch.snapshotter as snapshotter_mod

    class _NoWallClock:
        monotonic = staticmethod(time.monotonic)
        perf_counter = staticmethod(time.perf_counter)
        sleep = staticmethod(time.sleep)

        @staticmethod
        def time():
            raise AssertionError("snapshot throttling read time.time()")

    wf = build(2, tmp_path)
    monkeypatch.setattr(snapshotter_mod, "time", _NoWallClock)
    snap = wf.snapshotter
    snap.skip = Bool(False)
    snap.time_interval = 10 ** 6
    snap.run()                        # first shot: no prior timestamp
    first = snap.destination
    assert first is not None
    snap.run()                        # throttled
    assert snap.destination == first
    assert snap.flush()


def test_compression_level_knob(tmp_path):
    sizes = {}
    prior = root.common.snapshot.get("compression_level", 6)
    try:
        for level in (1, 9):
            root.common.snapshot.compression_level = level
            sub = tmp_path / ("lvl%d" % level)
            sub.mkdir()
            build(2, sub).run()
            snaps = glob.glob(str(sub / "blob*.pickle.gz"))
            assert snaps
            sizes[level] = os.path.getsize(snaps[0])
            restore(snaps[0])
    finally:
        root.common.snapshot.compression_level = prior
    assert sizes[9] <= sizes[1]


def test_report_size_threshold_config_and_logger(tmp_path, caplog):
    import logging
    prior = root.common.snapshot.get("report_size_threshold", 64 << 20)
    try:
        root.common.snapshot.report_size_threshold = 1
        wf = build(2, tmp_path)
        snap = wf.snapshotter
        snap.skip = Bool(False)
        with caplog.at_level(logging.WARNING, logger="SnapshotterToFile"):
            snap.run()
            assert snap.flush()
        assert any("fattest units" in r.message for r in caplog.records)
        caplog.clear()
        root.common.snapshot.report_size_threshold = 0
        with caplog.at_level(logging.WARNING, logger="SnapshotterToFile"):
            snap.run()
            assert snap.flush()
        assert not any("fattest units" in r.message
                       for r in caplog.records)
    finally:
        root.common.snapshot.report_size_threshold = prior


# -- tests/test_snapshot_async.py ---------------------------------------------

def test_finish_flushes_writer_files_complete_no_leaked_threads(tmp_path):
    before = _writer_threads()
    wf = build(3, tmp_path)
    assert wf.snapshotter._async_enabled()
    wf.run()
    assert _writer_threads() <= before
    assert glob.glob(str(tmp_path / "blob*.pickle.gz"))
    assert not glob.glob(str(tmp_path / "*.tmp"))
    current = str(tmp_path / "blob_current")
    assert os.path.islink(current)
    assert restore(current).restored_from_snapshot
    assert wf.snapshotter._writer_._thread is None
    assert wf.snapshotter.writer_stats()["queued"] == 0
    assert wf.snapshotter.stall_s > 0


def test_async_off_is_synchronous(tmp_path):
    wf = build(2, tmp_path, snap_kwargs={"async_write": False})
    snap = wf.snapshotter
    snap.skip = Bool(False)
    snap.run()
    assert os.path.exists(snap.destination)
    assert getattr(snap, "_writer_", None) is None
    restore(snap.destination)


def test_async_restore_parity_with_sync(tmp_path):
    results = {}
    for mode in (False, True):
        sub = tmp_path / ("async" if mode else "sync")
        sub.mkdir()
        build(3, sub, snap_kwargs={"async_write": mode}).run()
        resumed = _resume(str(sub / "blob_current"), 6)
        results[mode] = (resumed.loader.epoch_number,
                         resumed.decision.epoch_n_err_pt[1],
                         _params(resumed))
    assert results[True][:2] == results[False][:2]
    _assert_bitwise(results[True][2], results[False][2])


def test_writer_failure_reraises_on_next_run(tmp_path):
    wf = build(2, tmp_path)
    snap = wf.snapshotter
    snap.skip = Bool(False)

    def boom(obj, path):
        raise OSError("disk on fire")

    snap._write_file = boom
    snap.run()
    deadline = time.monotonic() + 10
    while snap._writer_._failure is None:
        assert time.monotonic() < deadline, "writer never failed"
        time.sleep(0.01)
    with pytest.raises(OSError, match="disk on fire"):
        snap.run()
    del snap._write_file
    snap.run()
    assert snap.flush()


def test_coalescing_drops_oldest_periodic_never_improvements():
    w = SnapshotWriter(name="coalesce-test")
    gate, started, done = threading.Event(), threading.Event(), []

    def job(tag):
        def fn():
            started.set()
            assert gate.wait(10)
            done.append(tag)
        return fn

    w.submit(job("head"), improved=False)
    assert started.wait(10)
    w.submit(job("p1"), improved=False)
    w.submit(job("p2"), improved=False)
    w.submit(job("i1"), improved=True)
    w.submit(job("i2"), improved=True)
    w.submit(job("p3"), improved=False)
    assert w.coalesced == 2
    gate.set()
    assert w.flush(timeout=10)
    assert done == ["head", "i1", "i2", "p3"]
    assert w.stats()["written"] == 4
    w.stop()


def test_queue_depth_is_bounded_for_periodic_shots():
    w = SnapshotWriter(name="depth-test")
    gate, started = threading.Event(), threading.Event()

    def fn():
        started.set()
        gate.wait(10)

    w.submit(fn, improved=False)
    assert started.wait(10)
    for _ in range(50):
        w.submit(fn, improved=False)
    assert w.stats()["queued"] == 1
    assert w.coalesced == 49
    gate.set()
    assert w.flush(timeout=10)
    w.stop()


def test_db_snapshotter_async_roundtrip(tmp_path):
    wf = build(2)
    db = str(tmp_path / "snaps.sqlite3")
    snap = SnapshotterToDB(wf, prefix="blob", database=db, time_interval=0)
    snap.skip = Bool(False)
    try:
        snap.run()
        assert snap._async_enabled()
        assert snap.flush()
        back = SnapshotterToDB.import_db(snap.destination)
        assert back.restored_from_snapshot
        assert len(back.forwards) == len(wf.forwards)
    finally:
        snap.stop()
        wf.del_ref(snap)


def test_multihost_nonzero_process_skips_write(tmp_path, monkeypatch):
    import veles_tpu_torch.snapshotter as snapshotter_mod
    wf = build(2, tmp_path)
    snap = wf.snapshotter
    snap.skip = Bool(False)
    monkeypatch.setattr(snapshotter_mod, "_is_writer_process", False)
    snap.run()
    assert snap.destination is None
    assert not glob.glob(str(tmp_path / "blob*"))
    monkeypatch.setattr(snapshotter_mod, "_is_writer_process", True)
    snap.run()
    assert snap.flush()
    assert glob.glob(str(tmp_path / "blob*.pickle.gz"))


def test_profiler_attributes_snapshot_stall_slice(tmp_path):
    wf = build(3, tmp_path)
    prof = wf.attach_profiler(fence=False)
    wf.run()
    prof.detach()
    summary = prof.summary()
    assert summary["steps"] > 0
    assert summary.get("snapshot_stall_s", 0) > 0
    assert "snapshot" in summary["phase_pct"]
    assert "run" not in wf.snapshotter.__dict__


class _DeepcopyBomb:
    """Pickles; refuses deepcopy."""

    def __reduce__(self):
        return (_DeepcopyBomb, ())

    def __deepcopy__(self, memo):
        raise RuntimeError("no deepcopy for you")


def test_capture_fallback_on_deepcopy_failure(tmp_path):
    wf = build(2, tmp_path)
    snap = wf.snapshotter
    snap.skip = Bool(False)
    wf.poison = _DeepcopyBomb()
    try:
        snap.run()
        assert os.path.exists(snap.destination)     # written inline
        assert getattr(snap, "_writer_", None) is None
        restore(snap.destination)
    finally:
        del wf.poison


# -- tests/test_snapshot_crash.py ---------------------------------------------

_CHILD = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import numpy
from veles_tpu_torch.config import root
root.common.snapshot.compression_level = 1   # big, fast writes
from veles_tpu_torch.checkpoint import SnapshotterToShards
from veles_tpu_torch.snapshotter import SnapshotterToFile
from veles_tpu_torch.units import TrivialUnit
from veles_tpu_torch.workflow import Workflow

wf = Workflow(None, name="crashwf")
unit = TrivialUnit(wf)
rng = numpy.random.RandomState(0)
if %(shards)r:
    snap = SnapshotterToShards(wf, prefix="crash", directory=%(dir)r,
                               time_interval=0, min_tensor_bytes=1,
                               chunk_bytes=1 << 16)
else:
    snap = SnapshotterToFile(wf, prefix="crash", directory=%(dir)r,
                             time_interval=0, compression="gz",
                             async_write=%(async_write)r)
foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "veles_tpu"))
while True:
    # fresh, incompressible bytes: every write is long (and no chunk
    # dedupes), so the kill lands inside one
    unit.blob = rng.standard_normal((1 << 20,)).astype(numpy.float32)
    snap._counter += 1
    snap.export()
    snap.flush()
    print("WROTE " + json.dumps(foreign), flush=True)
"""


def _crash_drill(snapdir, async_write=False, shards=False):
    os.makedirs(snapdir)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD % {
            "repo": ROOT, "dir": snapdir, "async_write": async_write,
            "shards": shards}],
        stdout=subprocess.PIPE, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        line = proc.stdout.readline()
        assert line.startswith(b"WROTE "), "the child never wrote"
        assert line.split(b" ", 1)[1].strip() == b"[]", line
        time.sleep(0.12)          # land inside a later write
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        proc.stdout.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("async_write", [False, True],
                         ids=["sync-fallback", "async-writer"])
def test_sigkill_mid_write_leaves_only_complete_snapshots(tmp_path,
                                                          async_write):
    snapdir = str(tmp_path / "snaps")
    _crash_drill(snapdir, async_write=async_write)
    finals = glob.glob(os.path.join(snapdir, "crash*.pickle.gz"))
    assert finals, "no complete snapshot survived"
    assert len(glob.glob(os.path.join(snapdir, "*.tmp"))) <= 1
    for path in finals:
        assert SnapshotterToFile.import_file(path).restored_from_snapshot
    current = os.path.join(snapdir, "crash_current")
    if os.path.islink(current):
        assert os.path.exists(os.path.join(snapdir,
                                           os.readlink(current)))
        SnapshotterToFile.import_file(current)


def test_sigkill_mid_shard_checkpoint_leaves_previous_restorable(tmp_path):
    from veles_tpu_torch.checkpoint import (import_dir, list_checkpoints,
                                            quarantine_partials,
                                            resolve_checkpoint)
    snapdir = str(tmp_path / "shards")
    _crash_drill(snapdir, shards=True)
    finals = list_checkpoints(snapdir)
    assert finals, "no complete checkpoint survived"
    for ckpt in finals:
        assert import_dir(ckpt).restored_from_snapshot
    current = os.path.join(snapdir, "crash_current")
    if os.path.islink(current):
        assert resolve_checkpoint(current) in [os.path.realpath(p)
                                               for p in finals]
    partials = [n for n in os.listdir(snapdir)
                if n.endswith(".ckpt.tmp") or n.endswith(".ckpt.parts")]
    assert len(partials) <= 2, partials
    moved = quarantine_partials(snapdir)
    assert len(moved) == len(partials)
    assert all(".quarantine" in os.path.basename(p) for p in moved)
    assert not [n for n in os.listdir(snapdir)
                if n.endswith(".ckpt.tmp") or n.endswith(".ckpt.parts")]


# -- faults C11 and C12 -------------------------------------------------------

@pytest.mark.parametrize("copier", ["pickle", "deepcopy"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
def test_fused_pickle_round_trip_initializes_and_continues(copier, fused):
    """C11: the forwards of a pickled fused workflow hold a device stub;
    the step initializes them again on the device it is given (the
    parent raised ``TypeError`` there).  A live workflow pickled or
    deep-copied after one epoch (the fused step's solver state synced
    into the GD units first, as a snapshot's capture does), marked
    restored as ``restore`` marks it, trains on to the uninterrupted
    run's weights."""
    import copy
    ref = build(3, fused=fused)
    ref.run()
    wf = build(1, fused=fused)
    wf.run()
    if fused:   # the snapshotter's capture does this first
        wf.fused_step.sync_solver_state()
    back = (pickle.loads(pickle.dumps(wf)) if copier == "pickle"
            else copy.deepcopy(wf))
    _assert_bitwise(_params(back), _params(wf))
    back._restored_from_snapshot = True
    back.decision.max_epochs = 3
    back.initialize(device=CPU)
    if fused:
        assert back.fused_step.device is back.forwards[0].device
    assert back.forwards[0].weights.devmem.device == torch.device("cpu")
    back.run()
    assert back.loader.epoch_number == ref.loader.epoch_number
    _assert_bitwise(_params(back), _params(ref))


def test_restored_fused_confusion_matrix_goes_on(tmp_path):
    """C12: the resumed step's confusion matrix is the uninterrupted
    run's (the snapshot's counts plus the resumed epochs')."""
    ref = build(6)
    ref.run()
    build(3, tmp_path).run()
    resumed = _resume(str(tmp_path / "blob_current"), 6)
    want = ref.fused_step.confusion_matrix.map_read()
    assert want.sum() > 0
    assert numpy.array_equal(
        resumed.fused_step.confusion_matrix.map_read(), want)


# -- resume equals the uninterrupted run, bit for bit -------------------------

def _mnist(epochs, fused, snap=None, pkg="veles_tpu_torch"):
    import importlib
    prng = importlib.import_module(pkg + ".prng")
    mnist = importlib.import_module(pkg + ".znicz.samples.mnist")
    backends = importlib.import_module(pkg + ".backends")
    prng.get().seed(42)
    loader = {"minibatch_size": 60, "n_train": 600, "n_valid": 200,
              "normalization_type": "range_linear",
              "prng": prng.RandomGenerator().seed(3)}
    gd = {"learning_rate": 0.03, "weights_decay": 0.0,
          "gradient_moment": 0.9}
    kwargs = {"snapshotter": snap} if snap else {}
    if pkg == "veles_tpu":
        loader["prefetch_depth"] = 0
    else:
        kwargs["fused"] = fused
    wf = mnist.create_workflow(
        loader=loader, decision={"max_epochs": epochs, "silent": True},
        layers=[{"type": "all2all_tanh",
                 "->": {"output_sample_shape": 100}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": gd}], **kwargs)
    wf.initialize(device=backends.Device(backend="cpu"))
    return wf


def _lrn_net(epochs, fused, snap=None):
    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import cifar
    gd = {"learning_rate": 0.02, "gradient_moment": 0.9}
    prng.get().seed(42)
    kwargs = {"snapshotter": snap} if snap else {}
    wf = cifar.create_workflow(
        loader={"minibatch_size": 50, "n_train": 200, "n_valid": 100,
                "normalization_type": "range_linear",
                "prng": RandomGenerator().seed(7)},
        layers=[{"type": "conv_str", "->": {"n_kernels": 8, "kx": 5,
                                            "ky": 5, "padding": 2},
                 "<-": gd},
                {"type": "norm", "->": {"n": 5}},
                {"type": "max_pooling",
                 "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
                {"type": "all2all_str", "->": {"output_sample_shape": 16},
                 "<-": gd},
                {"type": "dropout", "->": {"dropout_ratio": 0.5}},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": gd}],
        decision={"max_epochs": epochs, "silent": True}, fused=fused,
        **kwargs)
    wf.initialize(device=CPU)
    return wf


class NeedleLoader(loader_mod.FullBatchLoader):
    """The attention unit's needle task (tests/test_attention_unit.py)
    at T = 8, D = 8: 32 train and 16 validation sequences."""

    hide_from_registry = True

    def load_data(self):
        rng = numpy.random.RandomState(3)
        x = rng.uniform(-0.2, 0.2, (48, 8, 8)).astype(numpy.float32)
        labels = rng.randint(0, 4, 48)
        pos = rng.randint(0, 8, 48)
        rows = numpy.arange(48)
        x[rows, pos, 0] = 2.0
        x[rows, pos, 1 + labels] = 2.0
        self.original_data.mem = x
        self.original_labels = list(labels.astype(numpy.int32))
        self.class_lengths[loader_mod.TEST] = 0
        self.class_lengths[loader_mod.VALID] = 16
        self.class_lengths[loader_mod.TRAIN] = 32


def _attention(epochs, fused, snap=None):
    from veles_tpu_torch import prng
    gd = {"learning_rate": 0.01, "gradient_moment": 0.9}
    prng.get().seed(42)
    kwargs = {"snapshotter": snap} if snap else {}
    wf = StandardWorkflow(
        None, name="attention", loader_factory=NeedleLoader,
        loader={"minibatch_size": 8, "prng": RandomGenerator().seed(5)},
        layers=[{"type": "multihead_attention", "->": {"heads": 2},
                 "<-": dict(gd)},
                {"type": "softmax", "->": {"output_sample_shape": 4},
                 "<-": dict(gd)}],
        loss_function="softmax",
        decision={"max_epochs": epochs, "silent": True}, fused=fused,
        **kwargs)
    wf.initialize(device=CPU)
    return wf


class RegressionLoader(loader_mod.FullBatchLoaderMSE):
    """tests/test_standard_workflow.py's tanh regression: 6 inputs, 3
    targets, 50 validation and 150 train samples."""

    hide_from_registry = True

    def load_data(self):
        rng = numpy.random.RandomState(11)
        x = rng.uniform(-1, 1, (200, 6)).astype(numpy.float32)
        w = rng.standard_normal((6, 3)).astype(numpy.float32)
        t = numpy.tanh(x @ w) + 0.05 * rng.standard_normal(
            (200, 3)).astype(numpy.float32)
        self.original_data.mem = x
        self.original_targets.mem = t.astype(numpy.float32)
        self.class_lengths[loader_mod.TEST] = 0
        self.class_lengths[loader_mod.VALID] = 50
        self.class_lengths[loader_mod.TRAIN] = 150


def _mse(epochs, fused, snap=None):
    import veles_tpu_torch.prng.random_generator as rg
    rg._generators.clear()
    rg.get(0).seed(77)
    gd = {"learning_rate": 0.1, "gradient_moment": 0.9}
    kwargs = {"snapshotter": snap} if snap else {}
    wf = StandardWorkflow(
        None, name="std_mse", loader_factory=RegressionLoader,
        loader={"minibatch_size": 25, "prng": RandomGenerator().seed(5)},
        layers=[{"type": "all2all_tanh",
                 "->": {"output_sample_shape": 16}, "<-": dict(gd)},
                {"type": "all2all", "->": {"output_sample_shape": 3},
                 "<-": dict(gd)}],
        loss_function="mse",
        decision={"max_epochs": epochs, "silent": True}, fused=fused,
        **kwargs)
    wf.initialize(device=CPU)
    return wf


def _masks(wf):
    """Record the keep mask of every train forward of the dropout units
    (the mask of the key ``apply_train`` is given), in order."""
    from veles_tpu_torch.znicz.dropout import DropoutForward
    seen = []
    for fwd in wf.forwards:
        if isinstance(fwd, DropoutForward):
            def record(params, x, key, fwd=fwd,
                       apply_train=fwd.apply_train):
                seen.append(fwd.mask(key, x.shape, x.device).cpu().numpy())
                return apply_train(params, x, key)
            record.transient_ = True
            fwd.apply_train = record
    return seen


@pytest.fixture(scope="module")
def uninterrupted():
    """``get(net, fused, make, epochs)`` -> (the uninterrupted run of
    ``make(epochs, fused)``, its dropout masks), run once a module: both
    snapshot formats resume against the same reference."""
    runs = {}

    def get(net, fused, make, epochs):
        if (net, fused) not in runs:
            ref = make(epochs, fused)
            masks = _masks(ref)
            ref.run()
            runs[net, fused] = ref, masks
        return runs[net, fused]
    yield get
    runs.clear()


@pytest.mark.parametrize("fmt", ["pickle", "shards"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
@pytest.mark.parametrize("net", ["mnist", "lrn_dropout", "attention",
                                 "mse"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, uninterrupted, net,
                                             fused, fmt):
    make, (first, total) = {"mnist": (_mnist, (3, 6)),
                            "lrn_dropout": (_lrn_net, (2, 4)),
                            "attention": (_attention, (3, 6)),
                            "mse": (_mse, (3, 6))}[net]
    ref, ref_masks = uninterrupted(net, fused, make, total)
    snap = {"prefix": "r", "directory": str(tmp_path), "time_interval": 0,
            "format": fmt}
    make(first, fused, snap).run()
    resumed = restore(str(tmp_path / "r_current"))
    resumed.decision.max_epochs = total
    resumed.initialize(device=CPU)
    masks = _masks(resumed)
    resumed.run()
    assert resumed.loader.epoch_number == ref.loader.epoch_number
    if net == "mse":
        assert resumed.decision.epoch_rmse == ref.decision.epoch_rmse
        assert resumed.decision.best_rmse == ref.decision.best_rmse
    else:
        assert resumed.decision.epoch_n_err == ref.decision.epoch_n_err
        assert resumed.decision.best_n_err == ref.decision.best_n_err
    _assert_bitwise(_params(resumed), _params(ref))
    if net == "lrn_dropout":
        # the resumed epochs' masks are the last ones of the whole run
        assert masks and len(masks) < len(ref_masks)
        for got, want in zip(masks, ref_masks[-len(masks):], strict=True):
            assert numpy.array_equal(got, want)


def test_resume_against_the_jax_package(tmp_path):
    """3 epochs, a snapshot, a restore and 3 more in each package from
    the same seeds: weights within 2e-6, each class's n_err equal."""
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.snapshotter import restore as jax_restore
    got = {}
    for pkg, again, device in (("veles_tpu", jax_restore, JaxDevice),
                               ("veles_tpu_torch", restore, Device)):
        d = tmp_path / pkg
        wf = _mnist(3, True, {"prefix": "m", "directory": str(d),
                              "time_interval": 0}, pkg=pkg)
        wf.run()
        resumed = again(str(d / "m_current"))
        resumed.decision.max_epochs = 6
        resumed.initialize(device=device(backend="cpu"))
        resumed.run()
        got[pkg] = (list(resumed.decision.epoch_n_err),
                    resumed.decision.best_n_err,
                    resumed.loader.epoch_number, _params(resumed))
    jax, port = got["veles_tpu"], got["veles_tpu_torch"]
    assert port[:3] == jax[:3]
    for p, j in zip(port[3], jax[3], strict=True):
        for name in j:
            numpy.testing.assert_allclose(p[name], j[name], rtol=0,
                                          atol=JAX_WEIGHT_ATOL)


# -- restore's routes ---------------------------------------------------------

def test_restore_routes_sqlite_dir_manifest_and_http(tmp_path):
    from veles_tpu_torch.checkpoint import resolve_checkpoint
    wf = build(2, tmp_path / "db", snap_kwargs={
        "format": "db", "database": str(tmp_path / "db" / "s.sqlite3")})
    wf.run()
    snap = wf.snapshotter
    snap.skip = Bool(False)
    snap.run()                  # a shot of the final weights
    assert snap.flush()
    assert snap.destination.startswith("sqlite://")
    back = restore(snap.destination)
    _assert_bitwise(_params(back), _params(wf))
    wf = build(2, tmp_path / "shards", snap_kwargs={"format": "shards"})
    wf.run()
    ckpt = resolve_checkpoint(str(tmp_path / "shards"))
    for spec in (str(tmp_path / "shards"), ckpt,
                 os.path.join(ckpt, "manifest.json")):
        assert restore(spec).restored_from_snapshot
    wf = build(2, tmp_path / "http")
    wf.run()
    name = os.path.basename(os.path.realpath(
        str(tmp_path / "http" / "blob_current")))

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    handler = lambda *a, **k: Quiet(*a, directory=str(tmp_path / "http"),
                                    **k)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        back = restore("http://127.0.0.1:%d/%s" % (server.server_port,
                                                   name))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert back.restored_from_snapshot
    _assert_bitwise(_params(back), _params(restore(
        str(tmp_path / "http" / "blob_current"))))


# -- the normalizers' snapshot state ------------------------------------------

@pytest.mark.parametrize("kind", ["none", "range_linear", "internal_mean",
                                  "mean_disp"])
def test_normalizer_state_equals_the_jax_one(kind):
    from veles_tpu import normalization as jax_norm
    from veles_tpu_torch import normalization
    data = numpy.random.RandomState(2).uniform(
        -3, 5, (40, 6)).astype(numpy.float64)
    port, jax = normalization.factory(kind), jax_norm.factory(kind)
    if kind != "none":
        with pytest.raises(normalization.UninitializedStateError):
            port.state
    for n in (port, jax):
        n.analyze(data[:25])
        n.analyze(data[25:])
    state, want = port.state, jax.state
    assert sorted(state) == sorted(want)
    for key, value in want.items():
        assert numpy.array_equal(numpy.asarray(state[key]),
                                 numpy.asarray(value)), key
    back = pickle.loads(pickle.dumps(port))
    fresh = normalization.factory(kind)
    fresh.state = state
    out = [n.normalize(data.astype(numpy.float32).copy())
           for n in (port, back, fresh)]
    assert numpy.array_equal(out[0], out[1])
    assert numpy.array_equal(out[0], out[2])
