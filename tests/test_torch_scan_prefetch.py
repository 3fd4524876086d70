"""The epoch scan and the minibatch prefetcher, held against the JAX
package and against the port's own per-step path.

The epoch scan (``StandardWorkflow(epoch_scan=True)``, a
``ScanEpochStep``): on the CPU each class runs eagerly row by row
through the buffers and the position counter the card's CUDA graphs
replay.

- mirrors tests/test_standard_workflow.py::test_epoch_scan_equals_per_step
  [25, 40] (the gaussian blobs, a partial tail batch at 40): the port's
  scan against the JAX scan, weights within the MNIST tests' 2e-6 and
  the same ``best_n_err_pt``, ``best_epoch`` and ``epoch_number``; the
  port's scan against its per-step path bit for bit (``torch.equal``);
- ``train_epochs(2)`` bit for bit two scanned epochs; the MSE loss
  scanned bit for bit per-step;
- a chain with dropout scanned against the JAX scan: every keep mask the
  port draws from its tensor keys equals ``jax.random.bernoulli``'s for
  the JAX scan's seeds, and the weights agree within 2e-6;
- tensor keys give the integer keys' bits (dropout masks, categorical
  draws), which are ``jax.random``'s;
- a scanned workflow snapshotted and restored goes on bit for bit (the
  loader blocked again), and any loader but a FullBatchLoader is refused.

The prefetcher mirrors ten of the eleven tests of tests/test_prefetch.py
(``test_master_slave_serving_detaches_prefetcher`` waits for the
master/slave loaders, ROADMAP queue A item 11), on the MNIST sample at
300 + 100 digits: the recorded sequence (offset, size, class, flags,
epoch, samples served, indices) and the results of depth 2 (5 at the
class and epoch boundaries, 3 with a requeued minibatch) equal depth
0's, and depth 2's sequence equals the JAX prefetcher's.  Beyond the
mirrors: the staged path (indices, size and seed as tensors) bit for bit
depth 0; a ``force_numpy`` FullBatchLoader and a ``ShardedBatchLoader``
served through the twin bit for bit; and the non-mesh half of
tests/test_snapshot_async.py::test_roundtrip_with_prefetcher_and_
distributed_step: a snapshot taken mid-run (and one at the run's end,
after the worker could have opened the next epoch) resumed bit for bit
the uninterrupted run.  No prefetch thread outlives a test (the
``_prefetch_threads()`` snapshot idiom of the JAX tests).
"""

import gc
import pickle
import threading
import time

import numpy
import pytest
import torch

from veles_tpu_torch import loader as loader_mod
from veles_tpu_torch import prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.loader import (FullBatchLoader, MinibatchPrefetcher,
                                    PrefetchError, TRAIN, VALID)
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.snapshotter import restore
from veles_tpu_torch.workflow import Workflow
from veles_tpu_torch.znicz.samples import mnist
from veles_tpu_torch.znicz.scan_step import ScanEpochStep
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

import _torch_workers  # noqa: F401  (pins torch's threads under xdist)

CPU = Device(backend="cpu")
#: the MNIST tests' cross-package tolerance (tests/test_torch_mnist.py)
JAX_WEIGHT_ATOL = 2e-6

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 20},
     "<-": {"learning_rate": 0.2, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.2, "gradient_moment": 0.9}},
]
DROPOUT_LAYERS = [LAYERS[0], {"type": "dropout", "dropout_ratio": 0.3},
                  LAYERS[1]]
MSE_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "all2all", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
]


def _prefetch_threads():
    """Live prefetch workers (compared against a snapshot taken at a
    test's start: abandoned workflows of other tests may not be reaped
    yet)."""
    return {t for t in threading.enumerate()
            if t.name.startswith("veles-prefetch")}


@pytest.fixture(autouse=True)
def no_leaked_prefetch_threads():
    before = _prefetch_threads()
    yield
    gc.collect()
    deadline = time.monotonic() + 3.0
    while _prefetch_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
        gc.collect()
    assert not _prefetch_threads() - before


def _blobs():
    """tests/test_standard_workflow.py's gaussian blobs: 4 classes in 8
    dimensions, 50 validation and 150 train samples."""
    rng = numpy.random.RandomState(4)
    centers = rng.uniform(-2, 2, (4, 8))
    data, labels = [], []
    for c in range(4):
        data.append(centers[c] + 0.35 * rng.standard_normal((50, 8)))
        labels += [c] * 50
    data = numpy.concatenate(data).astype(numpy.float32)
    order = rng.permutation(len(data))
    return data[order], list(numpy.array(labels)[order])


def _regression():
    """tests/test_standard_workflow.py's RegressionLoader data."""
    rng = numpy.random.RandomState(11)
    x = rng.uniform(-1, 1, (200, 6)).astype(numpy.float32)
    w = rng.standard_normal((6, 3)).astype(numpy.float32)
    t = numpy.tanh(x @ w) + 0.05 * rng.standard_normal(
        (200, 3)).astype(numpy.float32)
    return x, t.astype(numpy.float32)


def _blob_loader(base_cls, mse):
    """A loader class over ``base_cls`` serving the blobs (or, ``mse``,
    the regression targets): 50 validation and 150 train samples."""
    class _Blobs(base_cls):
        hide_from_registry = True

        def load_data(self):
            if mse:
                self.original_data.mem, self.original_targets.mem = \
                    _regression()
            else:
                self.original_data.mem, self.original_labels = _blobs()
            self.class_lengths[:] = [0, 50, 150]
    return _Blobs


#: the port's loaders, at module level so a snapshot pickles them
BlobLoader = _blob_loader(loader_mod.FullBatchLoader, False)
BlobLoader.__qualname__ = BlobLoader.__name__ = "BlobLoader"
RegressionLoader = _blob_loader(loader_mod.FullBatchLoaderMSE, True)
RegressionLoader.__qualname__ = RegressionLoader.__name__ = \
    "RegressionLoader"


def _loader_class(pkg, mse=False):
    """The blob (or regression) FullBatchLoader of package ``pkg``."""
    if pkg == "veles_tpu_torch":
        return RegressionLoader if mse else BlobLoader
    import importlib
    fb = importlib.import_module(pkg + ".loader.fullbatch")
    return _blob_loader(fb.FullBatchLoaderMSE if mse else
                        fb.FullBatchLoader, mse)


def build(pkg="veles_tpu_torch", max_epochs=3, minibatch=25, seed=77,
          layers=LAYERS, mse=False, **extra):
    """test_standard_workflow.py's ``build`` in package ``pkg``, fused,
    on the CPU."""
    import importlib
    rg = importlib.import_module(pkg + ".prng.random_generator")
    sw = importlib.import_module(pkg + ".znicz.standard_workflow")
    backends = importlib.import_module(pkg + ".backends")
    rg._generators.clear()  # deterministic weight init across builds
    rg.get(0).seed(seed)
    loader = {"minibatch_size": minibatch,
              "prng": rg.RandomGenerator().seed(5)}
    loader.update(extra.pop("loader", {}))
    wf = sw.StandardWorkflow(
        None, name="std", loader_factory=extra.pop(
            "loader_factory", _loader_class(pkg, mse)),
        loader=loader, layers=layers,
        loss_function="mse" if mse else "softmax",
        decision={"max_epochs": max_epochs, "silent": True},
        fused=True, **extra)
    wf.initialize(device=backends.Device(backend="cpu"))
    return wf


def _params(wf):
    """Each forward's parameters as host arrays."""
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def _step_tensors(wf):
    """The step's own parameter tensors (after the run's sync)."""
    return [{k: v.detach() for k, v in layer.items()}
            for layer in wf.fused_step._params_]


def _assert_bitwise(a, b):
    for x, y in zip(a, b, strict=True):
        assert sorted(x) == sorted(y)
        for name in x:
            assert torch.equal(torch.as_tensor(x[name]),
                               torch.as_tensor(y[name])), name


# -- the epoch scan -----------------------------------------------------------

@pytest.mark.parametrize("minibatch", [25, 40])
def test_epoch_scan_equals_per_step(minibatch):
    """The scan against the JAX scan (2e-6, the same decisions) and
    against the port's per-step path (bit for bit), a partial tail batch
    at 40."""
    wf_s = build(minibatch=minibatch, epoch_scan=True)
    wf_p = build(minibatch=minibatch)
    wf_j = build("veles_tpu", minibatch=minibatch, epoch_scan=True)
    assert isinstance(wf_s.fused_step, ScanEpochStep)
    assert wf_s.loader.prefetcher_ is None
    for wf in (wf_s, wf_p, wf_j):
        wf.run()
    _assert_bitwise(_step_tensors(wf_s), _step_tensors(wf_p))
    _assert_bitwise(_params(wf_s), _params(wf_p))
    for fs, fj in zip(_params(wf_s), _params(wf_j), strict=True):
        for name in fj:
            numpy.testing.assert_allclose(fs[name], fj[name], rtol=0,
                                          atol=JAX_WEIGHT_ATOL)
    for other in (wf_p, wf_j):
        assert wf_s.decision.best_n_err_pt == other.decision.best_n_err_pt
        assert wf_s.decision.best_epoch == other.decision.best_epoch
        assert wf_s.loader.epoch_number == other.loader.epoch_number
    assert list(wf_s.decision.epoch_n_err) == \
        list(wf_p.decision.epoch_n_err)
    step = wf_s.fused_step
    # 3 epochs of (2 or 4) validation and (4 or 6) train minibatches,
    # every row eager on the CPU, none captured
    assert step.eager_rows == step.train_steps + step.eval_steps
    assert step.train_steps == 3 * -(-150 // minibatch)
    assert step.captures == step.replays == 0


def test_train_epochs_equals_scanned_epochs():
    """``train_epochs(2)``: one upload of two epochs' index matrices,
    bit for bit two scanned epochs' weights."""
    wf_s = build(max_epochs=2, minibatch=40, epoch_scan=True)
    wf_s.run()
    wf_b = build(max_epochs=2, minibatch=40, epoch_scan=True)
    wf_b.fused_step.train_epochs(2)
    _assert_bitwise(_params(wf_b), _params(wf_s))
    assert wf_b.loader.epoch_number == wf_s.loader.epoch_number == 1
    assert wf_b.fused_step._seed_counter == wf_s.fused_step._seed_counter
    assert wf_b.fused_step.train_steps == wf_s.fused_step.train_steps == 8


def test_mse_epoch_scan_equals_per_step():
    """The MSE loss scanned: weights bit for bit per-step, the metric
    accumulator (zeroed in place at each flush) read the same."""
    wf_s = build(minibatch=40, mse=True, layers=MSE_LAYERS, seed=13,
                 epoch_scan=True)
    wf_p = build(minibatch=40, mse=True, layers=MSE_LAYERS, seed=13)
    wf_s.run()
    wf_p.run()
    _assert_bitwise(_params(wf_s), _params(wf_p))
    assert wf_s.decision.best_rmse == wf_p.decision.best_rmse
    assert list(wf_s.decision.epoch_rmse) == list(wf_p.decision.epoch_rmse)


def _record_masks(wf):
    """Wrap the dropout forwards: every keep mask drawn, as numpy."""
    from veles_tpu_torch.znicz.dropout import DropoutForward
    masks = []
    for fwd in wf.forwards:
        if isinstance(fwd, DropoutForward):
            def apply_train(params, x, key, fwd=fwd, orig=fwd.apply_train):
                masks.append(fwd.mask(key, x.shape, x.device).numpy())
                return orig(params, x, key)
            apply_train.transient_ = True
            fwd.apply_train = apply_train
    return masks


def test_scanned_dropout_chain_equals_the_jax_scan():
    """Dropout inside the scan draws from tensor keys: every mask equals
    ``jax.random.bernoulli`` at the JAX scan's per-minibatch seeds, the
    weights equal the JAX scan's within 2e-6 and the port's per-step
    path's bit for bit."""
    import jax
    wf_s = build(max_epochs=2, minibatch=40, layers=DROPOUT_LAYERS,
                 epoch_scan=True)
    wf_p = build(max_epochs=2, minibatch=40, layers=DROPOUT_LAYERS)
    wf_j = build("veles_tpu", max_epochs=2, minibatch=40,
                 layers=DROPOUT_LAYERS, epoch_scan=True)
    first_seed = wf_j.fused_step._seed_counter + 1
    masks, masks_p = _record_masks(wf_s), _record_masks(wf_p)
    for wf in (wf_s, wf_p, wf_j):
        wf.run()
    assert len(masks) == 8 and len(masks_p) == 8
    for i, (got, per_step) in enumerate(zip(masks, masks_p)):
        key = jax.random.fold_in(jax.random.key(first_seed + i), 1)
        want = numpy.asarray(jax.random.bernoulli(key, 0.7, got.shape))
        assert numpy.array_equal(got, want), i
        assert numpy.array_equal(got, per_step), i
    _assert_bitwise(_params(wf_s), _params(wf_p))
    for fs, fj in zip(_params(wf_s), _params(wf_j), strict=True):
        for name in fj:
            numpy.testing.assert_allclose(fs[name], fj[name], rtol=0,
                                          atol=JAX_WEIGHT_ATOL)


@pytest.mark.parametrize("seed", [1, 0x7FFEFFFF, 123456789])
def test_tensor_keys_give_the_integer_keys_bits(seed):
    """``key`` / ``fold_in`` over a 0-d int64 seed tensor: the dropout
    mask's and a categorical draw's bits equal the integer path's and
    ``jax.random``'s."""
    import jax
    k_int = prng.fold_in(prng.key(seed), 2)
    k_t = prng.fold_in(prng.key(torch.tensor(seed, dtype=torch.int64)), 2)
    assert all(isinstance(w, torch.Tensor) and w.dim() == 0 for w in k_t)
    assert (int(k_t[0]), int(k_t[1])) == k_int
    jkey = jax.random.fold_in(jax.random.key(seed), 2)
    mask = prng.bernoulli(k_t, 0.7, (5, 33), "cpu")
    assert torch.equal(mask, prng.bernoulli(k_int, 0.7, (5, 33), "cpu"))
    assert numpy.array_equal(mask.numpy(), numpy.asarray(
        jax.random.bernoulli(jkey, 0.7, (5, 33))))
    logits = torch.tensor(numpy.random.RandomState(seed % 1000).uniform(
        -2, 2, (4, 6, 9)), dtype=torch.float32)
    draw = prng.categorical(k_t, logits)
    assert torch.equal(draw, prng.categorical(k_int, logits))
    assert numpy.array_equal(draw.numpy(), numpy.asarray(
        jax.random.categorical(jkey, logits.numpy())))


def test_scanned_workflow_resumes_bit_for_bit(tmp_path):
    """A scanned workflow with a snapshotter: restored after 3 epochs
    (the loader blocked again, the graphs' buffers rebuilt) and run to
    5, bit for bit 5 uninterrupted scanned epochs."""
    ref = build(max_epochs=5, minibatch=40, epoch_scan=True)
    ref.run()
    part = build(max_epochs=3, minibatch=40, epoch_scan=True,
                 snapshotter={"prefix": "scan", "directory": str(tmp_path),
                              "time_interval": 0})
    part.run()
    back = restore(str(tmp_path / "scan_current"))
    assert isinstance(back.fused_step, ScanEpochStep)
    assert back.fused_step._buf_ is None
    back.decision.max_epochs = 5
    back.initialize(device=CPU)
    assert bool(back.loader.gate_block)
    back.run()
    _assert_bitwise(_params(back), _params(ref))
    assert back.loader.epoch_number == ref.loader.epoch_number
    assert list(back.decision.epoch_n_err) == \
        list(ref.decision.epoch_n_err)


def test_epoch_scan_needs_a_full_batch_loader(tmp_path):
    from veles_tpu_torch.loader import ShardedBatchLoader, write_shards
    data, labels = _blobs()
    write_shards(str(tmp_path), data, labels=labels,
                 class_lengths=[0, 50, 150], rows_per_shard=64)
    with pytest.raises(TypeError, match="FullBatchLoader"):
        StandardWorkflow(None, loader_factory=ShardedBatchLoader,
                         loader={"path": str(tmp_path)}, layers=LAYERS,
                         epoch_scan=True)


# -- the prefetcher (tests/test_prefetch.py) ----------------------------------

def _build(depth, max_epochs=2, **loader_overrides):
    prng.get().seed(4321)   # reproducible weight init across builds
    loader = {"minibatch_size": 50, "n_train": 300, "n_valid": 100,
              "prng": RandomGenerator().seed(3), "prefetch_depth": depth}
    loader.update(loader_overrides)
    wf = mnist.create_workflow(
        loader=loader, decision={"max_epochs": max_epochs, "silent": True})
    wf.initialize(device=CPU)
    return wf


def _run_recorded(wf):
    """Run the workflow, recording the loader state every fused step."""
    seq = []
    orig = wf.fused_step.run

    def recorder():
        ld = wf.loader
        seq.append((ld.minibatch_offset, ld.minibatch_size,
                    ld.minibatch_class, bool(ld.last_minibatch),
                    bool(ld.epoch_ended), bool(ld.train_ended),
                    ld.epoch_number, ld.samples_served,
                    tuple(int(i) for i in
                          ld.minibatch_indices.mem[:ld.minibatch_size])))
        return orig()

    recorder.transient_ = True
    wf.fused_step.run = recorder
    wf.run()
    return seq, wf.gather_results()


def test_prefetch_matches_synchronous_path():
    """The same minibatch sequence (offsets, sizes, classes, shuffled
    indices, flag edges) and epoch metrics at depth 0 and 2, and the
    JAX prefetcher's sequence."""
    from veles_tpu import prng as jprng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.prng import RandomGenerator as JaxRandom
    from veles_tpu.znicz.samples import mnist as jmnist
    wf0 = _build(0)
    assert wf0.loader.prefetcher_ is None
    assert "run" not in wf0.loader.__dict__     # a true bypass
    seq0, res0 = _run_recorded(wf0)

    wf2 = _build(2)
    pf = wf2.loader.prefetcher_
    assert pf is not None and pf.depth == 2
    assert pf.device == torch.device("cpu") and not pf.stats()["staging"]
    seq2, res2 = _run_recorded(wf2)

    assert seq2 == seq0
    assert res2 == res0
    _assert_bitwise(_params(wf2), _params(wf0))
    assert pf.consumed == len(seq2)
    assert pf.produced >= pf.consumed

    jprng.get().seed(4321)
    wfj = jmnist.create_workflow(
        loader={"minibatch_size": 50, "n_train": 300, "n_valid": 100,
                "prng": JaxRandom().seed(3), "prefetch_depth": 2},
        decision={"max_epochs": 2, "silent": True})
    wfj.initialize(device=JaxDevice(backend="cpu"))
    assert wfj.loader.prefetcher_ is not None
    seqj, resj = _run_recorded(wfj)
    assert seqj == seq2
    assert resj["best_validation_error_pt"] == res2["best_validation_error_pt"]


def test_prefetch_matches_synchronous_with_requeue():
    """A failed minibatch requeued before the run is served again at
    the same position on both paths."""
    sequences = []
    for depth in (0, 3):
        wf = _build(depth)
        wf.loader.failed_minibatches.append((200, 50))
        seq, _ = _run_recorded(wf)
        sequences.append(seq)
    assert sequences[0] == sequences[1]
    # the requeued (offset=200, size=50) definition came first
    assert sequences[0][0][:2] == (200, 50)


def test_clean_shutdown_no_leaked_threads():
    """The workflow's end stops the worker; detach restores run()."""
    before = _prefetch_threads()
    wf = _build(2)
    _run_recorded(wf)
    assert _prefetch_threads() <= before        # stop() joined it
    pf = wf.loader.prefetcher_
    assert pf is not None                       # still attached, idle
    assert pf._thread is None
    pf.detach()
    assert wf.loader.prefetcher_ is None
    assert "run" not in wf.loader.__dict__
    assert "stop" not in wf.loader.__dict__


def test_resume_after_workflow_finish_keeps_sequence():
    """stop() loses no queued item: a second run() goes on with the
    epoch walk where the synchronous path would."""
    wf0, wf2 = _build(0, max_epochs=4), _build(2, max_epochs=4)
    for wf in (wf0, wf2):
        wf.decision.max_epochs = 2
        wf.run()
        wf.decision.max_epochs = 4
        wf.decision.complete <<= False
    seq0, res0 = _run_recorded(wf0)
    seq2, res2 = _run_recorded(wf2)
    assert seq2 == seq0
    assert res2 == res0


class _BoomLoader(FullBatchLoader):
    MAPPING = "prefetch_boom_loader"
    BOOM_AFTER = 3

    def load_data(self):
        self._fills = 0
        self.original_data.mem = numpy.random.RandomState(0).rand(
            40, 4).astype(numpy.float32)
        self.original_labels = [i % 4 for i in range(40)]
        self.class_lengths[TRAIN] = 40

    def fill_minibatch(self):
        self._fills += 1
        if self._fills > self.BOOM_AFTER:
            raise RuntimeError("boom in fill_minibatch")
        super().fill_minibatch()


def test_worker_exception_reraises_on_consumer():
    wf = Workflow(None)
    ld = _BoomLoader(wf, minibatch_size=10, force_numpy=True)
    ld.initialize()
    pf = MinibatchPrefetcher.attach(ld, depth=2, stage_to_device=False,
                                    device="cpu")
    assert pf is not None
    before = _prefetch_threads()
    with pytest.raises(RuntimeError, match="boom in fill_minibatch"):
        for _ in range(20):
            ld.run()
    # the queue gave the items made before the failure first
    assert pf.consumed == _BoomLoader.BOOM_AFTER
    with pytest.raises(PrefetchError):
        ld.run()
    pf.detach()
    assert _prefetch_threads() <= before


def test_depth_zero_and_optout_bypass():
    wf = Workflow(None)
    ld = _BoomLoader(wf, minibatch_size=10, force_numpy=True)
    ld.initialize()
    assert MinibatchPrefetcher.attach(ld, depth=0, device="cpu") is None
    ld.supports_prefetch = False
    assert MinibatchPrefetcher.attach(ld, depth=2, device="cpu") is None
    assert "run" not in ld.__dict__ and ld.prefetcher_ is None


def test_gather_path_stages_indices_on_device():
    """The fused gather-in-step path: the prefetcher stages the padded
    index vector and the size as tensors ahead of the step, which takes
    them (and a staged seed) as they are."""
    wf = _build(0)
    pf = wf.attach_prefetcher(depth=2, stage_to_device=True)
    assert pf.device == torch.device("cpu") and pf.stats()["staging"]
    assert wf.loader.defer_device_gather     # the gather rides in the step
    wf.loader.run()     # consume one item
    staged = wf.loader.prefetch_staged_
    assert staged is not None
    idx_dev, size_dev = staged
    assert isinstance(idx_dev, torch.Tensor)
    assert idx_dev.shape == (wf.loader.max_minibatch_size,)
    assert int(size_dev) == wf.loader.minibatch_size
    numpy.testing.assert_array_equal(idx_dev.numpy(),
                                     wf.loader._padded_indices_)
    wf.fused_step.run()     # the staged variant executes
    assert wf.loader.prefetcher_ is not None
    wf.loader.prefetcher_.detach()
    assert wf.loader.prefetch_staged_ is None


def test_staged_path_equals_the_synchronous_path():
    """A whole run of a chain with dropout on the staged path (tensor
    indices, size and seed, the next seed made from this one) bit for
    bit depth 0's."""
    wf0 = build(max_epochs=2, minibatch=40, layers=DROPOUT_LAYERS,
                loader={"prefetch_depth": 0})
    seq0, res0 = _run_recorded(wf0)
    wf2 = build(max_epochs=2, minibatch=40, layers=DROPOUT_LAYERS,
                loader={"prefetch_depth": 0})
    wf2.attach_prefetcher(depth=2, stage_to_device=True)
    staged = []
    orig = wf2.fused_step._staged_seed_arg

    def seed_arg():
        staged.append(orig())
        return staged[-1]
    seed_arg.transient_ = True
    wf2.fused_step._staged_seed_arg = seed_arg
    seq2, res2 = _run_recorded(wf2)
    assert seq2 == seq0 and res2 == res0
    _assert_bitwise(_params(wf2), _params(wf0))
    counter = wf0.fused_step._seed_counter
    assert [int(s) for s in staged] == list(range(counter - 7, counter + 1))


@pytest.mark.parametrize("kind", ["force_numpy", "sharded"])
def test_host_served_loaders_through_the_twin(tmp_path, kind):
    """Loaders that serve minibatches on the host (a ``force_numpy``
    FullBatchLoader; a ``ShardedBatchLoader`` whose window the twin
    shares): depth 2 bit for bit depth 0, the same sequence."""
    from veles_tpu_torch.loader import ShardedBatchLoader, write_shards
    runs = []
    for depth in (0, 2):
        prng.get().seed(4321)
        if kind == "sharded":
            probe = mnist.MnistLoader(Workflow(name="probe"), n_train=300,
                                      n_valid=100)
            probe.load_data()
            path = str(tmp_path / "digits")
            if depth == 0:
                write_shards(path, numpy.asarray(probe.original_data.mem),
                             labels=probe.original_labels,
                             class_lengths=list(probe.class_lengths),
                             rows_per_shard=64)
            extra = {"loader_factory": ShardedBatchLoader,
                     "loader": {"path": path, "window_bytes": 200000,
                                "minibatch_size": 50, "prefetch_depth":
                                depth, "prng": RandomGenerator().seed(3)}}
        else:
            extra = {"loader": {"minibatch_size": 50, "n_train": 300,
                                "n_valid": 100, "force_numpy": True,
                                "prefetch_depth": depth,
                                "prng": RandomGenerator().seed(3)}}
        wf = mnist.create_workflow(
            decision={"max_epochs": 2, "silent": True}, **extra)
        wf.initialize(device=CPU)
        assert not wf.fused_step._use_gather_
        assert (wf.loader.prefetcher_ is not None) == bool(depth)
        runs.append(_run_recorded(wf) + (_params(wf),))
    assert runs[1][:2] == runs[0][:2]
    _assert_bitwise(runs[1][2], runs[0][2])


def test_sharded_window_stays_in_budget_while_a_load_lands(tmp_path):
    """The twin loads shards while the training thread may read the
    window's fill: a shard is admitted only once the window has room for
    it, so no reader sees more than the budget, and the stream is the
    synchronous one's."""
    from veles_tpu_torch.loader import ShardedBatchLoader, write_shards
    data, labels = _blobs()
    path = str(tmp_path / "blobs")
    write_shards(path, data, labels=labels, class_lengths=[0, 50, 150],
                 rows_per_shard=16)
    budget = 3 * 16 * 8 * 4
    fills = []

    class Window(dict):
        def __setitem__(self, key, block):
            fills.append(wf.loader._window_["bytes"] + block.nbytes)
            super().__setitem__(key, block)

    runs = []
    for depth in (0, 2):
        wf = build(max_epochs=2, minibatch=25, loader_factory=
                   ShardedBatchLoader, loader={
                       "path": path, "window_bytes": budget,
                       "prefetch_depth": depth})
        wf.loader._window_["cache"] = Window()
        runs.append(_run_recorded(wf)[0])
        assert wf.loader.shard_loads > 13
    assert runs[0] == runs[1]
    assert fills and max(fills) <= budget


def test_loader_pickles_with_prefetcher_attached():
    """A snapshot taken mid-run pickles no worker: the wrappers are
    transient."""
    wf = _build(2)
    wf.loader.run()     # worker alive, wrappers installed
    blob = pickle.dumps(wf.loader)
    restored = pickle.loads(blob)
    assert restored.prefetcher_ is None
    assert "run" not in restored.__dict__
    # the consumed position survived
    assert restored.minibatch_size == wf.loader.minibatch_size
    assert restored._global_offset == wf.loader._global_offset
    wf.loader.prefetcher_.detach()


def test_prefetch_metrics_and_profiler_integration():
    """A StepProfiler over a prefetched loader: data_wait is the time
    blocked on the queue, and the summary carries the prefetcher's
    stats."""
    wf = _build(2)
    prof = wf.attach_profiler(fence=False)
    wf.run()
    prof.detach()
    summary = prof.summary()
    assert summary["steps"] > 0
    assert "prefetch" in summary
    assert summary["prefetch"]["consumed"] == summary["steps"]
    assert summary["prefetch"]["depth"] == 2
    from veles_tpu_torch.observability.registry import REGISTRY
    text = REGISTRY.render_prometheus()
    for name in ("veles_loader_prefetch_queue",
                 "veles_loader_prefetch_items_total",
                 "veles_loader_prefetch_wait_seconds_total"):
        assert name in text


def test_valid_class_boundaries_and_epoch_flags():
    """Flag edges fire at the same steps as the synchronous path even
    when the lookahead crosses class and epoch boundaries."""
    wf0 = _build(0, max_epochs=3, minibatch_size=30)
    seq0, _ = _run_recorded(wf0)
    wf5 = _build(5, max_epochs=3, minibatch_size=30)
    seq5, _ = _run_recorded(wf5)
    assert seq0 == seq5
    # the walk really crossed VALID -> TRAIN boundaries and epoch ends
    assert any(s[2] == VALID and s[3] for s in seq0)
    assert any(s[2] == TRAIN and s[4] for s in seq0)


def test_prefetch_under_a_short_switch_interval():
    """The worker and the training thread interleaved every microsecond
    (``sys.setswitchinterval``) over 3 epochs of minibatches of 30 at
    depth 3: the sequence, flags and weights are still depth 0's."""
    import sys
    wf0 = _build(0, max_epochs=3, minibatch_size=30)
    seq0, res0 = _run_recorded(wf0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        wf3 = _build(3, max_epochs=3, minibatch_size=30)
        seq3, res3 = _run_recorded(wf3)
    finally:
        sys.setswitchinterval(interval)
    assert seq3 == seq0 and res3 == res0
    _assert_bitwise(_params(wf3), _params(wf0))
    assert wf3.loader.prefetcher_.consumed == len(seq0)


@pytest.mark.parametrize("at", ["mid_run", "run_end"])
def test_roundtrip_with_prefetcher(tmp_path, at):
    """A snapshot with the prefetcher attached (taken when validation
    improves mid-run, or at the run's end when the worker has served
    ahead), restored and run on: bit for bit the uninterrupted run.
    The pickle carries no wrapper and no worker; the restored workflow
    attaches a new prefetcher."""
    from veles_tpu_torch.mutable import Bool
    ref = build(max_epochs=6, minibatch=40, loader={"prefetch_depth": 2})
    assert ref.loader.prefetcher_ is not None
    ref.run()
    part = build(max_epochs=3, minibatch=40, loader={"prefetch_depth": 2},
                 snapshotter={"prefix": "blob", "directory": str(tmp_path),
                              "time_interval": 0})
    assert part.loader.prefetcher_ is not None
    part.run()
    if at == "run_end":
        time.sleep(0.2)     # a worker free to serve ahead would have
        snap = part.snapshotter
        snap.skip = Bool(False)
        snap.run()
        assert snap.flush()
    resumed = restore(str(tmp_path / "blob_current"))
    assert "run" not in resumed.loader.__dict__
    assert getattr(resumed.loader, "prefetcher_", None) is None
    resumed.decision.max_epochs = 6
    resumed.initialize(device=CPU)
    assert resumed.loader.prefetcher_ is not None   # attached again
    resumed.run()
    assert resumed.loader.epoch_number == ref.loader.epoch_number
    _assert_bitwise(_params(resumed), _params(ref))
    assert list(resumed.decision.epoch_n_err) == \
        list(ref.decision.epoch_n_err)
