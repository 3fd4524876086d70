"""The port's loader against the JAX package's, on the CPU.

A small full-batch dataset (test / validation / train of 3 / 7 / 23
rows, minibatch 5) is served by both packages' FullBatchLoader from the
same seed, the JAX one in its ``defer_device_gather`` mode (indices
only, the consumer gathers), which is the only mode the port has.  Over
three epochs the minibatch classes, sizes, padded indices and the
``last_minibatch`` / ``epoch_ended`` / ``train_ended`` / ``valid_ended``
gates must be equal, and so must the dense labels the step gathers.
A loader that leaves its contract half done is refused at initialize.
"""

import importlib

import numpy
import pytest

SIZES = (3, 7, 23)          # test, validation, train
MINIBATCH = 5
EPOCHS = 3


def _mod(pkg, name):
    return importlib.import_module("%s.%s" % (pkg, name))


def _loader(pkg, sizes=SIZES, train_ratio=1.0):
    fullbatch = _mod(pkg, "loader.fullbatch")
    base = _mod(pkg, "loader.base")

    class Tiny(fullbatch.FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            n = sum(sizes)
            self.original_data.mem = numpy.arange(
                n * 3, dtype=numpy.float32).reshape(n, 3)
            self.original_labels = ["c%d" % (i % 4) for i in range(n)]
            for cls, size in zip((base.TEST, base.VALID, base.TRAIN), sizes):
                self.class_lengths[cls] = size

    ld = Tiny(_mod(pkg, "workflow").Workflow(name="w"),
              minibatch_size=MINIBATCH, train_ratio=train_ratio,
              prng=_mod(pkg, "prng").RandomGenerator().seed(5))
    if pkg == "veles_tpu":
        ld.defer_device_gather = True
    ld.initialize(device=_mod(pkg, "backends").Device(backend="cpu"))
    return ld


def _walk(ld):
    steps = []
    while ld.epoch_number < EPOCHS:
        ld.run()
        steps.append((int(ld.minibatch_class), int(ld.minibatch_size),
                      ld._padded_indices_.tolist(),
                      bool(ld.last_minibatch), bool(ld.epoch_ended),
                      bool(ld.train_ended), bool(ld.valid_ended)))
        if bool(ld.epoch_ended) and ld.epoch_number == EPOCHS - 1:
            break
    return steps


@pytest.mark.parametrize("train_ratio", [1.0, 0.5])
def test_minibatch_walk_matches_jax(train_ratio):
    jax_ld = _loader("veles_tpu", train_ratio=train_ratio)
    port_ld = _loader("veles_tpu_torch", train_ratio=train_ratio)
    want, got = _walk(jax_ld), _walk(port_ld)
    assert got == want
    train = int(SIZES[2] * train_ratio)
    per_epoch = sum(-(-n // MINIBATCH) for n in SIZES[:2] + (train,))
    assert len(got) == EPOCHS * per_epoch
    # the short last minibatch of a class pads with its first index
    short = [s for s in got if s[1] < MINIBATCH]
    assert short and all(s[2][s[1]:] == [s[2][0]] * (MINIBATCH - s[1])
                         for s in short)
    # the train segment is reshuffled every epoch, the others are not
    train_epochs = [[i for s in got[e * per_epoch:(e + 1) * per_epoch]
                     if s[0] == 2 for i in s[2][:s[1]]]
                    for e in range(EPOCHS)]
    assert train_epochs[0] != train_epochs[1]
    assert numpy.array_equal(port_ld._dense_labels, jax_ld._dense_labels)
    assert port_ld.minibatch_data.shape == (MINIBATCH, 3)


def test_loader_without_its_contract_is_refused():
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader import Loader
    from veles_tpu_torch.workflow import Workflow

    class Half(Loader):
        hide_from_registry = True

        def load_data(self):
            self.class_lengths[2] = 4

        def create_minibatch_data(self):
            pass

    with pytest.raises(TypeError, match="analyze_dataset, fill_indices"):
        Half(Workflow(name="w")).initialize(device=Device(backend="cpu"))
