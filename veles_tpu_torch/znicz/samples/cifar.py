"""CIFAR-10 convnet sample.

The port's counterpart of ``veles_tpu/znicz/samples/cifar.py`` (the Znicz
CIFAR10 caffe-config sample; its published baseline is 17.21 %
validation error, the reference's manualrst_veles_algorithms.rst:50):
the caffe CIFAR quick net, 3 x (conv → pool) → fc → softmax, on
``internal_mean`` normalization.

Real CIFAR-10 python batches are loaded when present under
``root.common.dirs.datasets/cifar-10-batches-py``; otherwise the JAX
package's deterministic synthetic twin with the same shapes (10 classes
of 8x8 templates upscaled to 32x32x3, noise and random rolls; numpy
seeds 977-979) is used, the same bytes for the same arguments.
"""

import os
import pickle

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoader

__all__ = ["CifarLoader", "create_workflow"]

_GD = {"learning_rate": 0.001, "gradient_moment": 0.9,
       "weights_decay": 0.004}

root.cifar.update({
    "loader": {"minibatch_size": 100,
               "normalization_type": "internal_mean",
               "normalization_parameters": {"scale": 1.0 / 128}},
    "layers": [
        {"type": "conv", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                "padding": 2, "weights_stddev": 0.0001},
         "<-": dict(_GD)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "activation_str"},
        {"type": "conv_str", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                    "padding": 2, "weights_stddev": 0.01},
         "<-": dict(_GD)},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str", "->": {"n_kernels": 64, "kx": 5, "ky": 5,
                                    "padding": 2, "weights_stddev": 0.01},
         "<-": dict(_GD)},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "all2all", "->": {"output_sample_shape": 64,
                                   "weights_stddev": 0.1},
         "<-": dict(_GD)},
        {"type": "softmax", "->": {"output_sample_shape": 10,
                                   "weights_stddev": 0.1},
         "<-": dict(_GD, weights_decay=1.0)},
    ],
    "decision": {"max_epochs": 60, "fail_iterations": 100},
})


def _synthetic_cifar(n_train, n_valid, seed=977):
    """Deterministic CIFAR-shaped 10-class problem (32x32x3 uint8)."""
    rng = numpy.random.RandomState(seed)
    templates = rng.uniform(0, 1, (10, 8, 8, 3))
    temps = numpy.kron(templates, numpy.ones((1, 4, 4, 1)))

    def make(n, rs):
        labels = rs.randint(0, 10, n)
        imgs = temps[labels]
        imgs = imgs + rs.normal(0, 0.25, imgs.shape)
        rolls = rs.randint(-3, 4, (n, 2))
        for i in range(n):
            imgs[i] = numpy.roll(imgs[i], tuple(rolls[i]), (0, 1))
        return (numpy.clip(imgs, 0, 1.3) / 1.3 * 255).astype(numpy.uint8), \
            labels.astype(numpy.int32)

    return (make(n_train, numpy.random.RandomState(seed + 1)),
            make(n_valid, numpy.random.RandomState(seed + 2)))


class CifarLoader(FullBatchLoader):
    MAPPING = "cifar_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", None)
        self.n_valid = kwargs.pop("n_valid", None)
        #: "real" when the on-disk CIFAR-10 batches were used,
        #: "synthetic" for the twin
        self.provenance = None
        super().__init__(workflow, **kwargs)

    def load_data(self):
        d = os.path.join(os.path.expanduser(
            root.common.dirs.get("datasets", "")), "cifar-10-batches-py")
        if os.path.isdir(d):
            self.provenance = "real"
            imgs, labels = [], []
            for name in ["data_batch_%d" % i for i in range(1, 6)]:
                with open(os.path.join(d, name), "rb") as f:
                    batch = pickle.load(f, encoding="bytes")
                imgs.append(batch[b"data"])
                labels += list(batch[b"labels"])
            ti = numpy.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1)
            tl = numpy.array(labels, numpy.int32)
            with open(os.path.join(d, "test_batch"), "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            vi = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            vl = numpy.array(batch[b"labels"], numpy.int32)
            ti, tl = ti[:self.n_train], tl[:self.n_train]
            vi, vl = vi[:self.n_valid], vl[:self.n_valid]
        else:
            self.provenance = "synthetic"
            (ti, tl), (vi, vl) = _synthetic_cifar(
                self.n_train or 5000, self.n_valid or 1000)
        data = numpy.concatenate([vi, ti]).astype(numpy.float32)
        self.original_data.mem = data
        self.original_labels = list(numpy.concatenate([vl, tl]))
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = len(vi)
        self.class_lengths[TRAIN] = len(ti)


def create_workflow(**overrides):
    """The CIFAR StandardWorkflow; ``loader`` / ``decision`` dicts
    override the sample's config key by key, ``layers`` replaces."""
    from . import build_standard
    return build_standard(root.cifar, "CifarConvnet", CifarLoader,
                          "softmax", **overrides)
