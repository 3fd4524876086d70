"""STL-10 convnet sample.

The port's counterpart of ``veles_tpu/znicz/samples/stl10.py`` (the
Znicz STL-10 sample; its published baseline is 35.10 % validation
error, the reference's manualrst_veles_algorithms.rst:51): 96x96x3
images, 10 classes, 5000 train images; the caffe-quick-style conv stack
of the CIFAR sample with a third pooling stage, 3 x (conv 5x5 strict
RELU → pooling 3x3/2) → fc 128 → softmax 10, minibatch 50.

Real STL-10 binary files are loaded when present under
``root.common.dirs.datasets/stl10_binary`` (``train_X.bin``,
``train_y.bin``, ``test_X.bin``, ``test_y.bin``); otherwise the JAX
package's deterministic synthetic twin with the same shapes (10 class
prototypes of 12x12x3 upscaled to 96x96, gaussian noise; numpy seed
1453; 5000 train + 800 valid images by default), the same bytes for the
same arguments.

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import stl10
    prng.get().seed(42)
    wf = stl10.create_workflow(decision={"max_epochs": 10})
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()

``root.common.engine.precise_gemm = N`` before ``create_workflow`` runs
the fully connected and softmax matmuls through the compensated GEMM
(kernel K4 on the card).
"""

import os

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoader

__all__ = ["Stl10Loader", "create_workflow"]

_LR = {"learning_rate": 0.01, "gradient_moment": 0.9,
       "weights_decay": 0.004}

root.stl10.update({
    "loader": {"minibatch_size": 50,
               "normalization_type": "range_linear"},
    "layers": [
        {"type": "conv_str", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                    "padding": 2,
                                    "weights_stddev": 0.05}, "<-": _LR},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str", "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                                    "padding": 2,
                                    "weights_stddev": 0.05}, "<-": _LR},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "conv_str", "->": {"n_kernels": 64, "kx": 5, "ky": 5,
                                    "padding": 2,
                                    "weights_stddev": 0.05}, "<-": _LR},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "all2all", "->": {"output_sample_shape": 128,
                                   "weights_stddev": 0.05}, "<-": _LR},
        {"type": "softmax", "->": {"output_sample_shape": 10,
                                   "weights_stddev": 0.05}, "<-": _LR},
    ],
    "decision": {"max_epochs": 100, "fail_iterations": 20},
})


def _synthetic_stl10(n_train, n_valid, seed=1453):
    """Deterministic class-structured synthetic twin (96x96x3)."""
    rng = numpy.random.RandomState(seed)
    protos = rng.uniform(-0.6, 0.6, (10, 12, 12, 3)).astype(numpy.float32)

    def make(n):
        labels = rng.randint(0, 10, n).astype(numpy.int32)
        base = protos[labels]
        up = numpy.repeat(numpy.repeat(base, 8, axis=1), 8, axis=2)
        data = up + rng.normal(0, 0.25, up.shape).astype(numpy.float32)
        return (data * 128 + 128).clip(0, 255).astype(numpy.float32), \
            labels
    return make(n_train), make(n_valid)


class Stl10Loader(FullBatchLoader):
    """STL-10 binary files when present, the synthetic twin otherwise."""

    MAPPING = "stl10_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", None)
        self.n_valid = kwargs.pop("n_valid", None)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        d = os.path.join(root.common.dirs.get("datasets", "."),
                         "stl10_binary")

        def read_split(xname, yname):
            with open(os.path.join(d, xname), "rb") as f:
                x = numpy.frombuffer(f.read(), numpy.uint8)
            # column-major 96x96 per channel (STL-10 binary layout)
            x = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
            with open(os.path.join(d, yname), "rb") as f:
                y = numpy.frombuffer(f.read(), numpy.uint8).astype(
                    numpy.int32) - 1
            return x.astype(numpy.float32), y

        if os.path.exists(os.path.join(d, "train_X.bin")):
            ti, tl = read_split("train_X.bin", "train_y.bin")
            vi, vl = read_split("test_X.bin", "test_y.bin")
            if self.n_train:
                ti, tl = ti[:self.n_train], tl[:self.n_train]
            if self.n_valid:
                vi, vl = vi[:self.n_valid], vl[:self.n_valid]
        else:
            (ti, tl), (vi, vl) = _synthetic_stl10(
                self.n_train or 5000, self.n_valid or 800)
        self.original_data.mem = numpy.concatenate([vi, ti])
        self.original_labels = list(numpy.concatenate([vl, tl]))
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = len(vi)
        self.class_lengths[TRAIN] = len(ti)


def create_workflow(fused=True, **overrides):
    """The STL-10 StandardWorkflow; ``loader`` / ``decision`` dicts
    override the sample's config key by key, ``layers`` replaces.
    ``fused=False`` builds graph mode."""
    from . import build_standard
    return build_standard(root.stl10, "Stl10Convnet", Stl10Loader,
                          "softmax", fused=fused, **overrides)
