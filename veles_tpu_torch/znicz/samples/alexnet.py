"""ImageNet AlexNet sample, the JAX package's headline workload.

The port's counterpart of ``veles_tpu/znicz/samples/alexnet.py`` (the
Znicz AlexNet, single tower):

conv11x11/4x96 → LRN → max3x3/2 → conv5x5x256 → LRN → max3x3/2 →
conv3x3x384 → conv3x3x384 → conv3x3x256 → max3x3/2 → fc4096 → dropout →
fc4096 → dropout → softmax1000

Input 227x227x3, minibatch 128, momentum 0.9, lr 0.01, weight decay
5e-4.  Real ImageNet is not in the repository: the loader serves the
JAX package's deterministic synthetic ImageNet-shaped data (numpy seed
11; 2048 train + 256 validation images by default, 1.42 GB resident on
the device), the same bytes for the same arguments.  On the card the LRN
layers run the kernels K5 (forward) and K6 (backward) unless
``use_pallas`` is False (the band form; :mod:`..lrn`).

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import alexnet
    prng.get().seed(42)
    wf = alexnet.create_workflow(decision={"max_epochs": 3})
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
"""

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoader

__all__ = ["SyntheticImagenetLoader", "create_workflow"]

_LR = {"learning_rate": 0.01, "gradient_moment": 0.9,
       "weights_decay": 0.0005}
_LRN = {"alpha": 1e-4, "beta": 0.75, "n": 5, "k": 2.0}
_POOL = {"kx": 3, "ky": 3, "sliding": (2, 2)}

root.alexnet.update({
    "loader": {"minibatch_size": 128, "normalization_type": "none"},
    "layers": [
        {"type": "conv_str", "->": {"n_kernels": 96, "kx": 11, "ky": 11,
                                    "sliding": (4, 4),
                                    "weights_stddev": 0.01}, "<-": _LR},
        {"type": "norm", "->": dict(_LRN)},
        {"type": "max_pooling", "->": dict(_POOL)},
        {"type": "conv_str", "->": {"n_kernels": 256, "kx": 5, "ky": 5,
                                    "padding": 2,
                                    "weights_stddev": 0.01}, "<-": _LR},
        {"type": "norm", "->": dict(_LRN)},
        {"type": "max_pooling", "->": dict(_POOL)},
        {"type": "conv_str", "->": {"n_kernels": 384, "kx": 3, "ky": 3,
                                    "padding": 1,
                                    "weights_stddev": 0.01}, "<-": _LR},
        {"type": "conv_str", "->": {"n_kernels": 384, "kx": 3, "ky": 3,
                                    "padding": 1,
                                    "weights_stddev": 0.01}, "<-": _LR},
        {"type": "conv_str", "->": {"n_kernels": 256, "kx": 3, "ky": 3,
                                    "padding": 1,
                                    "weights_stddev": 0.01}, "<-": _LR},
        {"type": "max_pooling", "->": dict(_POOL)},
        {"type": "all2all_str", "->": {"output_sample_shape": 4096,
                                       "weights_stddev": 0.005},
         "<-": _LR},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_str", "->": {"output_sample_shape": 4096,
                                       "weights_stddev": 0.005},
         "<-": _LR},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "softmax", "->": {"output_sample_shape": 1000,
                                   "weights_stddev": 0.01}, "<-": _LR},
    ],
    "decision": {"max_epochs": 90, "fail_iterations": 1000},
})


class SyntheticImagenetLoader(FullBatchLoader):
    """Deterministic ImageNet-shaped data resident on the device: uniform
    pixels in [-0.5, 0.5) and uniform labels, numpy seed 11."""

    MAPPING = "synthetic_imagenet_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", 2048)
        self.n_valid = kwargs.pop("n_valid", 256)
        self.n_classes = kwargs.pop("n_classes", 1000)
        self.side = kwargs.pop("side", 227)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        rng = numpy.random.RandomState(11)
        n = self.n_train + self.n_valid
        self.original_data.mem = rng.uniform(
            -0.5, 0.5, (n, self.side, self.side, 3)).astype(numpy.float32)
        self.original_labels = list(
            rng.randint(0, self.n_classes, n).astype(numpy.int32))
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = self.n_valid
        self.class_lengths[TRAIN] = self.n_train


def create_workflow(**overrides):
    """The AlexNet StandardWorkflow; ``loader`` / ``decision`` dicts
    override the sample's config key by key, ``layers`` replaces."""
    from . import build_standard
    return build_standard(root.alexnet, "AlexNet", SyntheticImagenetLoader,
                          "softmax", **overrides)
