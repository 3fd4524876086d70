"""MnistSimple: fully-connected MNIST classifier.

The port's counterpart of ``veles_tpu/znicz/samples/mnist.py`` (the
Znicz MnistSimple sample: 784 → 100 scaled-tanh → 10 softmax, minibatch
60, momentum 0.9, learning rate 0.03; its published baseline is 1.48 %
validation error, the reference's manualrst_veles_algorithms.rst:25-31).

Programmatic use, as the JAX package's sample and gate test do::

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import mnist
    prng.get().seed(42)
    wf = mnist.create_workflow(decision={"max_epochs": 25})
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
    wf.gather_results()["best_validation_error_pt"]

``root.common.engine.precise_gemm = N`` before ``create_workflow`` (or
``precise_gemm`` in a layer's ``"->"`` config) runs every fully
connected matmul, forward and backward, through the compensated GEMM
(kernel K4 on the card).
"""

import numpy

from ...config import root
from ...datasets import load_digits_idx
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoader

__all__ = ["MnistLoader", "create_workflow"]

root.mnist.update({
    "loader": {"minibatch_size": 60, "normalization_type": "range_linear"},
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.03, "weights_decay": 0.0,
                "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.03, "weights_decay": 0.0,
                "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 25, "fail_iterations": 50},
})


class MnistLoader(FullBatchLoader):
    """MNIST-format digits: real IDX files when present, else the
    committed fixture archives (``provenance`` records which;
    ``is_real`` means true MNIST)."""

    MAPPING = "mnist_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", None)
        self.n_valid = kwargs.pop("n_valid", None)
        self.use_fixture = kwargs.pop("use_fixture", True)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        (ti, tl), (vi, vl), self.provenance = load_digits_idx(
            self.n_train, self.n_valid, fixture=self.use_fixture)
        self.is_real = self.provenance == "real"
        data = numpy.concatenate([vi, ti]).astype(numpy.float32)
        self.original_data.mem = data.reshape(len(data), -1)
        self.original_labels = list(numpy.concatenate([vl, tl]))
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = len(vi)
        self.class_lengths[TRAIN] = len(ti)


def create_workflow(**overrides):
    """The MnistSimple StandardWorkflow; ``loader`` / ``decision`` dicts
    override the sample's config key by key, ``layers`` replaces."""
    from . import build_standard
    return build_standard(root.mnist, "MnistSimple", MnistLoader, "softmax",
                          **overrides)
