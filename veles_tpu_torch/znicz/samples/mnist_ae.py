"""MnistAE: the fully connected MNIST autoencoder.

The port's counterpart of ``veles_tpu/znicz/samples/mnist_ae.py`` (the
Znicz MnistAE sample; its published baseline is 0.5478 validation RMSE,
the reference's manualrst_veles_algorithms.rst:55-69): 784 → tanh 100 →
linear 784, trained under MSE against the input image itself (targets =
data), minibatch 100, momentum 0.9, learning rate 0.01.  The loader
reads the digits the MNIST sample reads (real IDX files when present,
else the committed fixture) and serves each image as its own target;
with ``precise_gemm`` every matmul of the fused step runs through the
compensated GEMM (K4 on the card).

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import mnist_ae
    prng.get().seed(42)
    wf = mnist_ae.create_workflow(decision={"max_epochs": 8})
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
    wf.gather_results()["best_validation_rmse"]
"""

import numpy

from ...config import root
from ...datasets import load_digits_idx
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoaderMSE

__all__ = ["MnistAELoader", "create_workflow", "run"]

root.mnist_ae.update({
    "loader": {"minibatch_size": 100,
               "normalization_type": "range_linear",
               "target_normalization_type": "range_linear"},
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100,
                                        "weights_stddev": 0.05},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.0,
                "gradient_moment": 0.9}},
        {"type": "all2all", "->": {"output_sample_shape": 784,
                                   "weights_stddev": 0.05},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.0,
                "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 20, "fail_iterations": 20},
})


class MnistAELoader(FullBatchLoaderMSE):
    """MNIST-format digits with the images doubling as regression
    targets (``provenance``: "real" or "fixture")."""

    MAPPING = "mnist_ae_loader"

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
        data = data.reshape(len(data), -1)
        self.original_data.mem = data
        self.original_targets.mem = data.copy()
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = len(vi)
        self.class_lengths[TRAIN] = len(ti)


def create_workflow(fused=True, **overrides):
    """The MnistAE StandardWorkflow (MSE loss); ``loader`` / ``decision``
    dicts override the sample's config key by key, ``layers`` replaces.
    ``fused=False`` builds graph mode."""
    from . import build_standard
    return build_standard(root.mnist_ae, "MnistAE", MnistAELoader, "mse",
                          fused=fused, **overrides)


def run(load, main):
    load(create_workflow)
    main()
