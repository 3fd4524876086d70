"""Lines: line orientation classification, its topology an MCDNN string.

The port's counterpart of ``veles_tpu/znicz/samples/lines.py`` (the
Znicz Lines sample, the reference's documented user of
``mcdnnic_topology``, manualrst_veles_workflow_creation.rst:41-47): a
small convnet classifies 32x32 images of straight lines by orientation
(horizontal, vertical, the two diagonals), its whole topology the
string ``1x32x32-8C5-MP2-16C5-MP2-64N-4N`` with per-layer defaults in
``mcdnnic_parameters``
(:func:`~veles_tpu_torch.znicz.standard_workflow.parse_mcdnnic_topology`:
two strict-ReLU convolutions with max pooling, then all2all_tanh 64
and softmax 4).  The lines are drawn by :func:`draw_line` with jitter
and noise from numpy seed 17, the JAX sample's bytes.

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import lines
    prng.get().seed(42)
    wf = lines.create_workflow()
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
"""

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoader

__all__ = ["LinesLoader", "draw_line", "create_workflow", "run"]

root.lines.update({
    "loader": {"minibatch_size": 40, "normalization_type": "mean_disp"},
    "mcdnnic_topology": "1x32x32-8C5-MP2-16C5-MP2-64N-4N",
    "mcdnnic_parameters": {
        "->": {"weights_stddev": 0.1},
        "<-": {"learning_rate": 0.05, "gradient_moment": 0.9},
    },
    "decision": {"max_epochs": 10, "fail_iterations": 20},
})


def draw_line(orientation, side=32, rng=None):
    """A ``(side, side, 1)`` image of one line: 0 horizontal, 1
    vertical, 2 the main diagonal, 3 the anti-diagonal; ``rng`` shifts
    it and adds noise."""
    img = numpy.zeros((side, side, 1), numpy.float32)
    off = rng.randint(-side // 4, side // 4 + 1) if rng is not None else 0
    idx = numpy.arange(side)
    if orientation == 0:
        img[numpy.clip(side // 2 + off, 0, side - 1), :, 0] = 1.0
    elif orientation == 1:
        img[:, numpy.clip(side // 2 + off, 0, side - 1), 0] = 1.0
    elif orientation == 2:
        img[idx, numpy.clip(idx + off, 0, side - 1), 0] = 1.0
    else:
        img[idx, numpy.clip(side - 1 - idx + off, 0, side - 1), 0] = 1.0
    if rng is not None:
        img[:, :, 0] += rng.normal(0, 0.1, (side, side))
    return img


class LinesLoader(FullBatchLoader):
    """Lines in 4 orientations, in turn, 400 train + 100 valid."""

    MAPPING = "lines_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", 400)
        self.n_valid = kwargs.pop("n_valid", 100)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        rng = numpy.random.RandomState(17)
        data, labels = [], []
        for i in range(self.n_valid + self.n_train):
            orientation = i % 4
            data.append(draw_line(orientation, rng=rng))
            labels.append(orientation)
        self.original_data.mem = numpy.stack(data)
        self.original_labels = labels
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = self.n_valid
        self.class_lengths[TRAIN] = self.n_train


def create_workflow(fused=True, **overrides):
    """The Lines StandardWorkflow from the config's ``mcdnnic_topology``;
    ``loader`` / ``decision`` dicts override the sample's config key by
    key, ``layers`` or ``mcdnnic_topology`` replace the topology.
    ``fused=False`` builds graph mode."""
    from . import build_standard
    return build_standard(root.lines, "Lines", LinesLoader, "softmax",
                          fused=fused, **overrides)


def run(load, main):
    load(create_workflow)
    main()
