"""Kanji: glyph denoising under MSE (the target is the clean glyph).

The port's counterpart of ``veles_tpu/znicz/samples/kanji.py`` (the
Znicz Kanji sample): an MLP maps distorted renderings of characters
onto their clean glyphs, many noisy instances to one target.  As in the
JAX sample, the glyphs are deterministic stroke patterns
(:func:`make_glyphs`, numpy seed 53) and the instances jittered, noisy
copies (seed 54), the same bytes for the same arguments; 576 → tanh 120
→ 576, minibatch 50, momentum 0.9, learning rate 3e-3.

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import kanji
    prng.get().seed(42)
    wf = kanji.create_workflow()
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
"""

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoaderMSE

__all__ = ["KanjiLoader", "make_glyphs", "create_workflow", "run"]

_LR = {"learning_rate": 3e-3, "gradient_moment": 0.9}
SIDE = 24

root.kanji.update({
    "loader": {"minibatch_size": 50,
               "normalization_type": "range_linear",
               "target_normalization_type": "range_linear"},
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 120,
                                        "weights_stddev": 0.05},
         "<-": _LR},
        {"type": "all2all", "->": {"output_sample_shape": SIDE * SIDE,
                                   "weights_stddev": 0.05}, "<-": _LR},
    ],
    "decision": {"max_epochs": 40, "fail_iterations": 20},
})


def make_glyphs(n_classes, side=SIDE, seed=53):
    """Deterministic stroke-pattern glyphs, one per class."""
    rng = numpy.random.RandomState(seed)
    glyphs = numpy.zeros((n_classes, side, side), numpy.float32)
    for c in range(n_classes):
        for _ in range(rng.randint(3, 7)):  # a few strokes each
            if rng.randint(2):
                r = rng.randint(2, side - 2)
                a, b = sorted(rng.randint(0, side, 2))
                glyphs[c, r, a:b + 1] = 1.0
            else:
                col = rng.randint(2, side - 2)
                a, b = sorted(rng.randint(0, side, 2))
                glyphs[c, a:b + 1, col] = 1.0
    return glyphs


class KanjiLoader(FullBatchLoaderMSE):
    """Noisy jittered glyph instances → clean glyph targets."""

    MAPPING = "kanji_loader"

    def __init__(self, workflow, **kwargs):
        self.n_classes = kwargs.pop("n_classes", 16)
        self.n_train = kwargs.pop("n_train", 800)
        self.n_valid = kwargs.pop("n_valid", 200)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        glyphs = make_glyphs(self.n_classes)
        rng = numpy.random.RandomState(54)

        def make(n):
            labels = rng.randint(0, self.n_classes, n)
            data = glyphs[labels].copy()
            for i in range(n):
                data[i] = numpy.roll(
                    numpy.roll(data[i], rng.randint(-2, 3), 0),
                    rng.randint(-2, 3), 1)
            data += rng.normal(0, 0.25, data.shape)
            return (numpy.clip(data, 0, 1.5).reshape(n, -1),
                    glyphs[labels].reshape(n, -1), labels)

        vd, vt, vl = make(self.n_valid)
        td, tt, tl = make(self.n_train)
        self.original_data.mem = numpy.concatenate([vd, td])
        self.original_targets.mem = numpy.concatenate([vt, tt])
        self.original_labels = list(numpy.concatenate([vl, tl]))
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = self.n_valid
        self.class_lengths[TRAIN] = self.n_train


def create_workflow(fused=True, **overrides):
    """The Kanji StandardWorkflow (MSE loss); ``loader`` / ``decision``
    dicts override the sample's config key by key, ``layers`` replaces.
    ``fused=False`` builds graph mode."""
    from . import build_standard
    return build_standard(root.kanji, "Kanji", KanjiLoader, "mse",
                          fused=fused, **overrides)


def run(load, main):
    load(create_workflow)
    main()
