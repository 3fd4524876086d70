"""VideoAE: convolutional autoencoder over video frames.

The port's counterpart of ``veles_tpu/znicz/samples/video_ae.py`` (the
Znicz VideoAE sample): conv 5x5 tanh → max pooling 2x2 encode,
depooling 2x2 → deconv 5x5 decode, MSE against the input frame,
minibatch 50.  It is the sample that drives the deconv / depooling pair
(:mod:`..misc_units`) end to end.

The loader serves the JAX package's deterministic synthetic "video"
(frames of a square sprite orbiting a 32x32 field, gaussian noise;
numpy seed 31; 480 train + 120 valid frames by default), the same bytes
for the same arguments, or the frames given as ``frames=`` (a fifth of
them, at most ``n_valid``, for validation).

    from veles_tpu_torch import prng
    from veles_tpu_torch.znicz.samples import video_ae
    prng.get().seed(42)
    wf = video_ae.create_workflow()
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
"""

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoaderMSE

__all__ = ["VideoFramesLoader", "synthetic_video", "create_workflow"]

_LR = {"learning_rate": 3e-5, "gradient_moment": 0.9}

root.video_ae.update({
    "loader": {"minibatch_size": 50,
               "normalization_type": "range_linear",
               "target_normalization_type": "range_linear"},
    "layers": [
        {"type": "conv_tanh", "->": {"n_kernels": 8, "kx": 5, "ky": 5,
                                     "padding": 2,
                                     "weights_stddev": 0.05}, "<-": _LR},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2,
                                       "sliding": (2, 2)}},
        {"type": "depooling", "->": {"kx": 2, "ky": 2}},
        {"type": "deconv", "->": {"n_kernels": 1, "kx": 5, "ky": 5,
                                  "padding": 2, "weights_stddev": 0.05},
         "<-": _LR},
    ],
    "decision": {"max_epochs": 15, "fail_iterations": 20},
})


def synthetic_video(n_frames, side=32, seed=31):
    """A sprite orbiting the frame + noise; (n, side, side, 1) float32."""
    rng = numpy.random.RandomState(seed)
    frames = numpy.zeros((n_frames, side, side, 1), numpy.float32)
    for t in range(n_frames):
        angle = 2 * numpy.pi * t / 24.0
        cy = int(side / 2 + (side / 3) * numpy.sin(angle))
        cx = int(side / 2 + (side / 3) * numpy.cos(angle))
        y0, x0 = max(cy - 3, 0), max(cx - 3, 0)
        frames[t, y0:cy + 3, x0:cx + 3, 0] = 1.0
        frames[t, :, :, 0] += rng.normal(0, 0.05, (side, side))
    return numpy.clip(frames, 0.0, 1.0)


class VideoFramesLoader(FullBatchLoaderMSE):
    """Frames double as their own MSE targets (autoencoder)."""

    MAPPING = "video_ae_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", 480)
        self.n_valid = kwargs.pop("n_valid", 120)
        self.frames = kwargs.pop("frames", None)
        super().__init__(workflow, **kwargs)

    def load_data(self):
        if self.frames is not None:
            frames = numpy.asarray(self.frames, numpy.float32)
            n_valid = min(self.n_valid, len(frames) // 5)
        else:
            frames = synthetic_video(self.n_train + self.n_valid)
            n_valid = self.n_valid
        data = frames.astype(numpy.float32)
        self.original_data.mem = data
        self.original_targets.mem = data.copy()
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = n_valid
        self.class_lengths[TRAIN] = len(data) - n_valid


def create_workflow(fused=True, **overrides):
    """The VideoAE StandardWorkflow (MSE loss); ``loader`` / ``decision``
    dicts override the sample's config key by key, ``layers`` replaces.
    ``fused=False`` builds graph mode."""
    from . import build_standard
    return build_standard(root.video_ae, "VideoAE", VideoFramesLoader,
                          "mse", fused=fused, **overrides)
