"""Kohonen self-organizing map units (a training path without gradients).

The port's counterpart of ``veles_tpu/znicz/kohonen.py`` (the Znicz
Kohonen family):

- winner search: ``argmin ||x - w||²`` computed as ``||w||² - 2·x@wᵀ``
  (``||x||²`` is constant in the argmin and added back for the true
  squared distance); of equal scores the first neuron wins, as in
  ``jnp.argmin``;
- neighbourhood update: a Gaussian over the 2-D grid coordinates,
  ``w += lr · exp(-d²/2σ²) · (x - w)``: the classic *online* SOM, sample
  by sample within a minibatch, deterministic given the loader's
  shuffle order.

The JAX trainer scans the minibatch in one jitted ``lax.scan``; here the
per-sample loop runs eagerly on the unit's device, some twenty small
kernels a sample, and reads nothing back to the host inside a
minibatch (the winner stays a device scalar).  The learning rate and
radius decay per epoch, ``v = v0 · (vf/v0)^(t/T)``, computed on the host
in f64 and rounded to f32 where the JAX jit rounds them.
"""

import numpy
import torch

from .. import loader as loader_mod
from ..accelerated_units import AcceleratedUnit
from ..memory import Array
from ..mutable import Bool
from ..prng import RandomGenerator
from ..result_provider import IResultProvider
from ..units import Unit

__all__ = ["KohonenBase", "KohonenForward", "KohonenTrainer",
           "KohonenDecision", "winners", "train_batch"]


def winners(w, x):
    """Each row's winner (int32) and true squared distance, for the
    codebook ``w [n, F]`` and the samples ``x [B, F]``."""
    scores = (w * w).sum(dim=1)[None, :] - 2.0 * (x @ w.T)
    win = torch.argmin(scores, dim=1)
    d = torch.gather(scores, 1, win[:, None])[:, 0]
    d = d + (x * x).sum(dim=1)
    return win.to(torch.int32), d


def train_batch(w, qacc, xb, size, grid, lr, denom):
    """The online update of the codebook ``w`` by the first ``size``
    rows of ``xb`` in order (the padded rows past them change nothing),
    and ``qacc`` plus each sample's ``sqrt(max(qe, 0))``; -> (w, qacc).

    ``grid`` is the neurons' ``[n, 2]`` coordinates; ``lr`` and
    ``denom`` (``2σ²``) are f32 values as Python floats."""
    for i in range(int(size)):
        x = xb[i]
        scores = (w * w).sum(dim=1) - 2.0 * (w @ x)
        win = torch.argmin(scores).reshape(1)
        qe = scores.index_select(0, win)[0] + (x * x).sum()
        dg = ((grid - grid.index_select(0, win)) ** 2).sum(dim=1)
        neigh = torch.exp(-dg / denom)
        w = w + lr * neigh[:, None] * (x[None, :] - w)
        qacc = qacc + torch.sqrt(torch.clamp_min(qe, 0.0))
    return w, qacc


class KohonenBase(AcceleratedUnit):
    """Shared codebook holder: weights ``[rows*cols, n_input]`` on the
    unit's device (the card unless ``Device(backend="cpu")``)."""

    hide_from_registry = True
    #: the arrays ``convert.trainer_params_from_jax`` carries
    PARAMS = ("weights",)

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.shape = tuple(kwargs.get("shape", (8, 8)))
        self.weights = Array()
        self.minibatch_data = None       # linked from the loader
        self.minibatch_size = None

    @property
    def neurons_number(self):
        return int(numpy.prod(self.shape))

    def link_loader(self, loader):
        self.link_attrs(loader, "minibatch_data", "minibatch_size")
        return self

    def _samples(self):
        x = self.minibatch_data.devmem
        return x.reshape(x.shape[0], -1)

    def load_state(self):
        """Reload the live state from ``weights`` (the forward keeps
        none: it reads them every run)."""


class KohonenForward(KohonenBase):
    """Winner lookup: maps each sample to its best-matching neuron.

    ``output`` holds the winners' flat grid indices for the last served
    minibatch, ``distances`` their squared distances (the quantization
    error of each sample)."""

    MAPPING = "kohonen_forward"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = Array()
        self.distances = Array()

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        for arr in (self.weights, self.output, self.distances):
            arr.initialize(self.device)

    def run(self):
        win, d = winners(self.weights.devmem, self._samples())
        self.output.devmem = win
        self.distances.devmem = d


class KohonenTrainer(KohonenBase, IResultProvider):
    """Online SOM trainer: one pass over the minibatch per run.

    kwargs: ``shape`` (grid rows, cols), ``sigma`` / ``sigma_final``
    (the neighbourhood radius schedule, defaults max(shape)/2 → 0.5),
    ``learning_rate`` / ``learning_rate_final`` (0.5 → 0.01), ``epochs``
    (the schedule's horizon, 50), ``weights_stddev`` (0.05), ``prng``
    (the initial codebook's generator; default ``RandomGenerator``
    seeded 1, the JAX package's bytes).

    On the last minibatch of a class it writes ``qerror`` (the epoch's
    mean quantization error), zeroes its accumulator and publishes a
    copy of the codebook into ``weights``, which mid-epoch holds the
    last epoch's codebook, as in the JAX unit."""

    MAPPING = "kohonen_trainer"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.sigma = float(kwargs.get("sigma", max(self.shape) / 2.0))
        self.sigma_final = float(kwargs.get("sigma_final", 0.5))
        self.learning_rate = float(kwargs.get("learning_rate", 0.5))
        self.learning_rate_final = float(
            kwargs.get("learning_rate_final", 0.01))
        self.epochs = int(kwargs.get("epochs", 50))
        self.weights_stddev = float(kwargs.get("weights_stddev", 0.05))
        self.prng = kwargs.get("prng")
        self.epoch_number = None         # linked from the loader
        self.last_minibatch = None
        self.minibatch_class = None
        # the quantization error of the last epoch (host; written once
        # an epoch)
        self.qerror = Array(numpy.zeros(1, numpy.float64))
        self._epoch_samples = 0

    def link_loader(self, loader):
        super().link_loader(loader)
        self.link_attrs(loader, "epoch_number", "last_minibatch",
                        "minibatch_class")
        return self

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        n_input = int(numpy.prod(self.minibatch_data.shape[1:]))
        if not self.weights:
            prng = self.prng or RandomGenerator().seed(1)
            self.weights.mem = prng.normal(
                0.0, self.weights_stddev,
                (self.neurons_number, n_input)).astype(numpy.float32)
        self.weights.initialize(self.device)
        rows, cols = self.shape
        gy, gx = numpy.mgrid[0:rows, 0:cols]
        grid = numpy.stack([gy.ravel(), gx.ravel()], 1).astype(
            numpy.float32)
        self._grid_ = torch.from_numpy(grid).to(self.device.torch_device)
        self.load_state()

    def load_state(self):
        """The live codebook and a zero accumulator from ``weights``
        (after initialize, or weights carried in)."""
        self._w_ = self.weights.devmem.clone()
        self._qacc_ = torch.zeros((), dtype=torch.float32,
                                  device=self._w_.device)
        self._epoch_samples = 0

    def _schedule(self):
        t = min(self.epoch_number or 0, self.epochs) / max(self.epochs, 1)
        lr = self.learning_rate * (
            self.learning_rate_final / self.learning_rate) ** t
        sigma = self.sigma * (self.sigma_final / self.sigma) ** t
        return lr, sigma

    def run(self):
        if self.minibatch_class != loader_mod.TRAIN:
            return
        lr, sigma = self._schedule()
        # the jit's f32 scalars: lr and sigma rounded, 2σ² in f32
        sigma = numpy.float32(sigma)
        denom = numpy.float32(2.0) * sigma * sigma
        size = int(self.minibatch_size)
        self._w_, self._qacc_ = train_batch(
            self._w_, self._qacc_, self._samples(), size, self._grid_,
            float(numpy.float32(lr)), float(denom))
        self._epoch_samples += size
        if bool(self.last_minibatch):
            self.qerror.map_write()[0] = (
                float(self._qacc_) / max(self._epoch_samples, 1))
            self._qacc_ = torch.zeros_like(self._qacc_)
            self._epoch_samples = 0
            self.weights.devmem = self._w_.clone()

    def get_metric_values(self):
        return {"mean_quantization_error": float(self.qerror[0])}


class KohonenDecision(Unit, IResultProvider):
    """Epoch counter and quantization-error tracker of SOM training."""

    MAPPING = "kohonen_decision"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "DECISION"
        self.max_epochs = int(kwargs.get("max_epochs", 50))
        self.silent = bool(kwargs.get("silent", False))
        self.complete = Bool(False)
        self.qerror = None               # linked from the trainer
        self.epoch_number = None         # linked from the loader
        self.epoch_ended = None
        self.qerror_history = []

    def link_loader(self, loader):
        self.link_attrs(loader, "epoch_number", "epoch_ended")
        return self

    def link_trainer(self, trainer):
        self.link_attrs(trainer, "qerror")
        return self

    def run(self):
        if not bool(self.epoch_ended):
            return
        qe = float(self.qerror[0])
        self.qerror_history.append(qe)
        if not self.silent:
            print("Epoch %d: mean quantization error %.4f" %
                  (self.epoch_number, qe))
        if self.epoch_number + 1 >= self.max_epochs:
            self.complete <<= True

    def get_metric_values(self):
        return {"final_quantization_error":
                self.qerror_history[-1] if self.qerror_history else None,
                "epochs": len(self.qerror_history)}
