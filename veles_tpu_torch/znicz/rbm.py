"""Restricted Boltzmann Machine: the CD-1 trainer (no gradients).

The port's counterpart of ``veles_tpu/znicz/rbm.py`` (the Znicz RBM
units): one contrastive-divergence step a minibatch on the unit's
device, the hidden units sampled given the visible ones, the visible
reconstructed from the sample (mean field), the hidden probabilities
taken again from the reconstruction, and ``W += lr · (v·ph - pv·ph2) /
n`` over the valid rows; the reconstruction error accumulates on the
device.

The hidden draw is the JAX package's: ``jax.random.split`` of
``jax.random.PRNGKey(seed)``, the first key's ``uniform`` below ``ph``
(:mod:`veles_tpu_torch.prng`, the same bits).  The seed counter starts
at ``seed % 0x7FFF0000`` and steps before every train minibatch.  A
draw within an ulp of ``ph`` can fall the other way where the device's
``sigmoid`` or matmul rounds otherwise than XLA's.
"""

import numpy
import torch

from .. import loader as loader_mod
from .. import prng
from ..accelerated_units import AcceleratedUnit
from ..memory import Array
from ..result_provider import IResultProvider

__all__ = ["RBMTrainer", "hidden_draw", "cd1"]

#: the seed counter's modulus
SEED_WRAP = 0x7FFF0000


def hidden_draw(w, hb, v, seed):
    """``(ph, u, h)`` of CD-1's hidden sample: ``ph = sigmoid(v @ w +
    hb)``, the uniforms ``u`` of the first key split from ``seed`` and
    ``h = (u < ph)`` in ``v``'s dtype, on ``v``'s device."""
    ph = torch.sigmoid(v @ w + hb)
    kh, _ = prng.split(prng.key(seed))
    u = prng.uniform(kh, ph.shape, ph.device)
    return ph, u, (u < ph).to(v.dtype)


def cd1(w, vb, hb, eacc, v, mask, seed, lr):
    """One CD-1 step over the rows of ``v`` where ``mask`` is 1; ->
    (w, vb, hb, eacc plus the step's summed squared reconstruction
    error)."""
    ph, _, h = hidden_draw(w, hb, v, seed)
    pv = torch.sigmoid(h @ w.T + vb)
    ph2 = torch.sigmoid(pv @ w + hb)
    m = mask[:, None]
    nv = torch.clamp_min(mask.sum(), 1.0)
    dw = ((v * m).T @ ph - (pv * m).T @ ph2) / nv
    dvb = ((v - pv) * m).sum(dim=0) / nv
    dhb = ((ph - ph2) * m).sum(dim=0) / nv
    err = (((v - pv) ** 2) * m).sum() / nv
    return (w + lr * dw, vb + lr * dvb, hb + lr * dhb,
            eacc + err * mask.sum())


class RBMTrainer(AcceleratedUnit, IResultProvider):
    """Binary-binary RBM trained with CD-1.

    kwargs: ``n_hidden`` (64), ``learning_rate`` (0.1),
    ``weights_stddev`` (0.01), ``prng`` (the initial weights'
    generator; default ``RandomGenerator`` seeded 2, the JAX package's
    bytes; both biases start at zeros), ``seed`` (11).  On the last
    minibatch of a class it writes ``recon_error`` (the epoch's mean
    reconstruction error) and publishes ``weights``, ``vbias`` and
    ``hbias``."""

    MAPPING = "rbm_trainer"
    #: the arrays ``convert.trainer_params_from_jax`` carries
    PARAMS = ("weights", "vbias", "hbias")

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.n_hidden = int(kwargs.get("n_hidden", 64))
        self.learning_rate = float(kwargs.get("learning_rate", 0.1))
        self.weights_stddev = float(kwargs.get("weights_stddev", 0.01))
        self.prng = kwargs.get("prng")
        self.weights = Array()       # [n_visible, n_hidden]
        self.vbias = Array()
        self.hbias = Array()
        self.minibatch_data = None   # linked from the loader
        self.minibatch_size = None
        self.minibatch_class = None
        self.last_minibatch = None
        self.epoch_number = None
        self.recon_error = Array(numpy.zeros(1, numpy.float64))
        self._seed_counter = int(kwargs.get("seed", 11)) % SEED_WRAP
        self._epoch_samples = 0

    def link_loader(self, loader):
        self.link_attrs(loader, "minibatch_data", "minibatch_size",
                        "minibatch_class", "last_minibatch",
                        "epoch_number")
        return self

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        n_visible = int(numpy.prod(self.minibatch_data.shape[1:]))
        if not self.weights:
            gen = self.prng or prng.RandomGenerator().seed(2)
            self.weights.mem = gen.normal(
                0.0, self.weights_stddev,
                (n_visible, self.n_hidden)).astype(numpy.float32)
            self.vbias.mem = numpy.zeros(n_visible, numpy.float32)
            self.hbias.mem = numpy.zeros(self.n_hidden, numpy.float32)
        for arr in (self.weights, self.vbias, self.hbias):
            arr.initialize(self.device)
        self.load_state()

    def load_state(self):
        """The live parameters and a zero accumulator from the public
        Arrays (after initialize, or parameters carried in)."""
        self._w_ = self.weights.devmem.clone()
        self._vb_ = self.vbias.devmem.clone()
        self._hb_ = self.hbias.devmem.clone()
        self._eacc_ = torch.zeros((), dtype=torch.float32,
                                  device=self._w_.device)
        self._epoch_samples = 0

    def run(self):
        if self.minibatch_class != loader_mod.TRAIN:
            return
        v = self.minibatch_data.devmem
        v = v.reshape(v.shape[0], -1)
        size = int(self.minibatch_size)
        mask = (torch.arange(v.shape[0], device=v.device) < size).to(
            v.dtype)
        self._seed_counter = (self._seed_counter + 1) % SEED_WRAP
        self._w_, self._vb_, self._hb_, self._eacc_ = cd1(
            self._w_, self._vb_, self._hb_, self._eacc_, v, mask,
            self._seed_counter, self.learning_rate)
        self._epoch_samples += size
        if bool(self.last_minibatch):
            self.recon_error.map_write()[0] = (
                float(self._eacc_) / max(self._epoch_samples, 1))
            self._eacc_ = torch.zeros_like(self._eacc_)
            self._epoch_samples = 0
            self.weights.devmem = self._w_.clone()
            self.vbias.devmem = self._vb_.clone()
            self.hbias.devmem = self._hb_.clone()

    def get_metric_values(self):
        return {"reconstruction_error": float(self.recon_error[0])}
