"""Dropout forward/backward units.

The port's counterpart of ``veles_tpu/znicz/dropout.py``: inverted
dropout, ``x * bernoulli(1 - p) / (1 - p)`` at train time and the
identity at eval time.  The key arrives as an argument
(``apply_train(params, x, key)``; the fused step folds one per
stochastic layer out of its step seed), and the mask's bits are those of
``jax.random.bernoulli`` for the same key (:mod:`veles_tpu_torch.prng`,
threefry2x32 in torch integer ops on the input's device).  The forward
records the key it drew as ``last_key``, and the backward regenerates
the same mask from it: no mask buffer, as in the JAX package.
"""

import torch

from .. import prng
from .nn_units import ParamlessForward, GradientDescentBase

__all__ = ["DropoutForward", "DropoutBackward"]


class DropoutForward(ParamlessForward):
    MAPPING = "dropout"
    stochastic = True

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.dropout_ratio = float(kwargs.get("dropout_ratio", 0.5))
        self.key_tree = kwargs.get("key_tree") or prng.KeyTree(
            kwargs.get("seed", 42))
        self.last_key = None

    def mask(self, key, shape, device):
        """The keep mask of ``key``: ``jax.random.bernoulli(key, 1 - p,
        shape)``'s bits."""
        return prng.bernoulli(key, 1.0 - self.dropout_ratio, shape, device)

    def apply(self, params, x):
        return x

    def apply_train(self, params, x, key):
        self.last_key = key
        return self.drop(x, key)

    def drop(self, x, key):
        """``x`` where the mask of ``key`` keeps, +0 elsewhere, over the
        keep probability (XLA folds the JAX unit's ``x * mask`` into this
        select: a dropped negative element is +0 there too)."""
        keep = 1.0 - self.dropout_ratio
        mask = self.mask(key, x.shape, x.device)
        return torch.where(mask, x, x.new_zeros(())) / keep


class DropoutBackward(GradientDescentBase):
    """Regenerates the forward's mask from its recorded key and routes the
    error through it."""

    MAPPING = "dropout"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("learning_rate", 0.0)
        super().__init__(workflow, **kwargs)

    def backward(self, params, x, y, err_output, n_valid=None):
        fwd = self.forward_unit
        if fwd.last_key is None:
            return err_output, {}
        return fwd.drop(err_output, fwd.last_key), {}
