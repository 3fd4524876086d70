"""Multi-head attention forward / gradient-descent units.

The port's counterpart of ``veles_tpu/znicz/attention.py``.  Layout:
input [B, T, D]; packed QKV projection ``weights`` (D, 3D), output
projection ``proj`` (D, D) and an optional ``bias`` (D,).  The unit
follows the ForwardBase contract (``apply`` a function of its params,
``export_params``), so StandardWorkflow's fused step trains it like any
other layer, ``proj`` included.

The projections are ``torch.matmul`` (TF32 off), as the JAX package
leaves them to XLA.  The attention between them takes the flash kernels
(K7 forward, K8 and K9 backward; :mod:`.flash_attention`) or the dense
oracle :func:`~veles_tpu_torch.parallel.ring.attention_reference`, as the
tri-state ``use_pallas`` resolves (:func:`.nn_units.resolve_use_pallas`).
Ring attention over a sequence mesh (``mesh=``) waits for the
distributed slice and raises.
"""

import numpy

from ..config import root
from ..memory import Array
from ..parallel.ring import attention_reference
from .flash_attention import flash_attention
from .nn_units import ForwardBase, GradientDescentBase, resolve_use_pallas

__all__ = ["MultiHeadAttention", "GDMultiHeadAttention"]


class MultiHeadAttention(ForwardBase):
    """Self-attention over [B, T, D] sequences.

    kwargs:
      heads: number of attention heads (must divide D);
      causal: autoregressive masking;
      window: sliding-window attention, position i sees keys in
        (i - window, i]; requires ``causal``; the kernels visit only the
        tiles inside the band;
      use_pallas: tri-state (the JAX package's name, kept so configs
        move across).  True / False force the flash kernels / the dense
        oracle; unset (None, the default
        ``root.common.engine.use_pallas``) is AUTO: the kernels when the
        unit runs on the card, the oracle on the CPU.  On the CPU,
        ``use_pallas=True`` runs the kernels' plain versions through the
        same autograd Function.
    """

    MAPPING = "multihead_attention"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.heads = int(kwargs.get("heads", 1))
        self.causal = bool(kwargs.get("causal", False))
        self.window = kwargs.get("window")
        if self.window is not None:
            self.window = int(self.window)
            if not self.causal:
                raise ValueError("window requires causal=True")
            if self.window < 1:
                raise ValueError("window must be >= 1, got %d"
                                 % self.window)
        if kwargs.get("mesh") is not None:
            raise NotImplementedError(
                "ring attention over a mesh is not ported yet")
        up = kwargs.get("use_pallas",
                        root.common.engine.get("use_pallas", None))
        self.use_pallas = up if up is None else bool(up)
        self.proj = Array()
        self.exports = ["weights", "proj", "bias"]

    def init_params(self):
        b, t, d = self.input_shape
        if d % self.heads:
            raise ValueError("heads=%d must divide model dim %d"
                             % (self.heads, d))
        stddev = self.weights_stddev or 1.0 / numpy.sqrt(d)
        self.fill_array(self.weights, (d, 3 * d), stddev,
                        self.weights_filling)
        self.fill_array(self.proj, (d, d), stddev, self.weights_filling)
        if self.include_bias:
            self.fill_array(self.bias, (d,), self.bias_stddev or stddev,
                            self.bias_filling)

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        self.proj.initialize(self.device)

    @property
    def params(self):
        p = {"weights": self.weights.devmem, "proj": self.proj.devmem}
        if self.include_bias and self.bias:
            p["bias"] = self.bias.devmem
        return p

    def set_params(self, params):
        super().set_params(params)
        if "proj" in params:
            self.proj.devmem = params["proj"]

    @property
    def host_params(self):
        p = super().host_params
        if self.proj:
            p["proj"] = self.proj.map_read()
        return p

    def set_host_params(self, params):
        super().set_host_params(params)
        if "proj" in params:
            self.proj.mem = numpy.array(params["proj"], numpy.float32)

    def output_shape_for(self, input_shape):
        return tuple(input_shape)

    def _resolved_use_pallas(self):
        return resolve_use_pallas(self.use_pallas, self.device)

    def _attend(self, q, k, v):
        if self._resolved_use_pallas():
            return flash_attention(q, k, v, self.causal, window=self.window)
        return attention_reference(q, k, v, causal=self.causal,
                                   window=self.window)

    def apply(self, params, x):
        b, t, d = x.shape
        h = self.heads
        qkv = x @ params["weights"]                     # [B, T, 3D]
        # strided [B, T, H, D/H] views; one split, so the backward
        # assembles d(qkv) with one concatenation
        q, k, v = (part.reshape(b, t, h, d // h)
                   for part in qkv.split(d, dim=-1))
        out = self._attend(q, k, v).reshape(b, t, d)
        y = out @ params["proj"]
        if "bias" in params:
            y = y + params["bias"]
        return y

    def export_params(self):
        out = {"heads": int(self.heads), "causal": bool(self.causal),
               "include_bias": bool(self.include_bias)}
        if self.window is not None:
            out["window"] = int(self.window)
        return out


class GDMultiHeadAttention(GradientDescentBase):
    """Trainer of MultiHeadAttention: its hyperparameters and solver
    state (``proj`` is a weight like ``weights``), and a backward through
    autograd of the forward's ``apply``."""

    MAPPING = "multihead_attention"

    def backward(self, params, x, y, err_output, n_valid=None):
        """``(err_input, grads)`` with the grads divided by ``n_valid``
        (default: the batch)."""
        if n_valid is None:
            n_valid = x.shape[0]
        return self.backward_via_vjp(params, x, err_output, n_valid)
