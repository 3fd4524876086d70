"""Local response normalization (AlexNet LRN): the kernels K5 (forward)
and K6 (backward), their plain versions, the band form and the units.

The port's counterpart of ``veles_tpu/znicz/lrn.py``.  Cross-channel LRN
over the last (channel) axis of an NHWC activation:

    y = x / (k + alpha/n * sum_{j in window} x_j^2) ** beta

with the window offsets ``-n//2 .. n-1-n//2`` (asymmetric for even n).
Two forms:

- the kernel pair, :func:`lrn_pair`: a ``torch.autograd.Function`` whose
  forward is :func:`lrn` (K5, ``csrc/lrn.cu``) and whose backward is
  :func:`lrn_backward` (K6), the closed form
  ``dx = g·den^-β − 2β·(α/n)·x·Wᵀ(g·x·den^-(β+1))`` with Wᵀ the window
  sum over the negated offsets.  Like the JAX package's ``custom_vjp``
  it saves ``x`` only.  CUDA tensors launch the kernels, or raise; CPU
  tensors take :func:`lrn_reference` and :func:`lrn_backward_reference`,
  which follow the Pallas body's formula.  Each wrapper counts its
  launches in ``.launches`` (CPU calls do not count).
- the band form, :func:`lrn_mxu`: the window sum as one ``[C, C]`` 0/1
  band matmul, differentiated by autograd (with ``beta == 0.75`` the
  power is ``rsqrt(den) * sqrt(rsqrt(den))``).

``use_pallas`` keeps its name and the port's tri-state semantics
(:func:`~.nn_units.resolve_use_pallas`): True runs the kernel pair (the
plain versions on the CPU), False the band form, unset the kernel pair
on the card and the band form elsewhere.  The JAX package's unset
resolves to the band form on the TPU too: there the ``pallas_call``
boundary kept XLA from fusing LRN into its neighbours and the pair lost
end to end.  Eager PyTorch on the card has no such fusion to lose, so
the choice here rests on the card's own numbers (``chip_smoke.py``
trains AlexNet with both forms; ``PERF.md``).  On the card the unset
choice is the ``lrn`` autotune site (``impl``: ``kernel`` or ``band``,
by channel count and window), whose default is the kernel pair, so with
the tuner off nothing changes.  The JAX site's ``block_rows`` chose a
TPU VMEM tile; the CUDA kernels choose their own, so it is not carried
over.
"""

import ctypes
import functools

import torch

from .. import _build
from ..config import root
from .nn_units import ParamlessForward, GenericVJPBackward, \
    resolve_use_pallas

__all__ = ["lrn", "lrn_backward", "lrn_reference", "lrn_backward_reference",
           "lrn_pair", "lrn_mxu", "LRNormalizerForward",
           "LRNormalizerBackward"]

_SRC = "lrn"
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)


def _window_sum(v, n, transpose=False):
    """Channel-axis window sum over the offsets ``-n//2 .. n-1-n//2``
    (negated where ``transpose``), added in the Pallas body's order;
    channels outside the row count as zeros."""
    c = v.shape[-1]
    half = n // 2
    offsets = range(-half, n - half)
    if transpose:
        offsets = [-o for o in offsets]
    acc = None
    for off in offsets:
        if off == 0:
            t = v
        else:
            t = torch.zeros_like(v)
            if off > 0:
                t[..., :max(c - off, 0)] = v[..., off:]
            else:
                t[..., -off:] = v[..., :max(c + off, 0)]
        acc = t if acc is None else acc + t
    return acc


def lrn_reference(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """Plain version of K5: ``x / (k + alpha/n * window_sum(x^2))^beta``."""
    acc = _window_sum(x * x, n)
    return x / (k + (alpha / n) * acc) ** beta


def lrn_backward_reference(x, g, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """Plain version of K6: the input gradient of LRN at ``x`` for the
    output gradient ``g``."""
    c = alpha / n
    den = k + c * _window_sum(x * x, n)
    inner = g * x * den ** (-beta - 1.0)
    return (g * den ** -beta -
            2.0 * beta * c * x * _window_sum(inner, n, transpose=True))


def _on_cpu(name, *tensors):
    """True for CPU operands (the plain versions), False for CUDA ones
    (the kernels); raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("%s: operands on several devices: %s"
                         % (name, sorted(map(str, devices))))
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError("%s: operands on %s; want cuda (the kernel) or "
                         "cpu (the plain version)" % (name, kind))
    return kind == "cpu"


def _rows(x, what):
    """(rows, channels) of a dense f32 CUDA tensor.  Any number of
    channels: the kernels cut rows past 1024 channels into chunks."""
    if x.dtype != torch.float32:
        raise ValueError("%s must be float32, got %s" % (what, x.dtype))
    if x.ndim < 1 or not x.is_contiguous():
        raise ValueError("%s must be dense rows of channels (contiguous, "
                         "channels last), got shape %r strides %r"
                         % (what, tuple(x.shape), x.stride()))
    c = x.shape[-1]
    if c < 1:
        raise ValueError("%s has no channels" % what)
    return x.numel() // c, c


def _check_n(n):
    if int(n) < 1:
        raise ValueError("LRN window n must be >= 1, got %r" % (n,))
    return int(n)


def lrn(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """K5: LRN over the last axis of ``x``.  A CUDA tensor (f32, dense)
    launches the kernel; a CPU tensor runs :func:`lrn_reference`."""
    n = _check_n(n)
    if _on_cpu("lrn", x):
        return lrn_reference(x, n, alpha, beta, k)
    rows, c = _rows(x, "x")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _build.function(_SRC, "vt_lrn_fwd",
                         [_P, _P, _L, _I, _I, _F, _F, _F, _P])
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), rows, c, n, alpha / n,
                  float(k), float(beta), _build.stream_ptr(x.device))
    _build.check(_SRC, code, "LRN forward kernel")
    lrn.launches += 1
    return out


def lrn_backward(x, g, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """K6: the input gradient of LRN at ``x`` for the output gradient
    ``g`` (same shape).  CUDA tensors (f32, dense) launch the kernel;
    CPU tensors run :func:`lrn_backward_reference`."""
    n = _check_n(n)
    if _on_cpu("lrn_backward", x, g):
        return lrn_backward_reference(x, g, n, alpha, beta, k)
    if g.shape != x.shape:
        raise ValueError("g %r != x %r" % (tuple(g.shape), tuple(x.shape)))
    rows, c = _rows(x, "x")
    _rows(g, "g")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx
    fn = _build.function(_SRC, "vt_lrn_bwd",
                         [_P, _P, _P, _L, _I, _I] + [_F] * 5 + [_P])
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, n,
                  alpha / n, float(k), -beta, -beta - 1.0,
                  2.0 * beta * (alpha / n), _build.stream_ptr(x.device))
    _build.check(_SRC, code, "LRN backward kernel")
    lrn_backward.launches += 1
    return dx


#: kernel launches since the last reset (CPU calls do not count)
lrn.launches = 0
lrn_backward.launches = 0
_build.counted(lrn)
_build.counted(lrn_backward)


class _LRNPair(torch.autograd.Function):
    """Forward K5, saving x only; backward K6."""

    @staticmethod
    def forward(ctx, x, n, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hyper = (n, alpha, beta, k)
        return lrn(x, n, alpha, beta, k)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if g.device.type == "cuda" and not g.is_contiguous():
            g = g.contiguous()
        return (lrn_backward(x, g, *ctx.hyper),) + (None,) * 4


def lrn_pair(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """Differentiable LRN through the kernel pair: forward :func:`lrn`
    (K5), backward :func:`lrn_backward` (K6)."""
    return _LRNPair.apply(x, _check_n(n), float(alpha), float(beta),
                          float(k))


@functools.lru_cache(maxsize=64)
def _band(c, n, device):
    """The [C, C] 0/1 band: ``(v @ band)[..., i]`` is the window sum of
    channel i over the offsets ``-n//2 .. n-1-n//2``."""
    half = n // 2
    j = torch.arange(c, device=device)
    d = j[:, None] - j[None, :]        # band[j, i] = 1 iff j - i in window
    return ((d >= -half) & (d <= n - 1 - half)).to(torch.float32)


def lrn_mxu(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """The band form of the LRN forward (the JAX package's ``lrn_mxu``):
    the window sum as one ``[C, C]`` matmul; autograd gives the
    transposed band for the backward."""
    n = _check_n(n)
    acc = torch.matmul(x * x, _band(x.shape[-1], n, x.device))
    den = k + (alpha / n) * acc
    if beta == 0.75:
        # den^-3/4 = rsqrt(den) * sqrt(rsqrt(den))
        r = torch.rsqrt(den)
        return x * (r * torch.sqrt(r))
    return x / den ** beta


class LRNormalizerForward(ParamlessForward):
    """LRN over the channels of an NHWC input (``alpha`` 1e-4, ``beta``
    0.75, ``k`` 2, ``n`` 5 by default)."""

    MAPPING = "norm"

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.alpha = float(kwargs.get("alpha", 1e-4))
        self.beta = float(kwargs.get("beta", 0.75))
        self.k = float(kwargs.get("k", 2.0))
        self.n = _check_n(kwargs.get("n", 5))
        up = kwargs.get("use_pallas",
                        root.common.engine.get("use_pallas", None))
        self.use_pallas = up if up is None else bool(up)
        #: where the last apply's form came from: "tuned" or "default"
        #: (the ``lrn`` site), or "explicit" (``use_pallas`` set)
        self.config_source = "default"

    def _resolved_use_pallas(self, channels=None):
        """Whether ``apply`` runs the kernel pair (else the band form).
        Unset on the card with ``channels`` known, the ``lrn`` autotune
        site decides (tuner off: the kernel pair)."""
        use = resolve_use_pallas(self.use_pallas, self.device)
        if self.use_pallas is not None:
            self.config_source = "explicit"
        elif use and channels is not None:
            from ..autotune import dispatch
            cfg, self.config_source = dispatch.resolve(
                "lrn", "c%d_n%d" % (channels, self.n),
                default={"impl": "kernel"})
            use = cfg["impl"] == "kernel"
        return use

    def apply(self, params, x):
        form = lrn_pair if self._resolved_use_pallas(x.shape[-1]) \
            else lrn_mxu
        return form(x, self.n, self.alpha, self.beta, self.k)

    def export_params(self):
        return {"alpha": self.alpha, "beta": self.beta, "k": self.k,
                "n": self.n}


class LRNormalizerBackward(GenericVJPBackward):
    """The vjp of the forward's ``apply``.  In graph mode it
    differentiates the train forward's kept graph: with the kernel pair
    a train step launches K5 once (the forward's ``run``) and K6 once
    (this unit's, through ``_LRNPair.backward``)."""

    MAPPING = "norm"
