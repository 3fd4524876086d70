"""Flash attention: the kernels K7 (forward), K8 (dq) and K9 (dk, dv) and
their plain versions.

The port's counterpart of ``veles_tpu/znicz/flash_attention.py``.
:func:`flash_attention` is softmax attention in the ``[B, T, H, D]``
layout of :func:`~veles_tpu_torch.parallel.ring.attention_reference`,
with no mask, a causal one, or a causal sliding window (position i sees
keys in ``(i - window, i]``).  It is a ``torch.autograd.Function``:

- forward: :func:`flash_attention_fwd` (K7) returns the output and the
  per-row logsumexp ``lse`` ``[B * H, T]``, both saved;
- backward: ``delta = rowsum(dO * O)`` with a torch op (the JAX package
  computes it outside its kernels too), then :func:`flash_attention_dq`
  (K8) and :func:`flash_attention_dkv` (K9), which recompute the
  probabilities from ``lse``.

The kernels (``csrc/flash_attention.cu``) never hold a ``[T, T]`` score
matrix: K/V (or Q) tiles stream through shared memory, and a window
visits only the tiles inside its band.  They read q, k, v and dO through
their strides (the head dim must be unit stride), so the views a packed
QKV projection yields cost no copy; they take any T (a ragged last tile
is masked in the kernel) and any head dim, as the JAX kernels and the
plain versions do: up to 256 an operand tile stays resident in shared
memory, past it every product streams its operands over D in chunks
and the output columns split over more CTAs.  All three form their
products on the tensor cores in 3xTF32, which keeps f32's accuracy
(TF32 alone stays off); K7 keeps its online softmax in the accumulators
of the score tile and joins each key tile's ``P.V`` to its f32 sum as
``acc * alpha + tile``.  The JAX package's ``block_q``/``block_k``
chose TPU VMEM tiles; the CUDA kernels stream their own tiles (K7's and
K8's keys, K9's queries), and those are what the ``flash_attention``
and ``window_attention`` autotune sites choose (:func:`flash_tiles`):
each kernel's plan at its head dim, or at head dims 33-64 (attention
training's class) one other instantiation each.  With the tuner off
every call takes its plan's tiles, as without a tuner.

CUDA tensors launch the kernels, or raise; CPU tensors take
:func:`flash_fwd_reference`, :func:`flash_dq_reference` and
:func:`flash_dkv_reference`, which compute the same functions in plain
torch, materialising the scores a chunk of heads at a time.  Each
wrapper counts its launches in ``.launches`` (CPU calls do not count).
"""

import ctypes
import math

import torch

from .. import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv", "flash_delta", "flash_tiles",
           "flash_fwd_reference", "flash_dq_reference",
           "flash_dkv_reference"]

#: bytes of one ``[heads, T, T]`` f32 tensor of a plain version's chunk
_CHUNK_BYTES = 1 << 30

_SRC = "flash_attention"
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_VIEW = [_P, _L, _L, _L]
# B, T, H, D, scale, causal, window, the streamed tile, the stream
_TAIL = [_I] * 4 + [_F, _I, _I, _I, _P]


def _check_window(causal, window):
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1, got %r" % (window,))


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _check(q, k, v, causal, window, *more):
    """Shapes and masks every entry takes -> True for CPU operands
    (the plain versions), False for CUDA ones (the kernels)."""
    _check_window(causal, window)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("want q, k, v of one [B, T, H, D] shape, got %r, "
                         "%r, %r" % (tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape)))
    if q.shape[-1] < 1:
        raise ValueError("head dim %d must be >= 1" % q.shape[-1])
    devices = {t.device for t in (q, k, v) + more}
    if len(devices) != 1:
        raise ValueError("operands on several devices: %s"
                         % sorted(map(str, devices)))
    return q.device.type == "cpu"


def _view(x, name):
    """(pointer, batch, time, head strides) of a [B, T, H, D] f32 CUDA
    tensor whose head dim is unit stride."""
    if x.dtype != torch.float32:
        raise ValueError("%s must be float32, got %s" % (name, x.dtype))
    if x.stride(3) != 1 and x.shape[3] > 1:
        raise ValueError("%s: the head dim must be unit stride" % name)
    return [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)]


def _rows(x, name, b, h, t):
    """A contiguous f32 [B * H, T] row-stat tensor."""
    if tuple(x.shape) != (b * h, t) or x.dtype != torch.float32 or \
            not x.is_contiguous():
        raise ValueError("%s must be contiguous f32 [B * H, T] = %r, got "
                         "%s %r" % (name, (b * h, t), x.dtype,
                                    tuple(x.shape)))
    return x.data_ptr()


def _tail(q, causal, scale, window, tile):
    b, t, h, d = q.shape
    return [b, t, h, d, float(_scale(q, scale)), int(bool(causal)),
            int(window or 0), int(tile), _build.stream_ptr(q.device)]


def flash_tiles(q, causal=False, window=None):
    """The streamed tiles of K7-K9 for a call on ``q`` ([B, T, H, D]):
    ``{"fwd_block_k", "dq_block_k", "dkv_block_q"}``, resolved through
    the ``window_attention`` site (a window) or the ``flash_attention``
    one (tuner off: the kernels' plans at the head dim)."""
    from ..autotune import dispatch, space
    name = "window_attention" if window is not None else "flash_attention"
    ctx = {"t": q.shape[1], "d": q.shape[3], "causal": bool(causal)}
    if window is not None:
        ctx["window"] = window
    sp = space.site(name)
    cfg, _ = dispatch.resolve(name, sp.shape_class(ctx),
                              default=sp.default_for(ctx))
    return cfg


def flash_delta(do, out):
    """``delta = rowsum(dO * O)`` of the backward as contiguous
    ``[B * H, T]`` rows, the layout of ``lse`` (a torch op, as the JAX
    package computes it outside its kernels)."""
    b, t, h, _ = out.shape
    return (do * out).sum(dim=-1).permute(0, 2, 1).reshape(
        b * h, t).contiguous()


# -- plain versions -----------------------------------------------------------

def _to_bh(x):
    """[B, T, H, D] -> [B * H, T, D] f32."""
    b, t, h, d = x.shape
    return x.to(torch.float32).permute(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bh(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3).contiguous()


def _mask(t, causal, window, device):
    """[T, T] bool, True where a key is hidden from a query; None
    without a mask."""
    if not causal:
        return None
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    mask = cols > rows
    if window is not None:
        mask = mask | (cols <= rows - window)
    return mask


def _chunks(bh, t):
    """Slices of the B * H axis whose [n, T, T] f32 scores fit in
    ``_CHUNK_BYTES``."""
    n = max(1, _CHUNK_BYTES // (4 * t * t))
    return [slice(lo, min(lo + n, bh)) for lo in range(0, bh, n)]


def flash_fwd_reference(q, k, v, causal=False, scale=None, window=None):
    """Plain version of K7: ``(out [B, T, H, D], lse [B * H, T])`` with
    the kernel's guards (a fully masked row gives 0 and lse 0)."""
    _check_window(causal, window)
    b, t, h, d = q.shape
    scale = _scale(q, scale)
    qb, kb, vb = _to_bh(q), _to_bh(k), _to_bh(v)
    mask = _mask(t, causal, window, q.device)
    out = torch.empty_like(qb)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    for c in _chunks(b * h, t):
        s = torch.matmul(qb[c] * scale, kb[c].transpose(1, 2))
        if mask is not None:
            s.masked_fill_(mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        safe_m = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.exp(s - safe_m)
        del s
        l_ = p.sum(dim=-1, keepdim=True)
        safe_l = torch.where(l_ == 0, 1.0, l_)
        out[c] = torch.matmul(p, vb[c]) / safe_l
        lse[c] = (safe_m + torch.log(safe_l))[..., 0]
    return _from_bh(out, b, h), lse


def _backward_chunks(q, k, v, do, lse, delta, causal, scale, window):
    """Yield (chunk, q, k, dO, p, ds) per chunk of heads, [n, T, *]:
    ``p = exp(q k^T * scale - lse)`` (0 where masked) and
    ``ds = p * (dO v^T - delta)``."""
    _check_window(causal, window)
    b, t, h, d = q.shape
    scale = _scale(q, scale)
    qb, kb, vb, dob = _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(do)
    mask = _mask(t, causal, window, q.device)
    for c in _chunks(b * h, t):
        s = torch.matmul(qb[c], kb[c].transpose(1, 2)) * scale
        p = torch.exp(s - lse[c, :, None])
        del s
        if mask is not None:
            p.masked_fill_(mask, 0.0)
        ds = p * (torch.matmul(dob[c], vb[c].transpose(1, 2))
                  - delta[c, :, None])
        yield c, qb[c], kb[c], dob[c], p, ds


def flash_dq_reference(q, k, v, do, lse, delta, causal=False, scale=None,
                       window=None):
    """Plain version of K8: ``dq = (ds k) * scale``, [B, T, H, D]."""
    b, t, h, d = q.shape
    scale = _scale(q, scale)
    dq = torch.empty((b * h, t, d), dtype=torch.float32, device=q.device)
    for c, _, kb, _, _, ds in _backward_chunks(q, k, v, do, lse, delta,
                                               causal, scale, window):
        dq[c] = torch.matmul(ds, kb) * scale
    return _from_bh(dq, b, h)


def flash_dkv_reference(q, k, v, do, lse, delta, causal=False, scale=None,
                        window=None):
    """Plain version of K9: ``(dk, dv) = ((ds^T q) * scale, p^T dO)``,
    each [B, T, H, D]."""
    b, t, h, d = q.shape
    scale = _scale(q, scale)
    dk = torch.empty((b * h, t, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for c, qb, _, dob, p, ds in _backward_chunks(q, k, v, do, lse, delta,
                                                 causal, scale, window):
        dv[c] = torch.matmul(p.transpose(1, 2), dob)
        dk[c] = torch.matmul(ds.transpose(1, 2), qb) * scale
    return _from_bh(dk, b, h), _from_bh(dv, b, h)


# -- the kernels --------------------------------------------------------------

def flash_attention_fwd(q, k, v, causal=False, scale=None, window=None,
                        tiles=None):
    """K7: ``(out [B, T, H, D], lse [B * H, T])``.  CUDA operands launch
    the kernel (``tiles``: default :func:`flash_tiles`); CPU operands
    run :func:`flash_fwd_reference`."""
    if _check(q, k, v, causal, window):
        return flash_fwd_reference(q, k, v, causal, scale, window)
    tiles = tiles or flash_tiles(q, causal, window)
    b, t, h, _ = q.shape
    args = _view(q, "q") + _view(k, "k") + _view(v, "v")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    fn = _build.function(_SRC, "vt_flash_fwd", _VIEW * 3 + [_P, _P] + _TAIL)
    with torch.cuda.device(q.device):
        code = fn(*args, out.data_ptr(), lse.data_ptr(),
                  *_tail(q, causal, scale, window, tiles["fwd_block_k"]))
    _build.check(_SRC, code, "flash attention forward kernel")
    flash_attention_fwd.launches += 1
    return out, lse


def _backward_args(q, k, v, do, lse, delta):
    """The operands of K8 / K9 (CUDA tensors), checked."""
    b, t, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError("dO %r != q %r" % (tuple(do.shape), tuple(q.shape)))
    return (_view(q, "q") + _view(k, "k") + _view(v, "v") + _view(do, "dO")
            + [_rows(lse, "lse", b, h, t), _rows(delta, "delta", b, h, t)])


def flash_attention_dq(q, k, v, do, lse, delta, causal=False, scale=None,
                       window=None, tiles=None):
    """K8: dq [B, T, H, D] from the forward's ``lse`` and ``delta`` (both
    [B * H, T]; :func:`flash_delta`).  CUDA operands launch the kernel
    (``tiles``: default :func:`flash_tiles`); CPU operands run
    :func:`flash_dq_reference`."""
    if _check(q, k, v, causal, window, do, lse, delta):
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale,
                                  window)
    tiles = tiles or flash_tiles(q, causal, window)
    args = _backward_args(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = _build.function(_SRC, "vt_flash_dq",
                         _VIEW * 4 + [_P, _P, _P] + _TAIL)
    with torch.cuda.device(q.device):
        code = fn(*args, dq.data_ptr(),
                  *_tail(q, causal, scale, window, tiles["dq_block_k"]))
    _build.check(_SRC, code, "flash attention dq kernel")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
                        window=None, tiles=None):
    """K9: ``(dk, dv)``, each [B, T, H, D], from ``lse`` and ``delta``.
    CUDA operands launch the kernel (``tiles``: default
    :func:`flash_tiles`); CPU operands run :func:`flash_dkv_reference`."""
    if _check(q, k, v, causal, window, do, lse, delta):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale,
                                   window)
    tiles = tiles or flash_tiles(q, causal, window)
    args = _backward_args(q, k, v, do, lse, delta)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    fn = _build.function(_SRC, "vt_flash_dkv",
                         _VIEW * 4 + [_P] * 4 + _TAIL)
    with torch.cuda.device(q.device):
        code = fn(*args, dk.data_ptr(), dv.data_ptr(),
                  *_tail(q, causal, scale, window, tiles["dkv_block_q"]))
    _build.check(_SRC, code, "flash attention dk/dv kernel")
    flash_attention_dkv.launches += 1
    return dk, dv


#: kernel launches since the last reset (CPU calls do not count)
flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward K7, saving (q, k, v, out, lse); backward delta by a torch
    op, then K8 and K9."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        tiles = None if q.device.type == "cpu" else \
            flash_tiles(q, causal, window)
        out, lse = flash_attention_fwd(q, k, v, causal, scale, window,
                                       tiles)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, scale, window, tiles)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if g.stride(-1) != 1:     # e.g. the expanded gradient of a sum
            g = g.contiguous()
        delta = flash_delta(g, out)
        dq = flash_attention_dq(q, k, v, g, lse, delta, *ctx.mask)
        dk, dv = flash_attention_dkv(q, k, v, g, lse, delta, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, window=None):
    """Softmax attention over ``[B, T, H, D]`` q, k, v -> ``[B, T, H, D]``,
    differentiable; ``scale`` defaults to ``1 / sqrt(D)``.  ``window``
    (requires ``causal``): position i sees keys in ``(i - window, i]``."""
    _check_window(causal, window)
    return _FlashAttention.apply(q, k, v, bool(causal), scale, window)
