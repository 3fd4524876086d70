"""The two GEMMs of ``veles_tpu/znicz/gemm.py``: CUDA kernels and their
plain versions.

**Compensated training GEMM** (:func:`precise_matmul`, kernel K4 in
``csrc/precise_matmul.cu``): the reference's PRECISION_LEVEL 0/1/2.  K
is cut into tiles of ``DEFAULT_BLOCK_K`` columns; each tile's partial
product is summed plainly, and the running sum of the tiles is
compensated (level 0 plain, 1 Neumaier TwoSum, 2 Klein's doubly
compensated sum), the carries folded in after the last tile.  It is a
``torch.autograd.Function`` whose backward is the same kernel twice
(``g @ b.T`` and ``a.T @ g``, passed as strided views, no copies); the
``dx`` call is skipped when nothing needs it (a first layer).

**Weight-quantized serving GEMM** (:func:`quantized_matmul`, kernel K3
in ``csrc/quantized_matmul.cu``).  Weights are static at serve time, so
they quantize ONCE — symmetric, one f32 scale per output channel — and
the kernel streams int8 or float8-e4m3 bytes, upcasts them to f32 in
registers on the card and folds the channel scales into the output
after the K loop.  That is exact up to the weight quantization itself,
because per-output-channel scales factor out of the K contraction.
:func:`quantized_matmul_plan` gives the tile and the split-K the kernel
takes for a shape on a card.

CUDA tensors launch the kernels; CPU tensors take
:func:`precise_matmul_reference` / :func:`quantized_matmul_reference`.
``precise_matmul.launches`` and ``quantized_matmul.launches`` count the
kernel launches; ``precise_matmul.fold_launches`` counts the K4 calls
that split K over their 256-deep tiles (small output grids) and so
launched the fold kernel after the products, and
``quantized_matmul.fold_launches`` the K3 calls that split K.
"""

import ctypes

import torch

from .. import _build

__all__ = ["precise_matmul", "precise_matmul_reference", "quantize_weight",
           "quantized_matmul", "quantized_matmul_plan",
           "quantized_matmul_reference", "fp8_dtype",
           "DEFAULT_BLOCK_K"]

#: K tile of the JAX kernels: the unit of compensated accumulation of
#: the precise GEMM; the plain versions accumulate K in tiles of this
#: depth, as the JAX references do
DEFAULT_BLOCK_K = 256

#: largest-magnitude finite value of float8_e4m3fn: per-channel scales
#: target it the way int8 targets 127
_FP8_E4M3_MAX = 448.0

_SRC = "quantized_matmul"
_PRECISE_SRC = "precise_matmul"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def fp8_dtype():
    """The fp8 storage dtype of the weight path."""
    return torch.float8_e4m3fn


def _quantize(w, dtype, dim):
    """Symmetric quantization of ``w`` with one scale per slice along
    every axis but ``dim`` (the contraction axis)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=dim)
    scale_shape = list(w.shape)
    scale_shape[dim] = 1
    if dtype == "int8":
        scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(w / scales.reshape(scale_shape)),
                        -127, 127)
        return q.to(torch.int8), scales
    if dtype == "fp8":
        scales = torch.where(amax > 0, amax / _FP8_E4M3_MAX,
                             torch.ones_like(amax))
        return (w / scales.reshape(scale_shape)).to(fp8_dtype()), scales
    raise ValueError("unknown weight dtype %r (want 'int8'|'fp8')"
                     % (dtype,))


def quantize_weight(w, dtype="int8"):
    """Symmetric per-output-channel quantization of a ``[K, N]`` weight.

    Returns ``(w_q, scales)``: ``w_q`` in ``dtype`` (``"int8"`` or
    ``"fp8"``), ``scales`` f32 ``[N]`` with ``scale[n] = max|w[:, n]| /
    qmax`` (1.0 for an all-zero column).  int8 rounds half to even, so
    the bytes equal the JAX package's for the same input.
    """
    if w.ndim != 2:
        raise ValueError("quantize_weight wants [K, N], got %r"
                         % (tuple(w.shape),))
    return _quantize(w, dtype, dim=0)


def quantized_matmul(a, w_q, scales):
    """``a @ dequant(w_q)`` with the dequant inside the kernel.

    ``a``: f32 [M, K]; ``w_q``: int8 or float8_e4m3fn [K, N] with f32
    ``scales`` [N] from :func:`quantize_weight`.  Returns f32 [M, N].
    CUDA tensors run the kernel (every operand contiguous, on one
    card), with the tile and split of :func:`quantized_matmul_plan`;
    CPU tensors run :func:`quantized_matmul_reference`.
    """
    if a.ndim != 2 or w_q.ndim != 2:
        raise ValueError("want a [M, K] and w_q [K, N], got %r and %r"
                         % (tuple(a.shape), tuple(w_q.shape)))
    m, k = a.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError("shape mismatch %r @ %r"
                         % (tuple(a.shape), tuple(w_q.shape)))
    if tuple(scales.shape) != (n,):
        raise ValueError("scales shape %r != (N,) == (%d,)"
                         % (tuple(scales.shape), n))
    if w_q.dtype not in (torch.int8, fp8_dtype()):
        raise ValueError("w_q must be int8 or float8_e4m3fn, got %s"
                         % w_q.dtype)
    if a.device.type == "cpu":
        return quantized_matmul_reference(a, w_q, scales)
    for name, t in (("a", a), ("w_q", w_q), ("scales", scales)):
        if t.device != a.device:
            raise ValueError("%s is on %s, a on %s"
                             % (name, t.device, a.device))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    for name, t in (("a", a), ("scales", scales)):
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" % (name, t.dtype))
    if m == 0 or n == 0 or k == 0:
        raise ValueError("empty operand: a %r, w_q %r"
                         % (tuple(a.shape), tuple(w_q.shape)))
    return _quantized_launch(a, w_q, scales,
                             quantized_matmul_plan(m, k, n, a.device))


def _quantized_launch(a, w_q, scales, plan):
    """One K3 call on checked CUDA operands with ``plan`` = (tile rows,
    split, K columns a split); a split call launches the fold too."""
    (m, k), n = a.shape, w_q.shape[1]
    tile_m, split, k_split = plan
    symbol = ("vt_quantized_matmul_int8" if w_q.dtype == torch.int8
              else "vt_quantized_matmul_fp8")
    fn = _build.function(_SRC, symbol, [_P] * 5 + [_I] * 6 + [_P])
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    # split-K: one partial a K range, added up by the kernel's second launch
    ws = (torch.empty((split, m, n), dtype=torch.float32, device=a.device)
          if split > 1 else None)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), ws.data_ptr() if split > 1 else None,
                  m, n, k, tile_m, split, k_split,
                  _build.stream_ptr(a.device))
    _build.check(_SRC, code, "quantized_matmul kernel")
    quantized_matmul.launches += 1
    if split > 1:
        quantized_matmul.fold_launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
quantized_matmul.launches = 0
#: of those, the calls that split K and launched the fold as well
quantized_matmul.fold_launches = 0

_QMM_PLANS = {}


def quantized_matmul_plan(m, k, n, device):
    """``(tile rows, split, K columns a split)`` K3 takes for an ``[m,
    k] @ [k, n]`` call on ``device``'s card: the kernel's rule
    (``vt_quantized_matmul_plan``), asked once a shape and card.  A
    split of 1 is one launch; above 1, each of ``split`` CTAs of an
    output tile sums its K range into a workspace and the fold adds the
    ranges in K order."""
    index = _device_index(device)
    key = (m, k, n, index)
    plan = _QMM_PLANS.get(key)
    if plan is None:
        buf = (ctypes.c_int * 3)()
        code = _build.function(
            _SRC, "vt_quantized_matmul_plan",
            [_I] * 4 + [ctypes.POINTER(ctypes.c_int)])(
                m, n, k, _sm_count(index), buf)
        _build.check(_SRC, code, "quantized_matmul plan")
        plan = _QMM_PLANS[key] = tuple(buf)
    return plan


def quantized_matmul_reference(a, w_q, scales):
    """Plain PyTorch version of :func:`quantized_matmul`, staged like
    the JAX reference: K-tile-sequential partial products of depth
    ``DEFAULT_BLOCK_K``, the scales folded in after the loop."""
    a = a.to(torch.float32)
    k = a.shape[1]
    bk = min(DEFAULT_BLOCK_K, k)
    acc = torch.zeros((a.shape[0], w_q.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, k, bk):
        acc = acc + a[:, k0:k0 + bk] @ w_q[k0:k0 + bk].to(torch.float32)
    return acc * scales.to(torch.float32)[None, :]


# -- compensated training GEMM (K4) -------------------------------------------

def _two_sum(a, b):
    """Knuth's exact TwoSum: ``a + b == s + e`` with ``e`` the rounding
    error of ``s`` (eager elementwise ops, never fused or reordered)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def precise_matmul_reference(a, b, level=1):
    """Plain PyTorch version of the precise GEMM: the same K-tile loop
    as the kernel, tile partials from ``torch.matmul`` (TF32 off), the
    running sum compensated at ``level`` 0 / 1 / 2."""
    _check_level(level)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, k = a.shape
    n = b.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    c1 = torch.zeros_like(acc)
    c2 = torch.zeros_like(acc)
    for k0 in range(0, k, DEFAULT_BLOCK_K):
        p = a[:, k0:k0 + DEFAULT_BLOCK_K] @ b[k0:k0 + DEFAULT_BLOCK_K]
        if level == 0:
            acc = acc + p
            continue
        acc, e = _two_sum(acc, p)
        if level == 1:
            c1 = c1 + e
        else:
            c1, e2 = _two_sum(c1, e)
            c2 = c2 + e2
    return acc + (c1 + c2)


def _check_level(level):
    if level not in (0, 1, 2):
        raise ValueError("precision level must be 0, 1 or 2, got %r"
                         % (level,))


def _precise_launch(a, b, level):
    """One K4 launch (CUDA operands, any strides) or the plain version
    (CPU operands)."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("want a [M, K] and b [K, N], got %r and %r"
                         % (tuple(a.shape), tuple(b.shape)))
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError("shape mismatch %r @ %r"
                         % (tuple(a.shape), tuple(b.shape)))
    _check_level(level)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return precise_matmul_reference(a, b, level)
    if a.device != b.device:
        raise ValueError("a is on %s, b on %s" % (a.device, b.device))
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" % (name, t.dtype))
    if m == 0 or n == 0 or k == 0:
        raise ValueError("empty operand: a %r, b %r"
                         % (tuple(a.shape), tuple(b.shape)))
    fn = _build.function(_PRECISE_SRC, "vt_precise_matmul",
                         [_P] * 4 + [_I] * 3 + [_L] * 4 + [_I, _I, _P])
    split = _precise_split(m, n, k, a.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    # split-K: one partial per K tile, folded by the kernel's second launch
    ws = (torch.empty((split, m, n), dtype=torch.float32, device=a.device)
          if split else None)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if split else None, m, n, k,
                  a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                  int(level), split, _build.stream_ptr(a.device))
    _build.check(_PRECISE_SRC, code, "precise_matmul kernel")
    precise_matmul.launches += 1
    if split:
        precise_matmul.fold_launches += 1
    return out


_SM_COUNT = {}


def _device_index(device):
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _sm_count(index):
    """The SM count of card ``index`` (read once a card)."""
    sms = _SM_COUNT.get(index)
    if sms is None:
        sms = _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def _precise_split(m, n, k, device):
    """The number of 256-deep K tiles K4 splits a call over (0: none):
    the kernel's rule, given the card's SM count."""
    return _build.function(_PRECISE_SRC, "vt_precise_matmul_split",
                           [_I] * 4)(m, n, k,
                                     _sm_count(_device_index(device)))


class _PreciseMatmul(torch.autograd.Function):
    """Forward K4; backward K4 twice at the same level (``g @ b.T``,
    ``a.T @ g``), each only where a gradient is needed."""

    @staticmethod
    def forward(ctx, a, b, level):
        ctx.save_for_backward(a, b)
        ctx.level = level
        return _precise_launch(a, b, level)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _precise_launch(g, b.t(), ctx.level)
        if ctx.needs_input_grad[1]:
            db = _precise_launch(a.t(), g, ctx.level)
        return da, db, None


def precise_matmul(a, b, level=1):
    """``a @ b`` (f32 [M, K] @ [K, N]) with compensated accumulation
    across K tiles at ``level`` 0 / 1 / 2.  Differentiable; the
    backward runs the same kernel at the same level.  CUDA tensors
    launch K4 (any strides, so transposed views cost no copy); CPU
    tensors run :func:`precise_matmul_reference`."""
    return _PreciseMatmul.apply(a, b, int(level))


#: kernel launches since the last reset, forward and backward (CPU
#: calls do not count): the products, one a call
precise_matmul.launches = 0
#: of those, the calls that split K and launched the fold as well
precise_matmul.fold_launches = 0
