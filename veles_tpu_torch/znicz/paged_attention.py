"""Ragged paged decode attention: a CUDA kernel and its plain version.

The port of ``veles_tpu/znicz/paged_attention.py``.  At decode time every
sequence contributes ONE query token, and its K/V history lives in
fixed-size blocks scattered across a preallocated pool; the page table
(``[B, max_blocks]`` physical block ids) and the per-sequence lengths
are the only things that change from step to step.

:func:`paged_attention` launches ``csrc/paged_attention.cu`` for CUDA
tensors (kernels K1, f32 pools, and K2, int8 pools with per-(block,
head) f32 scales) and takes :func:`paged_attention_reference` for CPU
tensors.  A CUDA tensor never falls back: the kernel launches or the
call raises.  ``paged_attention.launches`` counts the kernel launches,
``paged_attention.merge_launches`` those of them that split the context
over CTAs and launched the merge too (:func:`paged_attention_plan`).

Padding rows (``length == 0``) return zeros; padding page-table entries
point at physical block 0, which the serving pool reserves as the trash
block.  The prefill and verify entry points add no kernel: they flatten
a chunk or a speculative span into the batch axis with per-query causal
lengths and call :func:`paged_attention`.
"""

import collections
import ctypes
import math

import torch

from .. import _build

__all__ = ["DEFAULT_BLOCK_SIZE", "PagedPlan", "paged_attention",
           "paged_attention_plan", "paged_attention_reference",
           "paged_prefill_attention", "paged_prefill_attention_reference",
           "paged_verify_attention", "paged_verify_attention_reference",
           "required_blocks",
           "quantize_pool", "dequantize_pool"]

#: KV page size (tokens per pool block) the decode scheduler builds
#: pools with when nothing is pinned
DEFAULT_BLOCK_SIZE = 8

_SRC = "paged_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int


def required_blocks(length, block_size):
    """Pool blocks a sequence of ``length`` tokens occupies."""
    return -(-int(length) // int(block_size))


def quantize_pool(pool):
    """Symmetric per-(block, head) int8 quantization of a
    ``[N, block_size, H, D]`` pool.

    Returns ``(q, scales)``: ``q`` int8 with the pool's shape, ``scales``
    f32 ``[N, H]`` with ``scale[i, h] = max|pool[i, :, h]| / 127`` (1.0
    for an all-zero slice).  Rounds half to even (``torch.round``), so
    the bytes equal the JAX package's for the same input.
    """
    if pool.ndim != 4:
        raise ValueError("expected a [N, block_size, H, D] pool, got "
                         "shape %r" % (tuple(pool.shape),))
    f = pool.to(torch.float32)
    amax = f.abs().amax(dim=(1, 3))                  # [N, H]
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(f / scales[:, None, :, None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_pool(q, scales):
    """Inverse of :func:`quantize_pool`: ``int8 * scale`` per
    (block, head)."""
    return q.to(torch.float32) * scales.to(torch.float32)[:, None, :, None]


def _check_quant_args(k_pool, v_pool, k_scales, v_scales):
    """-> True when the pools are quantized (int8 + scales), False for
    the f32 path; raises on half-specified or mismatched operands."""
    quantized = k_pool.dtype == torch.int8
    if quantized != (v_pool.dtype == torch.int8):
        raise ValueError("k_pool/v_pool dtypes differ: %r vs %r"
                         % (k_pool.dtype, v_pool.dtype))
    if not quantized:
        if k_scales is not None or v_scales is not None:
            raise ValueError(
                "k_scales/v_scales are only valid with int8 pools "
                "(got %r pools)" % str(k_pool.dtype))
        return False
    if k_scales is None or v_scales is None:
        raise ValueError("int8 pools require k_scales and v_scales")
    n_pool, heads = k_pool.shape[0], k_pool.shape[2]
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(s.shape) != (n_pool, heads):
            raise ValueError(
                "%s shape %r != (num_blocks, heads) == (%d, %d)"
                % (name, tuple(s.shape), n_pool, heads))
    return True


def _check_shapes(q, k_pool, v_pool, page_table, lengths):
    if q.ndim != 3 or k_pool.ndim != 4:
        raise ValueError("want q [B, H, D] and pools [N, bs, H, D], got "
                         "%r and %r" % (tuple(q.shape),
                                        tuple(k_pool.shape)))
    b, h, d = q.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool shapes differ: %r vs %r"
                         % (tuple(k_pool.shape), tuple(v_pool.shape)))
    if tuple(k_pool.shape[2:]) != (h, d):
        raise ValueError("pool head layout %r does not match q %r"
                         % (tuple(k_pool.shape[2:]), (h, d)))
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError("page_table shape %r does not match batch %d"
                         % (tuple(page_table.shape), b))
    if tuple(lengths.shape) != (b,):
        raise ValueError("lengths shape %r != (%d,)"
                         % (tuple(lengths.shape), b))


def paged_attention(q, k_pool, v_pool, page_table, lengths, scale=None,
                    k_scales=None, v_scales=None):
    """Ragged paged decode attention.

    ``q``: f32 [B, H, D], one query token per sequence;
    ``k_pool``/``v_pool``: [num_blocks, block_size, H, D], f32 or int8;
    ``page_table``: int32 [B, max_blocks], physical block id of each
    sequence's logical block, padded with 0 (the trash block);
    ``lengths``: int32 [B], valid tokens per sequence (0 = padding row,
    returns zeros);
    ``k_scales``/``v_scales``: f32 [num_blocks, H], required iff the
    pools are int8.

    Returns f32 [B, H, D].  CUDA tensors run the kernel with the plan of
    :func:`paged_attention_plan` (every operand contiguous, on one card;
    no host sync); CPU tensors run :func:`paged_attention_reference`.
    """
    _check_shapes(q, k_pool, v_pool, page_table, lengths)
    quantized = _check_quant_args(k_pool, v_pool, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths, scale=scale,
                                         k_scales=k_scales,
                                         v_scales=v_scales)
    b, h, d = q.shape
    _, bs, _, _ = k_pool.shape
    nb = page_table.shape[1]
    operands = [("q", q, torch.float32), ("k_pool", k_pool, None),
                ("v_pool", v_pool, None),
                ("page_table", page_table, torch.int32),
                ("lengths", lengths, torch.int32)]
    if quantized:
        operands += [("k_scales", k_scales, torch.float32),
                     ("v_scales", v_scales, torch.float32)]
    for name, t, dtype in operands:
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s"
                             % (name, t.device, q.device))
        if dtype is not None and t.dtype != dtype:
            raise ValueError("%s must be %s, got %s"
                             % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if not quantized and k_pool.dtype != torch.float32:
        raise ValueError("pools must be float32 or int8, got %s"
                         % k_pool.dtype)
    if b == 0 or h == 0 or d == 0 or nb == 0:
        raise ValueError("empty operand: q %r, page_table %r"
                         % (tuple(q.shape), tuple(page_table.shape)))
    plan = _cached_plan(b, h, d, bs, nb, quantized, q.device)
    return _paged_launch(q, k_pool, v_pool, page_table, lengths, scale,
                         k_scales, v_scales, plan)


def _paged_launch(q, k_pool, v_pool, page_table, lengths, scale, k_scales,
                  v_scales, plan):
    """One K1/K2 call on checked CUDA operands with ``plan`` (a
    :class:`PagedPlan`); a split call launches the merge too."""
    b, h, d = q.shape
    _, bs, _, _ = k_pool.shape
    nb = page_table.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    # split > 1: a partial (acc [D], m, l) a (row, head, split), merged
    # in split order by the kernel's second launch
    ws = (torch.empty(b * h * plan.split * (d + 2), dtype=torch.float32,
                      device=q.device) if plan.split > 1 else None)
    geometry = (b, h, d, bs, nb, *plan, scale)
    with torch.cuda.device(q.device):
        stream = _build.stream_ptr(q.device)
        ws_ptr = ws.data_ptr() if ws is not None else None
        if k_pool.dtype == torch.int8:
            fn = _build.function(_SRC, "vt_paged_attention_int8",
                                 [_P] * 9 + [_I] * 8
                                 + [ctypes.c_float, _P])
            code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      page_table.data_ptr(), lengths.data_ptr(),
                      k_scales.data_ptr(), v_scales.data_ptr(),
                      out.data_ptr(), ws_ptr, *geometry, stream)
        else:
            fn = _build.function(_SRC, "vt_paged_attention_f32",
                                 [_P] * 7 + [_I] * 8
                                 + [ctypes.c_float, _P])
            code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      page_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), ws_ptr, *geometry, stream)
    _build.check(_SRC, code, "paged_attention kernel")
    paged_attention.launches += 1
    if plan.split > 1:
        paged_attention.merge_launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
paged_attention.launches = 0
#: of those, the calls that split the context and launched the merge too
paged_attention.merge_launches = 0


class PagedPlan(collections.namedtuple(
        "PagedPlan", "split blocks_per_split tile")):
    """How K1/K2 cut one call: a CTA a (row, head, split), the context
    split over ``split`` CTAs of ``blocks_per_split`` blocks each, the
    online softmax over tiles of ``tile`` tokens."""


#: bytes of K (and as many of V) one stage of the kernel's ring holds,
#: and the most tokens a stage takes
_TILE_BYTES = 8192
_MAX_TILE = 64
#: the CTAs a call aims at, per SM; a split covers at least
#: _SPLIT_TOKENS tokens of the table and at most _MAX_SPLIT_BLOCKS blocks
#: (their page-table entries and scales sit in shared memory)
_CTAS_PER_SM = 4
_SPLIT_TOKENS = 256
_MAX_SPLIT_BLOCKS = 128


def paged_attention_plan(b, h, d, block_size, max_blocks, sms,
                         quantized=False):
    """The :class:`PagedPlan` of a K1 (``quantized``: K2) call on ``[b,
    h, d]`` queries over a ``[b, max_blocks]`` table of ``block_size``
    token blocks, on a card of ``sms`` SMs.

    A function of those static shapes only, never of ``lengths`` (which
    lives on the card: reading it would sync the host every decode
    step).  The context splits until the grid holds about
    ``_CTAS_PER_SM`` CTAs an SM, while a split keeps at least
    ``_SPLIT_TOKENS`` tokens of the table; so a short table (the serving
    path's 16 blocks of 16) stays one launch.
    """
    elem = 1 if quantized else 4
    tile = max(1, min(_MAX_TILE, _TILE_BYTES // (d * elem)))
    split = -(-_CTAS_PER_SM * sms // (b * h))
    split = min(split, -(-max_blocks * block_size // _SPLIT_TOKENS))
    split = min(max(1, split, -(-max_blocks // _MAX_SPLIT_BLOCKS)),
                max_blocks)
    per_split = -(-max_blocks // split)
    return PagedPlan(-(-max_blocks // per_split), per_split, tile)


_PLANS = {}


def _cached_plan(b, h, d, block_size, max_blocks, quantized, device):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (b, h, d, block_size, max_blocks, quantized, index)
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        plan = _PLANS[key] = paged_attention_plan(
            b, h, d, block_size, max_blocks, sms, quantized=quantized)
    return plan


def _prefill_table_lengths(block_row, start, length, chunk):
    """One sequence's chunk as a ragged "batch": every chunk token
    shares the sequence's block row, and causal masking IS the ragged
    length masking — query at absolute position ``p`` attends to
    ``p + 1`` cached tokens.  Positions past ``length`` are padding
    rows (length 0 -> zeros)."""
    block_row = block_row.to(torch.int32)
    table = block_row[None, :].expand(chunk, block_row.shape[0])
    pos = int(start) + torch.arange(chunk, dtype=torch.int32,
                                    device=block_row.device)
    lens = torch.where(pos < int(length), pos + 1,
                       torch.zeros_like(pos))
    return table.contiguous(), lens


def paged_prefill_attention(q, k_pool, v_pool, block_row, start, length,
                            scale=None, k_scales=None, v_scales=None):
    """Chunked-prefill attention over a partially-resident page table.

    ``q``: [C, H, D], one chunk of prompt queries for ONE sequence at
    absolute positions ``start .. start + C - 1``; ``block_row``: int32
    [max_blocks], the sequence's page-table row; ``start``/``length``:
    chunk origin and total prompt length (positions past ``length`` are
    padding and return zeros).  No new kernel: the chunk runs through
    :func:`paged_attention` with per-query causal lengths."""
    table, lens = _prefill_table_lengths(block_row, start, length,
                                         q.shape[0])
    return paged_attention(q, k_pool, v_pool, table, lens, scale=scale,
                           k_scales=k_scales, v_scales=v_scales)


def paged_prefill_attention_reference(q, k_pool, v_pool, block_row,
                                      start, length, scale=None,
                                      k_scales=None, v_scales=None):
    """Plain version of :func:`paged_prefill_attention`."""
    table, lens = _prefill_table_lengths(block_row, start, length,
                                         q.shape[0])
    return paged_attention_reference(q, k_pool, v_pool, table, lens,
                                     scale=scale, k_scales=k_scales,
                                     v_scales=v_scales)


def _verify_table_lengths(page_table, lengths, span):
    """A speculative verify pass as a ragged "batch": the ``span`` query
    tokens of every sequence share its block row, with per-query causal
    lengths ``length + i + 1``.  Padding rows (``length == 0``) stay
    padding at every span position."""
    b = page_table.shape[0]
    table = page_table.to(torch.int32).repeat_interleave(span, dim=0)
    pos = torch.arange(span, dtype=torch.int32,
                       device=page_table.device)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    lens = torch.where(lengths > 0, lengths + pos + 1,
                       torch.zeros_like(pos))
    return table, lens.reshape(b * span)


def paged_verify_attention(q, k_pool, v_pool, page_table, lengths,
                           scale=None, k_scales=None, v_scales=None):
    """Multi-token (draft-and-verify) ragged paged attention.

    ``q``: [B, S, H, D], ``S`` query tokens per sequence whose K/V are
    already written at positions ``length .. length + S - 1``;
    ``lengths`` counts the cached tokens BEFORE this span.  Returns
    [B, S, H, D].  No new kernel: the span is flattened into the batch
    axis of :func:`paged_attention` with per-query causal lengths."""
    b, s, h, d = q.shape
    table, lens = _verify_table_lengths(page_table, lengths, s)
    o = paged_attention(q.reshape(b * s, h, d).contiguous(), k_pool,
                        v_pool, table, lens, scale=scale,
                        k_scales=k_scales, v_scales=v_scales)
    return o.reshape(b, s, h, d)


def paged_verify_attention_reference(q, k_pool, v_pool, page_table,
                                     lengths, scale=None, k_scales=None,
                                     v_scales=None):
    """Plain version of :func:`paged_verify_attention`."""
    b, s, h, d = q.shape
    table, lens = _verify_table_lengths(page_table, lengths, s)
    o = paged_attention_reference(q.reshape(b * s, h, d), k_pool, v_pool,
                                  table, lens, scale=scale,
                                  k_scales=k_scales, v_scales=v_scales)
    return o.reshape(b, s, h, d)


def paged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                              scale=None, k_scales=None, v_scales=None):
    """Plain PyTorch version of :func:`paged_attention`: gather every
    sequence's blocks into a dense [B, nb, bs, H, D] view, score the
    whole row, dense softmax, weighted sum.

    The reductions are staged like the JAX reference's (per-block
    partial sums of P.V, then a sequential accumulation over the block
    axis), so both references associate the same way.
    """
    b, h, d = q.shape
    _, bs, _, _ = k_pool.shape
    quantized = _check_quant_args(k_pool, v_pool, k_scales, v_scales)
    nb = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    table = page_table.long()
    k = k_pool[table].to(torch.float32)         # [B, nb, bs, H, D]
    v = v_pool[table].to(torch.float32)
    if quantized:
        # the same ``int8 -> f32 * scale`` product the kernel computes
        k = k * k_scales.to(torch.float32)[table][:, :, None, :, None]
        v = v * v_scales.to(torch.float32)[table][:, :, None, :, None]
    qf = q.to(torch.float32) * scale
    s = (k * qf[:, None, None]).sum(dim=-1)     # [B, nb, bs, H]
    s = s.permute(0, 3, 1, 2)                   # [B, H, nb, bs]
    pos = (torch.arange(nb, device=q.device)[:, None] * bs
           + torch.arange(bs, device=q.device)[None, :])
    valid = pos[None, None] < lengths.to(q.device)[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=(2, 3), keepdim=True)
    safe_m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(torch.isneginf(s), torch.zeros_like(s),
                    torch.exp(s - safe_m))
    l = p.sum(dim=(2, 3))
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    vm = v.permute(0, 3, 1, 2, 4)               # [B, H, nb, bs, D]
    pv = (p[..., None] * vm).sum(dim=3)         # [B, H, nb, D]
    o = pv[:, :, 0]
    for j in range(1, nb):                      # block-sequential
        o = o + pv[:, :, j]
    return (o / safe_l[..., None]).to(q.dtype)
