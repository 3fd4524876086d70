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
The split is the ``paged_attention`` autotune site (:func:`plan_for_split`):
the plan's rule, or a measured count of CTAs a row; with the tuner off
it is the rule, as without a tuner.

Padding rows (``length == 0``) return zeros; padding page-table entries
point at physical block 0, which the serving pool reserves as the trash
block.  The prefill and verify entry points add no kernel: they flatten
a chunk or a speculative span into the batch axis with per-query causal
lengths and call :func:`paged_attention`.

:func:`kv_append_int8` writes K or V into an int8 pool: the sequential
quantized append of the serving path, one launch of
``csrc/kv_append.cu`` a call on the card (``kv_append_int8.launches``),
its plain version :func:`kv_append_int8_reference` for CPU tensors.
"""

import collections
import ctypes
import math

import torch

from .. import _build

__all__ = ["DEFAULT_BLOCK_SIZE", "PagedPlan", "paged_attention",
           "paged_attention_plan", "plan_for_split",
           "paged_attention_reference",
           "paged_prefill_attention", "paged_prefill_attention_reference",
           "paged_verify_attention", "paged_verify_attention_reference",
           "required_blocks", "quantize_pool", "dequantize_pool",
           "kv_append_int8", "kv_append_int8_reference"]

#: KV page size (tokens per pool block) the decode scheduler builds
#: pools with when nothing is pinned
DEFAULT_BLOCK_SIZE = 8

_SRC = "paged_attention"
_APPEND_SRC = "kv_append"
_P, _I = ctypes.c_void_p, ctypes.c_int

#: the reserved trash block of a serving pool (``KVBlockPool.TRASH``):
#: padding positions write there and nothing reads it
_TRASH = 0


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


def kv_append_int8_reference(q, s, blk, off, vals):
    """Plain version of :func:`kv_append_int8`: vectorized passes.

    A block's bytes depend on the order of its writes, so each position
    gets its rank among the writes to its block, on the device, and one
    pass runs per rank: within a pass every block is written at most
    once, so the passes give the bytes of the position-by-position loop.
    Each row of a [B, S] call is its own sequence and owns its blocks,
    so a block sees at most min(S, block_size) writes and that many
    passes run: one for a decode step ([B, 1]), at most block_size for
    a prefill.  What the passes write to the trash block is left
    unspecified.  ``/ 127`` divides by a tensor on the pool's device, so
    it is an IEEE divide on the card too (a Python scalar divisor makes
    PyTorch's CUDA division multiply by its reciprocal)."""
    passes = min(blk.shape[-1] if blk.ndim else 1, q.shape[1])
    blk = blk.reshape(-1).long()
    off = off.reshape(-1).long()
    n = blk.shape[0]
    vals = vals.to(torch.float32).reshape((n,) + q.shape[2:])
    amax = vals.abs().amax(dim=-1) / torch.full((), 127.0,
                                                device=vals.device)
    reopen = (off == 0)[:, None]
    pos = torch.arange(n, device=blk.device)
    dest = blk
    if passes > 1:
        # rank[t]: the writes to blk[t] before position t
        earlier = torch.ones((n, n), dtype=torch.bool,
                             device=blk.device).tril(-1)
        rank = ((blk[:, None] == blk[None, :]) & earlier).sum(dim=1)
    for r in range(passes):
        s_old = torch.where(reopen, 0.0, s[blk])
        s_new = torch.maximum(s_old, amax)
        s_safe = torch.where(s_new > 0, s_new, 1.0)
        # ratio == 0 wipes a freshly opened block; ratio == 1 keeps the
        # existing rows bit-exact when the scale did not grow
        ratio = torch.where(s_old > 0, s_old / s_safe, 0.0)
        block = (q[blk].to(torch.float32) * ratio[:, None, :, None]
                 ).round_().clamp_(-127, 127)
        block[pos, off] = (vals / s_safe[:, :, None]).round_().clamp_(
            -127, 127)
        if passes > 1:
            # the positions of other passes write the trash block
            dest = torch.where(rank == r, blk, _TRASH)
        q.index_put_((dest,), block.to(torch.int8))
        s.index_put_((dest,), s_new)


def kv_append_int8(q, s, blk, off, vals):
    """Write ``vals`` into an int8 KV pool, IN PLACE, as the sequential
    quantized append.

    ``q``: int8 [num_blocks, block_size, H, D]; ``s``: f32 [num_blocks,
    H] per-(block, head) scales; ``blk``/``off``: the block and row of
    each write, [N] (one sequence) or [B, S] (B sequences), flattened
    row-major so each sequence's positions stay in causal order; ``vals``
    f32 [..., H, D], one [H, D] row a write.  For each write, in order:
    offset 0 reopens the block (its old scale counts as 0), the scale
    grows to ``max(old, max|v| / 127)``, the block's rows are rescaled
    by ``old / new`` and the row is written as ``round(v / scale)``, all
    clamped to +-127.  So a block's bytes depend only on the tokens
    written into it since it was reopened, and writing a span in one
    call or in consecutive calls gives the same bytes.

    Each sequence owns its blocks and its valid positions are a prefix
    of its span, so the writes to one block are a contiguous run (the
    kernel relies on that); writes to the trash block 0 are
    unspecified.  CUDA tensors launch ``csrc/kv_append.cu`` once (no
    host sync); CPU tensors run :func:`kv_append_int8_reference`."""
    if q.device.type == "cpu":
        return kv_append_int8_reference(q, s, blk, off, vals)
    if q.ndim != 4 or q.dtype != torch.int8:
        raise ValueError("q must be an int8 [num_blocks, block_size, H, D] "
                         "pool, got %s %r" % (q.dtype, tuple(q.shape)))
    nblocks, bs, h, d = q.shape
    if s.dtype != torch.float32 or tuple(s.shape) != (nblocks, h):
        raise ValueError("s must be f32 [num_blocks, H] == (%d, %d), got "
                         "%s %r" % (nblocks, h, s.dtype, tuple(s.shape)))
    if blk.shape != off.shape:
        raise ValueError("blk %r and off %r differ in shape"
                         % (tuple(blk.shape), tuple(off.shape)))
    if blk.dtype not in (torch.int32, torch.int64):
        raise ValueError("blk must be int32 or int64, got %s" % blk.dtype)
    n = blk.numel()
    if vals.numel() != n * h * d:
        raise ValueError("vals %r is not %d rows of [%d, %d]"
                         % (tuple(vals.shape), n, h, d))
    for name, t in (("s", s), ("blk", blk), ("off", off), ("vals", vals)):
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s"
                             % (name, t.device, q.device))
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")
    if n == 0:
        return
    blk = blk.reshape(-1).contiguous()
    off = off.reshape(-1).to(blk.dtype).contiguous()
    vals = vals.to(torch.float32).reshape(n, h, d).contiguous()
    symbol = ("vt_kv_append_int8_i32" if blk.dtype == torch.int32
              else "vt_kv_append_int8_i64")
    with torch.cuda.device(q.device):
        fn = _build.function(_APPEND_SRC, symbol, [_P] * 5 + [_I] * 4
                             + [_P])
        code = fn(q.data_ptr(), s.data_ptr(), blk.data_ptr(),
                  off.data_ptr(), vals.data_ptr(), n, bs, h, d,
                  _build.stream_ptr(q.device))
    _build.check(_APPEND_SRC, code, "kv_append_int8 kernel")
    kv_append_int8.launches += 1


#: kernel launches since the last reset (CPU calls do not count)
kv_append_int8.launches = 0
_build.counted(kv_append_int8)


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
_build.counted(paged_attention, "launches", "merge_launches")


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


def plan_for_split(split, b, h, d, block_size, max_blocks, sms,
                   quantized=False):
    """The :class:`PagedPlan` of a ``paged_attention`` autotune choice:
    ``"rule"`` is :func:`paged_attention_plan`; an int splits the
    context over that many CTAs (at most one a block), with the rule's
    tile.  A split whose blocks overflow a CTA's share raises."""
    rule = paged_attention_plan(b, h, d, block_size, max_blocks, sms,
                                quantized=quantized)
    if split == "rule":
        return rule
    per_split = -(-max_blocks // min(int(split), max_blocks))
    if per_split > _MAX_SPLIT_BLOCKS:
        raise ValueError(
            "a split of %r over %d blocks gives %d blocks a CTA, past the "
            "kernel's %d" % (split, max_blocks, per_split,
                             _MAX_SPLIT_BLOCKS))
    return PagedPlan(-(-max_blocks // per_split), per_split, rule.tile)


_PLANS = {}


def _cached_plan(b, h, d, block_size, max_blocks, quantized, device):
    """The plan of a K1/K2 call, resolved through the ``paged_attention``
    autotune site (tuner off: :func:`paged_attention_plan`), memoized
    per shape and tuning directory."""
    from ..autotune import dispatch, space
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (b, h, d, block_size, max_blocks, quantized, index,
           dispatch.resolve_config())
    plan = _PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        ctx = {"batch": b, "heads": h, "d": d, "block_size": block_size,
               "max_blocks": max_blocks, "quantized": quantized}
        sp = space.site("paged_attention")
        cfg, _ = dispatch.resolve("paged_attention", sp.shape_class(ctx),
                                  default=sp.default_for(ctx))
        plan = _PLANS[key] = plan_for_split(
            cfg["split"], b, h, d, block_size, max_blocks, sms,
            quantized=quantized)
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
