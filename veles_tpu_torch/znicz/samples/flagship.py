"""The flagship MoE transformer's decode face: decode over a paged cache.

The port of the serving half of ``veles_tpu/znicz/samples/flagship.py``
(:263-751).  A tied token embedding turns the [B, T, D] -> [B, T, D]
block stack into a generate-style language model, and the per-layer K/V
of every served sequence lives in the serving pool's fixed-size blocks
(:mod:`..paged_attention`):

- :func:`prefill` runs the prompt through the dense causal forward once
  while writing its K/V into the sequence's pool blocks;
- :func:`decode_step` is the single-token iteration the token-level
  scheduler (``serving/decode.py``) runs every step: [max_batch] token
  rows plus the page-table operand, any mix of per-sequence lengths;
- :func:`verify_step` and :func:`prefill_chunk` are the speculative and
  chunked entries of the same ragged kernel.

Each block is causal multi-head attention plus an RMS norm plus a
switch-MoE feed-forward.  MoE routing at decode uses the oracle path
with a no-drop capacity, so a token's output never depends on the other
rows of its batch.  With ``weight_dtype`` int8 or fp8 the expert GEMMs
run :func:`..gemm.quantized_matmul`; with ``kv_dtype="int8"`` the pools
hold int8 plus per-(block, head) scales.

Where JAX donated the pools and got new ones back, the port updates them
IN PLACE (``index_put_``) and returns the same tensors, so the calling
convention — ``(token, k_pools, v_pools)`` — is unchanged.  Parameters
are a dict of tensors in JAX's ``x @ W`` layout, initialized from a
``numpy.random.RandomState`` exactly as the JAX package does, so both
packages hold identical weights for the same seed.  The training face
(``flagship_apply``, ``train_step``, the mesh) is still to be ported.
"""

import math

import numpy
import torch

from ...device import resolve_device
from ...parallel.moe import moe_reference
from ...parallel.ring import attention_reference
from ..gemm import _quantize, quantized_matmul
from ..paged_attention import (kv_append_int8, paged_attention,
                               paged_prefill_attention,
                               paged_verify_attention)

__all__ = ["init_params", "init_decode_params", "prefill",
           "prefill_chunk", "decode_step", "verify_step",
           "generate_reference", "FlagshipDecodeModel"]


def init_params(stages, experts, d=16, heads=2, hidden=32, seed=0,
                device=None):
    """One stacked param dict: leading dim S (stages), expert leaves
    [S, E, ...]; numpy-seeded, identical to the JAX package's."""
    dev = resolve_device(device)
    rng = numpy.random.RandomState(seed)

    def w(*shape, scale=0.25):
        arr = (rng.standard_normal(shape) * scale).astype(numpy.float32)
        return torch.from_numpy(arr).to(dev)

    return {
        "qkv": w(stages, d, 3 * d),
        "proj": w(stages, d, d),
        "wr": w(stages, d, experts),
        "w1": w(stages, experts, d, hidden),
        "w2": w(stages, experts, hidden, d),
    }


def init_decode_params(stages, experts, d=16, heads=2, hidden=32,
                       vocab=64, seed=0, device=None):
    """:func:`init_params` plus a tied token embedding ``emb``
    [vocab, d] (logits = h @ emb.T)."""
    params = init_params(stages, experts, d=d, heads=heads,
                         hidden=hidden, seed=seed, device=device)
    rng = numpy.random.RandomState(seed + 1)
    emb = (rng.standard_normal((vocab, d)) * 0.25).astype(numpy.float32)
    params["emb"] = torch.from_numpy(emb).to(params["qkv"].device)
    return params


def _rmsnorm(h):
    return h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6)


def _expert_ffn(p, h):
    return torch.relu(h @ p["w1"]) @ p["w2"]


def _expert_ffn_quant(p, h):
    """The expert FFN over quantized weight leaves: both GEMMs stream
    int8/fp8 weight bytes and fold the per-output-channel scales after
    the K loop (:func:`..gemm.quantized_matmul`)."""
    a = torch.relu(quantized_matmul(h, p["w1_q"], p["w1_s"]))
    return quantized_matmul(a, p["w2_q"], p["w2_s"])


def _quantize_weight_stack(w, dtype):
    """Per-output-channel quantization of a stacked ``[..., K, N]``
    weight (stages x experts leading dims)."""
    return _quantize(w, dtype, dim=-2)


def _stacked(params):
    """The per-stage leaves (everything but the shared embedding).
    Quantized expert leaves (``w1_q`` ...), when present, replace the
    f32 ``w1``/``w2`` leaves on every decode path."""
    names = ("qkv", "proj", "wr")
    if "w1_q" in params:
        names += ("w1_q", "w1_s", "w2_q", "w2_s")
    else:
        names += ("w1", "w2")
    return {n: params[n] for n in names}


def _stage(stacked, i):
    return {n: p[i] for n, p in stacked.items()}


def _moe_dense(p_i, h, k):
    """No-drop oracle MoE for ``h`` [N, d]: capacity covers every
    (token, choice) pair, so routing is per-token independent."""
    if "w1_q" in p_i:
        return moe_reference(
            _expert_ffn_quant,
            {n: p_i[n] for n in ("w1_q", "w1_s", "w2_q", "w2_s")},
            p_i["wr"], h, capacity=h.shape[0] * k, k=k)
    return moe_reference(_expert_ffn, {"w1": p_i["w1"], "w2": p_i["w2"]},
                         p_i["wr"], h, capacity=h.shape[0] * k, k=k)


def _split_qkv(qkv, d, shape):
    """q, k, v of a fused projection, each reshaped to ``shape`` and
    contiguous (the kernels take contiguous operands only)."""
    return tuple(qkv[..., i * d:(i + 1) * d].reshape(shape).contiguous()
                 for i in range(3))


# -- KV pools -----------------------------------------------------------------
#
# kv_dtype="int8" swaps each f32 pool tensor for {"q": int8 pool, "s":
# f32 per-(block, head) scales} and every pool write for a sequential
# quantized append: position off == 0 resets the block's scale (so a
# block's bytes depend only on the tokens written into it, never on a
# previous tenant), later positions grow the scale monotonically and
# rescale the block's earlier rows when it grows.  With an unchanged
# scale the rescale is exact (round(q * 1) == q).


def _make_kv_pool(shape, kv_dtype, device):
    """One per-layer pool: an f32 tensor, or {"q", "s"} for int8 (``s``
    is the [num_blocks, heads] scale tensor the kernel reads)."""
    if kv_dtype == "int8":
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros((shape[0], shape[2]),
                                 dtype=torch.float32, device=device)}
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _kv_arrays(pool):
    """(data, scales-or-None) view of a pool of either dtype."""
    if isinstance(pool, dict):
        return pool["q"], pool["s"]
    return pool, None


def _append_kv(pool, blk, off, vals, kv_dtype):
    """Write ``vals`` at (blk, off) IN PLACE and return the pool.

    f32: one ``index_put_``.  int8: the sequential per-position
    quantized append, one :func:`..paged_attention.kv_append_int8` call
    (one kernel launch on the card).  ``blk``/``off`` are [N] (one row)
    or [B, S] (B rows), flattened row-major so the positions of a row
    stay in causal order."""
    if kv_dtype != "int8":
        pool.index_put_((blk.long(), off.long()), vals.to(pool.dtype))
        return pool
    kv_append_int8(pool["q"], pool["s"], blk, off, vals)
    return pool


def _prefill_block(p_i, h, heads, k):
    """One dense causal block over the whole prompt; returns the block
    output and this layer's K/V ([T, H, hd]) for the cache."""
    b, t, d = h.shape
    qkv = _rmsnorm(h) @ p_i["qkv"]
    q, kk, vv = _split_qkv(qkv, d, (b, t, heads, d // heads))
    a = attention_reference(q, kk, vv, causal=True)
    h = h + a.reshape(b, t, d) @ p_i["proj"]
    moe = _moe_dense(p_i, _rmsnorm(h).reshape(b * t, d), k)
    return h + moe.reshape(b, t, d), kk[0], vv[0]


def prefill(params, tokens, length, k_pools, v_pools, block_row, *,
            heads=2, block_size=8, k=1, kv_dtype="f32"):
    """Prompt pass: dense causal forward over ``tokens`` [T_bucket]
    (padded; ``length`` valid), writing each layer's K/V for positions
    < length into the pool blocks named by ``block_row`` [max_blocks].
    Returns (first generated token, k_pools, v_pools); the pools are
    updated in place."""
    t = int(tokens.shape[0])
    length = int(length)
    h = params["emb"][tokens.long()][None]       # [1, T, d]
    stacked = _stacked(params)
    stages = stacked["qkv"].shape[0]
    pos = torch.arange(t, device=h.device)
    nb = block_row.shape[0]
    # invalid positions scatter into physical block 0, the pool's
    # reserved trash block, never owned by a live sequence
    blk = torch.where(pos < length,
                      block_row[(pos // block_size).clamp(max=nb - 1)]
                      .long(), torch.zeros_like(pos))
    off = pos % block_size
    k_pools, v_pools = list(k_pools), list(v_pools)
    for i in range(stages):
        h, kk, vv = _prefill_block(_stage(stacked, i), h, heads, k)
        k_pools[i] = _append_kv(k_pools[i], blk, off, kk, kv_dtype)
        v_pools[i] = _append_kv(v_pools[i], blk, off, vv, kv_dtype)
    logits = h[0, length - 1] @ params["emb"].T
    return logits.argmax().to(torch.int32), tuple(k_pools), tuple(v_pools)


def prefill_chunk(params, tokens, start, length, k_pools, v_pools,
                  block_row, *, heads=2, block_size=8, k=1,
                  kv_dtype="f32"):
    """One fixed-size prefill chunk: positions ``start .. start+C-1`` of
    a prompt whose earlier K/V are read back THROUGH the page-table row.
    Per layer: write this chunk's K/V into its pool slots, then ragged
    paged attention with per-query causal lengths.  Returns (token,
    pools); the token is meaningful only on the final chunk."""
    c = int(tokens.shape[0])
    start, length = int(start), int(length)
    h = params["emb"][tokens.long()][None]       # [1, C, d]
    stacked = _stacked(params)
    stages = stacked["qkv"].shape[0]
    d = h.shape[-1]
    hd = d // heads
    nb = block_row.shape[0]
    pos = start + torch.arange(c, device=h.device)
    blk = torch.where(pos < length,
                      block_row[(pos // block_size).clamp(max=nb - 1)]
                      .long(), torch.zeros_like(pos))
    off = pos % block_size
    k_pools, v_pools = list(k_pools), list(v_pools)
    for i in range(stages):
        p_i = _stage(stacked, i)
        qkv = _rmsnorm(h) @ p_i["qkv"]           # [1, C, 3d]
        q, kk, vv = _split_qkv(qkv, d, (c, heads, hd))
        k_pools[i] = _append_kv(k_pools[i], blk, off, kk, kv_dtype)
        v_pools[i] = _append_kv(v_pools[i], blk, off, vv, kv_dtype)
        kd, ks = _kv_arrays(k_pools[i])
        vd, vs = _kv_arrays(v_pools[i])
        a = paged_prefill_attention(q, kd, vd, block_row, start, length,
                                    scale=1.0 / math.sqrt(hd),
                                    k_scales=ks, v_scales=vs)
        h = h + a.reshape(1, c, d) @ p_i["proj"]
        h = h + _moe_dense(p_i, _rmsnorm(h).reshape(c, d),
                           k).reshape(1, c, d)
    last = min(max(length - 1 - start, 0), c - 1)
    logits = h[0, last] @ params["emb"].T
    return logits.argmax().to(torch.int32), tuple(k_pools), tuple(v_pools)


def _decode_block(p_i, h, k_pool_i, v_pool_i, page_table, lengths, blk,
                  off, heads, k, kv_dtype="f32"):
    """One single-token block: write this token's K/V into its pool
    slot, then ragged paged attention over the whole cached history
    (lengths + 1 includes the token just written)."""
    b, d = h.shape
    hd = d // heads
    qkv = _rmsnorm(h) @ p_i["qkv"]               # [B, 3d]
    q, kk, vv = _split_qkv(qkv, d, (b, heads, hd))
    # one position per row: [B, 1]
    k_pool_i = _append_kv(k_pool_i, blk[:, None], off[:, None],
                          kk[:, None], kv_dtype)
    v_pool_i = _append_kv(v_pool_i, blk[:, None], off[:, None],
                          vv[:, None], kv_dtype)
    kd, ks = _kv_arrays(k_pool_i)
    vd, vs = _kv_arrays(v_pool_i)
    a = paged_attention(q, kd, vd, page_table, lengths + 1,
                        scale=1.0 / math.sqrt(hd), k_scales=ks,
                        v_scales=vs)
    h = h + a.reshape(b, d) @ p_i["proj"]
    return h + _moe_dense(p_i, _rmsnorm(h), k), k_pool_i, v_pool_i


def decode_step(params, k_pools, v_pools, page_table, lengths, tokens, *,
                heads=2, block_size=8, k=1, kv_dtype="f32",
                with_logits=False):
    """One token for every row: embed ``tokens`` [B], write each row's
    K/V at position ``lengths[row]``, attend through the page table
    (int32 [B, max_blocks]), return (next greedy tokens [B], k_pools,
    v_pools) — the pools updated in place.  Padding rows (lengths == 0
    with an all-zero table row) write into the trash block and produce
    ignored tokens."""
    b = int(tokens.shape[0])
    h = params["emb"][tokens.long()]             # [B, d]
    stacked = _stacked(params)
    stages = stacked["qkv"].shape[0]
    rows = torch.arange(b, device=h.device)
    blk = page_table[rows, (lengths // block_size).long()]
    off = lengths % block_size
    k_pools, v_pools = list(k_pools), list(v_pools)
    for i in range(stages):
        h, k_pools[i], v_pools[i] = _decode_block(
            _stage(stacked, i), h, k_pools[i], v_pools[i], page_table,
            lengths, blk, off, heads, k, kv_dtype=kv_dtype)
    logits = h @ params["emb"].T                 # [B, V]
    out = logits.argmax(dim=-1).to(torch.int32)
    if with_logits:
        return out, tuple(k_pools), tuple(v_pools), logits
    return out, tuple(k_pools), tuple(v_pools)


def _verify_block(p_i, h, k_pool_i, v_pool_i, page_table, lengths, blk,
                  off, heads, k, kv_dtype="f32"):
    """One multi-token block of the speculative verify pass: write all S
    fed tokens' K/V, then ragged verify attention (per-position causal
    lengths keep query ``i`` blind to the drafts after it)."""
    b, s, d = h.shape
    hd = d // heads
    qkv = _rmsnorm(h) @ p_i["qkv"]               # [B, S, 3d]
    q, kk, vv = _split_qkv(qkv, d, (b, s, heads, hd))
    k_pool_i = _append_kv(k_pool_i, blk, off, kk, kv_dtype)
    v_pool_i = _append_kv(v_pool_i, blk, off, vv, kv_dtype)
    kd, ks = _kv_arrays(k_pool_i)
    vd, vs = _kv_arrays(v_pool_i)
    a = paged_verify_attention(q, kd, vd, page_table, lengths,
                               scale=1.0 / math.sqrt(hd), k_scales=ks,
                               v_scales=vs)
    h = h + a.reshape(b, s, d) @ p_i["proj"]
    moe = _moe_dense(p_i, _rmsnorm(h).reshape(b * s, d), k)
    return h + moe.reshape(b, s, d), k_pool_i, v_pool_i


def verify_step(params, k_pools, v_pools, page_table, lengths, tokens, *,
                heads=2, block_size=8, k=1, kv_dtype="f32"):
    """Speculative verify: ``tokens`` [B, S] is each row's next input
    plus its S-1 draft tokens.  Every position is written at
    ``lengths[row] + i`` and attended with causal length
    ``lengths[row] + i + 1``, so ``out[:, i]`` is the greedy next token
    given the history plus fed tokens ``0 .. i``.  Writes past a row's
    page-table capacity scatter into the trash block."""
    b, s = int(tokens.shape[0]), int(tokens.shape[1])
    h = params["emb"][tokens.long()]             # [B, S, d]
    stacked = _stacked(params)
    stages = stacked["qkv"].shape[0]
    nb = page_table.shape[1]
    rows = torch.arange(b, device=h.device)[:, None]
    pos = lengths.long()[:, None] + torch.arange(s, device=h.device)[None]
    blk = torch.where(pos < nb * block_size,
                      page_table[rows, (pos // block_size).clamp(
                          max=nb - 1)].long(), torch.zeros_like(pos))
    off = pos % block_size
    k_pools, v_pools = list(k_pools), list(v_pools)
    for i in range(stages):
        h, k_pools[i], v_pools[i] = _verify_block(
            _stage(stacked, i), h, k_pools[i], v_pools[i], page_table,
            lengths, blk, off, heads, k, kv_dtype=kv_dtype)
    logits = h @ params["emb"].T                 # [B, S, V]
    return (logits.argmax(dim=-1).to(torch.int32), tuple(k_pools),
            tuple(v_pools))


def generate_reference(params, prompt, n_new, heads=2, k=1):
    """Cache-free greedy oracle: rerun the full dense causal forward over
    the whole history for every generated token, on the params' device.
    O(T^2) per token — tests only."""
    tokens = [int(t) for t in prompt]
    stacked = _stacked(params)
    stages = stacked["qkv"].shape[0]
    dev = params["emb"].device
    out = []
    for _ in range(n_new):
        h = params["emb"][torch.tensor(tokens, device=dev)][None]
        for i in range(stages):
            h, _, _ = _prefill_block(_stage(stacked, i), h, heads, k)
        nxt = int((h[0, -1] @ params["emb"].T).argmax())
        out.append(nxt)
        tokens.append(nxt)
    return out


def _index(x, device):
    """An int32 operand from the scheduler's numpy mirrors (or a
    tensor), copied onto ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.tensor(numpy.asarray(x, numpy.int32), device=device)


class FlagshipDecodeModel:
    """The decode-serving adapter: flagship params plus the prefill /
    decode-step closures the token-level scheduler (serving/decode.py)
    runs.  ``kind = "decode"`` is what ModelRegistry.add dispatches on.

    ``device=None`` runs on the card (and raises without one);
    ``device="cpu"`` runs the kernels' plain versions on the host.
    ``params`` (a dict of tensors or arrays, e.g. from
    :func:`veles_tpu_torch.convert.params_from_jax`) overrides the
    seeded init."""

    kind = "decode"
    #: KV-cache precisions this model's factories accept
    kv_dtypes = ("f32", "int8")

    def __init__(self, params=None, *, stages=2, experts=2, d=16,
                 heads=2, hidden=32, vocab=64, k=1, seed=0,
                 kv_dtype="f32", weight_dtype="f32", device=None):
        self.device = resolve_device(device)
        if params is None:
            params = init_decode_params(stages, experts, d=d, heads=heads,
                                        hidden=hidden, vocab=vocab,
                                        seed=seed, device=self.device)
        else:
            params = {n: torch.as_tensor(p).to(self.device)
                      for n, p in params.items()}
        if kv_dtype not in self.kv_dtypes:
            raise ValueError("kv_dtype=%r not in %r"
                             % (kv_dtype, self.kv_dtypes))
        if weight_dtype != "f32":
            for name in ("w1", "w2"):
                q, s = _quantize_weight_stack(params[name], weight_dtype)
                params[name + "_q"], params[name + "_s"] = q, s
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.params = params
        self.heads = int(heads)
        self.k = int(k)
        self.layers = int(params["qkv"].shape[0])
        self.vocab = int(params["emb"].shape[0])
        self.d = int(params["emb"].shape[1])
        if self.d % self.heads:
            raise ValueError("d=%d not divisible by heads=%d"
                             % (self.d, self.heads))
        self.head_dim = self.d // self.heads
        self._draft_table = None

    def _kv(self, kv_dtype):
        return self.kv_dtype if kv_dtype is None else kv_dtype

    def make_pools(self, num_blocks, block_size, kv_dtype=None):
        """Fresh zeroed per-layer K and V pools
        ([num_blocks, block_size, H, hd] x layers) on the model's
        device; int8 pools are {"q", "s"} per layer."""
        dt = self._kv(kv_dtype)
        shape = (int(num_blocks), int(block_size), self.heads,
                 self.head_dim)
        k_pools = tuple(_make_kv_pool(shape, dt, self.device)
                        for _ in range(self.layers))
        v_pools = tuple(_make_kv_pool(shape, dt, self.device)
                        for _ in range(self.layers))
        return k_pools, v_pools

    def prefill_fn(self, block_size, kv_dtype=None):
        """(tokens, length, k_pools, v_pools, block_row) ->
        (first token, pools), closed over the static geometry."""
        params, heads, k, dev = self.params, self.heads, self.k, self.device
        dt = self._kv(kv_dtype)

        def fn(tokens, length, k_pools, v_pools, block_row):
            return prefill(params, _index(tokens, dev), int(length),
                           k_pools, v_pools, _index(block_row, dev),
                           heads=heads, block_size=block_size, k=k,
                           kv_dtype=dt)
        return fn

    def prefill_chunk_fn(self, block_size, kv_dtype=None):
        """(tokens[C], start, length, k_pools, v_pools, block_row) ->
        (token, pools): the fixed-size chunked-prefill step."""
        params, heads, k, dev = self.params, self.heads, self.k, self.device
        dt = self._kv(kv_dtype)

        def fn(tokens, start, length, k_pools, v_pools, block_row):
            return prefill_chunk(params, _index(tokens, dev), int(start),
                                 int(length), k_pools, v_pools,
                                 _index(block_row, dev), heads=heads,
                                 block_size=block_size, k=k, kv_dtype=dt)
        return fn

    def decode_fn(self, block_size, kv_dtype=None, with_logits=False):
        """(k_pools, v_pools, page_table, lengths, tokens) ->
        (next tokens, pools), and the [B, V] logits last with
        ``with_logits``."""
        params, heads, k, dev = self.params, self.heads, self.k, self.device
        dt = self._kv(kv_dtype)

        def fn(k_pools, v_pools, page_table, lengths, tokens):
            return decode_step(params, k_pools, v_pools,
                               _index(page_table, dev),
                               _index(lengths, dev), _index(tokens, dev),
                               heads=heads, block_size=block_size, k=k,
                               kv_dtype=dt, with_logits=with_logits)
        return fn

    def logits_fn(self, block_size, kv_dtype=None):
        """Like :meth:`decode_fn` but also returns the [B, V] logits: the
        hook for measuring quantization error against the f32 oracle."""
        return self.decode_fn(block_size, kv_dtype, with_logits=True)

    def _unigram_table(self):
        """The drafter: a [vocab] next-token table distilled from the
        target by running it on every single-token prompt.  Computed
        once, on first use."""
        if self._draft_table is None:
            h = self.params["emb"][:, None]
            stacked = _stacked(self.params)
            for i in range(self.layers):
                h, _, _ = _prefill_block(_stage(stacked, i), h, self.heads,
                                         self.k)
            logits = h[:, 0] @ self.params["emb"].T
            self._draft_table = logits.argmax(dim=-1).to(torch.int32)
        return self._draft_table

    def draft_fn(self, block_size, depth, kv_dtype=None):
        """(k_pools, v_pools, page_table, lengths, tokens[B]) -> draft
        tokens [B, depth].  Pure reads: drafting never writes the
        pools."""
        table = self._unigram_table()
        depth, dev = int(depth), self.device

        def fn(k_pools, v_pools, page_table, lengths, tokens):
            t = _index(tokens, dev).long()
            outs = []
            for _ in range(depth):
                t = table[t].long()
                outs.append(t)
            return torch.stack(outs, dim=1).to(torch.int32)
        return fn

    def verify_fn(self, block_size, depth, kv_dtype=None):
        """(k_pools, v_pools, page_table, lengths, tokens[B, depth+1])
        -> (out tokens [B, depth+1], pools): the one-pass multi-token
        verify."""
        params, heads, k, dev = self.params, self.heads, self.k, self.device
        dt = self._kv(kv_dtype)

        def fn(k_pools, v_pools, page_table, lengths, tokens):
            return verify_step(params, k_pools, v_pools,
                               _index(page_table, dev),
                               _index(lengths, dev), _index(tokens, dev),
                               heads=heads, block_size=block_size, k=k,
                               kv_dtype=dt)
        return fn
