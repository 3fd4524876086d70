"""Dense attention: the single-device oracle of ``veles_tpu/parallel/ring.py``.

Only :func:`attention_reference` is ported: prefill, the cache-free
oracle and the attention unit's ``use_pallas=False`` route run it.  Ring
attention over a sequence-sharded mesh waits for the distributed slice.
"""

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal=False, scale=None, window=None):
    """Plain softmax attention in the [B, T, H, D] layout.  ``window``
    (requires ``causal``): sliding-window attention, position i sees
    keys in (i - window, i]."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1, got %r" % (window,))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        rows = torch.arange(tq, device=s.device)[:, None]
        cols = torch.arange(tk, device=s.device)[None, :]
        mask = cols > rows
        if window is not None:
            mask = mask | (cols <= rows - window)
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
