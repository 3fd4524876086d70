"""Dense attention: the single-device oracle of ``veles_tpu/parallel/ring.py``.

Only :func:`attention_reference` is ported: prefill and the cache-free
oracle run it.  Ring attention over a sequence-sharded mesh, and the
sliding-window band of the reference, wait for the distributed slice.
"""

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain softmax attention in the [B, T, H, D] layout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(tk, device=s.device)[None, :]
                > torch.arange(tq, device=s.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
