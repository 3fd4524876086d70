"""Mixture of experts on one device (``veles_tpu/parallel/moe.py``).

A linear router with a softmax gate picks the top-k experts of every
token; tokens past an expert's capacity are dropped, first choices
before second choices (the GShard priority).  The JAX ``lax.scan`` over
experts is a Python loop here.  The sharded dispatch (``psum`` and
``all_to_all`` over the expert axis) waits for the distributed slice.
"""

import torch

__all__ = ["router_probs", "moe_reference"]


def router_probs(wr, x):
    """[B, E] softmax router probabilities."""
    return torch.softmax(x @ wr, dim=-1)


def _topk_routing(probs, k):
    """(dsts[B, k], gates[B, k]): top-k experts per token, gates
    renormalized over the chosen k (for k=1 the gate is the raw top
    probability).  k=1 uses argmax, which takes the first index on
    ties, as ``lax.top_k`` does."""
    if k == 1:
        top = probs.argmax(dim=-1, keepdim=True)
        return top, probs.gather(-1, top)
    topv, topi = torch.topk(probs, k, dim=-1)
    return topi, topv / topv.sum(dim=-1, keepdim=True)


def _choice_major_slots(dsts, n_experts):
    """Capacity queue positions, choice-major: ALL first choices (in
    batch order) fill an expert's slots before any second choice.
    ``dsts`` is [B, k]; returns pos[B, k], the token's slot in its
    expert's queue."""
    b, k = dsts.shape
    flat = dsts.transpose(0, 1).reshape(-1)          # choice-major
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    pos_flat = onehot.cumsum(dim=0) - 1
    pos_flat = pos_flat.gather(1, flat[:, None])[:, 0]
    return pos_flat.reshape(k, b).transpose(0, 1)


def moe_reference(expert_apply, stacked_params, wr, x, capacity, k=1):
    """Same top-k routing and choice-major capacity drops as the sharded
    path, every expert applied to every token and weighted by its gate.
    ``stacked_params`` is a dict of tensors with a leading expert axis."""
    e = next(iter(stacked_params.values())).shape[0]
    probs = router_probs(wr, x)
    dsts, gates = _topk_routing(probs, k)
    keep = _choice_major_slots(dsts, e) < capacity
    out = None
    for i in range(e):
        y = expert_apply({n: p[i] for n, p in stacked_params.items()}, x)
        w = torch.where((dsts == i) & keep, gates,
                        torch.zeros_like(gates)).sum(dim=1)
        contrib = y * w[:, None]
        out = contrib if out is None else out + contrib
    return out
