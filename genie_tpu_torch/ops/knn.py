"""k-nearest-neighbour search with static shapes.

Port of ``genie_tpu/ops/knn.py:25-72``: brute-force masked squared distances
(``|a|²+|b|²-2ab``, one matmul for the cross term) and ``torch.topk``.
Masked context points get +inf distance and are never selected while a
valid one remains. ``torch.topk`` and ``jax.lax.top_k`` may order equal
distances differently, so tables agree with the JAX package as sets.
"""

from __future__ import annotations

import torch


def pairwise_sq_dist(x_query, x_context):
    """Squared euclidean distances, (n_q, n_c)."""
    q2 = (x_query ** 2).sum(-1, keepdim=True)
    c2 = (x_context ** 2).sum(-1, keepdim=True).transpose(-1, -2)
    cross = x_query @ x_context.transpose(-1, -2)
    return torch.clamp_min(q2 + c2 - 2.0 * cross, 0.0)


def knn(x_context, x_query, k: int, context_mask=None):
    """``(idx, valid)`` of the ``k`` nearest context points per query, each
    ``(..., n_q, k)``. Leading batch dimensions are allowed. Invalid slots
    repeat the nearest index and are marked False."""
    d = pairwise_sq_dist(x_query, x_context)
    if context_mask is not None:
        d = torch.where(context_mask[..., None, :], d,
                        torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, k, dim=-1)
    valid = torch.isfinite(neg)
    idx = torch.where(valid, idx, idx[..., :1])
    return idx.to(torch.int32), valid


def knn_graph(x, k: int, mask=None):
    """k-NN graph over one point set, self excluded: ``(nbr, valid)`` of
    shape ``(n, k)``. Masked nodes neither send nor receive."""
    n = x.shape[0]
    d = pairwise_sq_dist(x, x)
    d = d.masked_fill(torch.eye(n, dtype=torch.bool, device=x.device), float("inf"))
    if mask is not None:
        d = torch.where(mask[None, :], d, torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, k, dim=-1)
    valid = torch.isfinite(neg)
    if mask is not None:
        valid = valid & mask[:, None]
    idx = torch.where(valid, idx, torch.arange(n, device=x.device)[:, None])
    return idx.to(torch.int32), valid
