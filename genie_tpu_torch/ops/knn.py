"""k-nearest-neighbour search with static shapes.

Port of ``genie_tpu/ops/knn.py:25-113``: brute-force masked squared
distances (``|a|²+|b|²-2ab``, one matmul for the cross term) and
``torch.topk``. Masked context points get +inf distance and are never
selected while a valid one remains. ``torch.topk`` and ``jax.lax.top_k`` may
order equal distances differently, so :func:`knn` tables agree with the JAX
package as sets; :func:`knn_tiled`, which streams context tiles through a
running top-k for large context sets, takes its top-k by a stable sort and
so orders ties as ``lax.top_k`` does (lower index first).
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


def _top_k_stable(scores, k: int):
    """``lax.top_k``: the ``k`` largest scores per row, ties by lower index."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def knn_tiled(x_context, x_query, k: int, context_mask=None, tile: int = 8192):
    """:func:`knn` over context tiles of ``tile`` rows with a running top-k,
    so peak memory is O(n_q · (tile + 2k)). Returns ``(idx, valid)`` of
    shape ``(n_q, k)``; an invalid slot repeats the row's first index."""
    n_c = x_context.shape[0]
    n_q = x_query.shape[0]
    dev = x_query.device
    best_s = torch.full((n_q, k), float("-inf"), device=dev)
    best_i = torch.zeros((n_q, k), dtype=torch.long, device=dev)
    for t0 in range(0, n_c, tile):
        xc = x_context[t0:t0 + tile]
        n_t = xc.shape[0]
        m = torch.ones(n_t, dtype=torch.bool, device=dev)
        if context_mask is not None:
            m = context_mask[t0:t0 + tile].bool()
        if n_t < tile:      # the padded tail of the last tile: masked zeros
            xc = torch.cat((xc, xc.new_zeros((tile - n_t, xc.shape[1]))))
            m = torch.cat((m, m.new_zeros(tile - n_t)))
        d = pairwise_sq_dist(x_query, xc)
        d = torch.where(m[None, :], d, torch.full_like(d, float("inf")))
        s, i = _top_k_stable(-d, min(k, tile))
        best_s, sel = _top_k_stable(torch.cat((best_s, s), dim=1), k)
        best_i = torch.gather(torch.cat((best_i, i + t0), dim=1), 1, sel)
    valid = torch.isfinite(best_s)
    idx = torch.where(valid, best_i, best_i[:, :1])
    return idx.to(torch.int32), valid
