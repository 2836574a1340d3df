"""Subgraph (sparse product) mode: ε+kNN source-station pair selection.

Port of ``genie_tpu/graphs/subgraph.py`` (the reference's ``use_subgraph``,
process_utils.py:744-849): keep only the (source, station) pairs within
``max_deg_offset`` degrees plus each source's ``k_nearest_pairs`` stations.
On the dense product layout the mask is the subgraph: :func:`pair_mask`
gives the (n_src, n_sta) selection and :func:`apply_pair_mask` zeroes the
product features outside it (numerically the reference's sparse gather on
the kept pairs).

``torch.topk`` may pick other stations than ``jax.lax.top_k`` among
stations at exactly the same distance; elsewhere the two masks are equal.
"""

from __future__ import annotations

import torch


def pair_mask(src_lla, sta_lla, max_deg_offset: float = 1.5,
              k_nearest_pairs: int = 30):
    """(n_src, n_sta) bool: pairs within the ε-ball (lat/lon degrees) OR
    among each source's k nearest stations."""
    d_deg = torch.sqrt(((src_lla[:, None, :2] - sta_lla[None, :, :2]) ** 2).sum(-1))
    eps_ball = d_deg < max_deg_offset
    k = min(k_nearest_pairs, sta_lla.shape[0])
    _, idx = torch.topk(-d_deg, k, dim=1)
    knn_mask = torch.zeros_like(eps_ball).scatter_(1, idx, True)
    return eps_ball | knn_mask


def apply_pair_mask(feat, mask, a_src_in_sta):
    """Zero product features (..., n_src, n_sta, C) outside the subgraph."""
    m = a_src_in_sta[..., None].to(feat.dtype)
    return feat * m, mask * m
