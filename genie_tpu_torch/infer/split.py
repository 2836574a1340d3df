"""Splitting oversized assignment components.

The reference caps competitive-assignment components at ``max_sources``≈15
and recursively splits larger ones with SpectralClustering + the relaxed
assignment (process_continuous_days.py:1269-1441). Here: small dense
spectral bisection (eigenvectors of the normalized affinity Laplacian — no
sklearn needed at this scale) + ``competitive_assignment_split`` to divide
the picks between the two halves.
"""

from __future__ import annotations

import numpy as np

from genie_tpu_torch.infer.assign import competitive_assignment_split


def spectral_bisect(affinity):
    """Two-way spectral partition of a dense affinity matrix (n, n)."""
    a = np.asarray(affinity, float)
    n = len(a)
    if n <= 1:
        return np.zeros(n, int)
    d = a.sum(axis=1)
    d_inv = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    L = np.eye(n) - d_inv[:, None] * a * d_inv[None, :]
    w, v = np.linalg.eigh(L)
    fiedler = v[:, 1] if n > 1 else v[:, 0]
    labels = (fiedler > np.median(fiedler)).astype(int)
    if labels.sum() in (0, n):  # degenerate: force a split
        labels[np.argsort(fiedler)[: n // 2]] = 0
        labels[np.argsort(fiedler)[n // 2:]] = 1
    return labels


def split_component(weights, ipick, src_pos, src_time, max_sources: int,
                    sig_x: float = 15e3, sig_t: float = 10.0, max_splits: int = 30):
    """Recursively split a (sources × picks) weight block until every part
    has ≤ max_sources sources. Pick edges crossing the cut are removed using
    the relaxed assignment (each pick follows its best source's side).

    Returns a list of (src_idx, pick_idx) index-array pairs.
    """
    n_src = weights.shape[0]
    parts = [(np.arange(n_src), np.arange(weights.shape[1]))]
    out = []
    splits = 0
    while parts:
        qs, ps = parts.pop()
        if len(qs) <= max_sources or splits >= max_splits:
            out.append((qs, ps))
            continue
        splits += 1
        # source-source affinity: shared-pick weight + space-time proximity
        w = weights[np.ix_(qs, ps)].sum(-1)               # (nq, np_)
        shared = w @ w.T
        d2 = ((src_pos[qs][:, None] - src_pos[qs][None]) ** 2).sum(-1) / sig_x**2
        dt2 = (src_time[qs][:, None] - src_time[qs][None]) ** 2 / sig_t**2
        aff = shared / max(shared.max(), 1e-9) + np.exp(-0.5 * (d2 + dt2))
        labels = spectral_bisect(aff)
        # assign each pick to the side of its best source (relaxed assignment)
        assign, _ = competitive_assignment_split(
            weights[np.ix_(qs, ps)].transpose(1, 0, 2), ipick[ps], cost=0.0)
        side_of_pick = np.full(len(ps), -1)
        ok = assign[:, 0] >= 0
        side_of_pick[ok] = labels[assign[ok, 0]]
        for side in (0, 1):
            q_side = qs[labels == side]
            p_side = ps[(side_of_pick == side)]
            if len(q_side):
                parts.append((q_side, p_side))
    return out
