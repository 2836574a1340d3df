"""Spatio-temporal clustering of candidate detections.

``local_marching`` re-implements the reference's ``LocalMarching``
mean-shift-like clustering (process_utils.py:40-100): build an ε-graph over
candidates that are close in time (``tc_win``) and space (``sp_win``, depth
down-weighted), find connected components, and within each component keep
iteratively-propagated local maxima of the detection value.

Union-find connected components replace networkx (SURVEY §2.10); the whole
routine is host-side NumPy — it runs on a few hundred candidates per group.
"""

from __future__ import annotations

import numpy as np


class UnionFind:
    def __init__(self, n):
        self.p = np.arange(n)

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def connected_components(n, edges):
    uf = UnionFind(n)
    for a, b in edges:
        uf.union(a, b)
    roots = np.array([uf.find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def local_marching(cands, values, tc_win: float = 5.0, sp_win: float = 17.5e3,
                   depth_weight: float = 1.0, n_steps: int = 100,
                   tol: float = 1e-12):
    """cands: (n, 4) (x, y, z, t) Cartesian; values: (n,) detection scores.

    Directed max-flooding, matching the reference's LocalMarching
    (process_utils.py:40-100): build the ε-graph (|Δt| < tc_win AND
    ‖Δx‖ < sp_win with depth scaled by ``depth_weight``), keep only edges
    j→i with value_j ≥ value_i (plus the implicit self-loop from the
    ball query), and iterate v_i ← max over incoming j of v_j to a fixed
    point. Survivors are the nodes whose flooded value equals their
    original value — i.e. every local maximum, so a transitive chain of
    candidates does NOT collapse to one detection per connected component
    (multiple events inside one chain each keep their own peak).

    Returns indices of surviving local maxima.
    """
    n = len(cands)
    if n == 0:
        return np.zeros(0, np.int64)
    if n == 1:
        return np.zeros(1, np.int64)

    pos = cands[:, :3].copy()
    pos[:, 2] *= depth_weight  # ref scale_depth (default 1.0)
    t = np.asarray(cands[:, 3], np.float64)
    values = np.asarray(values, np.float64)

    # Time-sorted CSR adjacency: a candidate only interacts with candidates
    # within tc_win in time, so after sorting by t its neighbours live in a
    # contiguous [lo, hi) index band (searchsorted). Memory is O(total edges)
    # instead of the dense O(n^2) pairwise matrix, which at real-day candidate
    # counts (200k+ at low thresholds) would be hundreds of GiB.
    order = np.argsort(t, kind="stable")
    ts, ps, vs = t[order], pos[order], values[order]
    lo = np.searchsorted(ts, ts - tc_win, side="left")
    hi = np.searchsorted(ts, ts + tc_win, side="right")

    counts = np.zeros(n, np.int64)
    cols_chunks = []
    chunk = max(1, int(2**24 // max(1, int((hi - lo).max()))))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        w = int((hi[s:e] - lo[s:e]).max())
        band = lo[s:e, None] + np.arange(w)[None, :]
        valid = band < hi[s:e, None]
        band = np.minimum(band, n - 1)
        d2 = ((ps[band] - ps[s:e, None, :]) ** 2).sum(-1)
        # directed: node i receives only from neighbours j with value_j >=
        # value_i (original values fix the flow field); the band contains i
        # itself, so the self-loop that keeps v_i alive is included for free
        ok = valid & (d2 < sp_win**2) & (vs[band] >= vs[s:e, None])
        counts[s:e] = ok.sum(1)
        cols_chunks.append(band[ok])  # row-major: per-row neighbour runs
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = np.concatenate(cols_chunks)

    v = vs.copy()
    for _ in range(n_steps):
        flooded = np.maximum.reduceat(v[cols], indptr[:-1])
        if np.abs(flooded - v).max() <= tol:
            v = flooded
            break
        v = flooded
    keep_sorted = np.where(np.abs(v - vs) <= tol * np.maximum(1, np.abs(vs)))[0]
    return np.sort(order[keep_sorted]).astype(np.int64)


def find_peaks_1d(x, thresh: float, min_spacing: int = 1):
    """Local maxima above ``thresh`` with minimum index spacing — the
    reference's scipy ``find_peaks`` usage (process_continuous_days.py:846).
    Vectorized NumPy; returns peak indices."""
    x = np.asarray(x)
    n = len(x)
    if n < 3:
        return np.zeros(0, np.int64)
    is_peak = (x[1:-1] >= x[:-2]) & (x[1:-1] > x[2:]) & (x[1:-1] > thresh)
    idx = np.where(is_peak)[0] + 1
    if min_spacing > 1 and len(idx) > 1:
        keep = []
        order = idx[np.argsort(-x[idx])]  # by height
        taken = np.zeros(n, bool)
        for i in order:
            if not taken[max(0, i - min_spacing):i + min_spacing + 1].any():
                keep.append(i)
                taken[i] = True
        idx = np.array(sorted(keep), np.int64)
    return idx


def split_time_groups(times, break_win: float):
    """Split sorted candidate times at gaps ≥ break_win
    (process_continuous_days.py:851-890). Returns list of index arrays."""
    times = np.asarray(times)
    if len(times) == 0:
        return []
    order = np.argsort(times)
    ts = times[order]
    breaks = np.where(np.diff(ts) >= break_win)[0]
    groups = np.split(order, breaks + 1)
    return [np.sort(g) for g in groups]
