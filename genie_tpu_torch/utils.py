"""Assorted utilities, copied from ``genie_tpu/utils.py``.

  * :func:`in_hull` and :func:`hull_halfspaces`: convex-hull membership on
    the host (scipy);
  * :func:`select_stations_within_pick_budget`: the largest station subset
    whose total pick count stays under a cap (greedy by ascending count is
    exact for the subset size);
  * :func:`compute_travel_times_chunked`: a travel-time callable over many
    (station × source) pairs in chunks that bound peak memory. It works on
    tensors and leaves the result on their device.
"""

from __future__ import annotations

import numpy as np
import torch


def in_hull(points, hull_points):
    """True for points inside the convex hull of ``hull_points``."""
    from scipy.spatial import Delaunay

    tri = Delaunay(np.asarray(hull_points))
    return tri.find_simplex(np.asarray(points)) >= 0


def hull_halfspaces(hull_points):
    """Half-space form (A, b) of the convex hull of ``hull_points``: x is
    inside iff ``A @ x + b <= 0`` for every row."""
    from scipy.spatial import ConvexHull

    eq = ConvexHull(np.asarray(hull_points)).equations  # (n_facets, d+1)
    return eq[:, :-1].copy(), eq[:, -1].copy()


def select_stations_within_pick_budget(pick_counts, max_picks: int):
    """Indices of the largest station subset with Σ picks ≤ max_picks."""
    counts = np.asarray(pick_counts)
    order = np.argsort(counts)
    csum = np.cumsum(counts[order])
    n_keep = int(np.searchsorted(csum, max_picks, side="right"))
    return np.sort(order[:n_keep])


@torch.no_grad()
def compute_travel_times_chunked(trv_from_cart, sta_cart, src_cart,
                                 max_chunk: int = 50_000):
    """``trv_from_cart(sta_cart, src_cart)`` over ``(n_src, 3)`` sources,
    at most ``max_chunk`` (source, station) pairs per call; returns ``(n_src,
    n_sta, 2)`` on the sources' device."""
    n_sta = sta_cart.shape[0]
    rows_per_chunk = max(1, max_chunk // max(n_sta, 1))
    return torch.cat([trv_from_cart(sta_cart, src_cart[i:i + rows_per_chunk])
                      for i in range(0, src_cart.shape[0], rows_per_chunk)], dim=0)
