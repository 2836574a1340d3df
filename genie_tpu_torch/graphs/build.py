"""Graph construction: kNN tables, time pointers, pick pairs, edge features.

Port of ``genie_tpu/graphs/build.py:26-51, 228-302``. Tables are torch
tensors on the device of their inputs. ``torch.topk`` may order equal keys
differently from ``jax.lax.top_k``, so tables agree with the JAX package as
sets; every consumer is invariant to the order within a row. Of the k-means
packing family only :func:`kmeans_packing` (the inference query grid) is
ported; its draws come from a ``torch.Generator`` and differ from
``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from genie_tpu_torch.ops.knn import knn, knn_graph
from genie_tpu_torch.ops.segment import segment_mean


def kmeans_step(v, x, to_cart, weight, lr: float):
    """One stochastic Lloyd step: every node moves ``lr`` of the way to the
    mean of the samples ``x`` nearest to it (in ``weight``-scaled Cartesian
    coordinates); nodes without samples stay."""
    idx, _ = knn(to_cart(v) * weight, to_cart(x) * weight, 1)
    ip = idx[:, 0].long()
    return v + lr * segment_mean(x - v[ip], ip, v.shape[0])


def kmeans_packing(generator, scale_x, offset_x, n_clusters: int, to_cart,
                   weight=None, n_batch: int = 3000, n_steps: int = 1000,
                   lr: float = 0.01):
    """Pack ``n_clusters`` nodes quasi-uniformly over the box ``offset_x +
    [0, scale_x]`` by stochastic Lloyd iterations on the generator's device;
    ``weight`` re-weights the Cartesian axes (depth importance)."""
    dev = generator.device
    scale_x = torch.as_tensor(np.asarray(scale_x, np.float32), device=dev).reshape(1, -1)
    offset_x = torch.as_tensor(np.asarray(offset_x, np.float32), device=dev).reshape(1, -1)
    w = (torch.ones((1, 3), device=dev) if weight is None else
         torch.as_tensor(np.asarray(weight, np.float32), device=dev).reshape(1, -1))

    def uniform(n):
        return torch.rand((n, 3), generator=generator, device=dev) * scale_x + offset_x

    v = uniform(n_clusters)
    for _ in range(n_steps):
        v = kmeans_step(v, uniform(n_batch), to_cart, w, lr)
    return v


def build_station_graph(sta_cart, k: int, sta_mask=None):
    """Station kNN graph (k=8) on km-scaled coordinates."""
    return knn_graph(torch.as_tensor(sta_cart) / 1000.0, k, mask=sta_mask)


def build_source_graph(src_cart, k: int):
    """Source-grid kNN graph (k=15)."""
    nbr, _ = knn_graph(torch.as_tensor(src_cart) / 1000.0, k)
    return nbr


def build_query_attachment(src_cart, x_query_cart, k: int = 10):
    """kNN of query points into the source grid for SpatialAttention.
    ``x_query_cart`` may carry leading batch dimensions."""
    idx, _ = knn(torch.as_tensor(src_cart) / 1000.0,
                 torch.as_tensor(x_query_cart) / 1000.0, k)
    return idx


def _time_ptr_one_phase(trv_phase, dt_partition, k: int):
    d = (trv_phase.T[:, None, :] - dt_partition[None, :, None]).abs()
    return torch.topk(-d, k, dim=-1).indices.to(torch.int32)


def build_time_pointers(trv, dt: float = 1.0, k: int = 10, win: float = 10.0,
                        max_t: float | None = None):
    """Per-(station, time-bin) tables of the k source nodes whose travel time
    is nearest the bin. Returns ``(ptr_p, ptr_s, dt0, dt, n_dt)`` with ptr_*
    of shape (n_sta, n_dt, k) holding source indices."""
    trv = torch.as_tensor(trv)
    if max_t is None:
        max_t = float(trv.max())
    dt_partition = np.arange(-win, win + max_t + dt, dt, dtype=np.float32)
    part = torch.as_tensor(dt_partition, device=trv.device)
    ptr_p = _time_ptr_one_phase(trv[:, :, 0], part, k)
    ptr_s = _time_ptr_one_phase(trv[:, :, 1], part, k)
    return ptr_p, ptr_s, float(dt_partition[0]), float(dt), len(dt_partition)


def build_pair_table(tpick, ipick, pick_mask, k_pair: int = 16):
    """For every pick the ``k_pair`` nearest-in-time picks at the same
    station (self first), plus a trailing null slot. Arrays may carry a
    leading window axis. Returns ``(pair_idx (..., n_pick, k_pair+1),
    pair_valid)``; index n_pick is the null arrival."""
    n_pick = tpick.shape[-1]
    same_sta = ipick[..., :, None] == ipick[..., None, :]
    both = pick_mask[..., :, None] & pick_mask[..., None, :]
    d = (tpick[..., :, None] - tpick[..., None, :]).abs()
    d = torch.where(same_sta & both, d, torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, min(k_pair, n_pick), dim=-1)
    valid = torch.isfinite(neg)
    idx = torch.where(valid, idx, torch.full_like(idx, n_pick))
    null_col = torch.full((*idx.shape[:-1], 1), n_pick, dtype=idx.dtype,
                          device=idx.device)
    pair_idx = torch.cat((idx, null_col), dim=-1).to(torch.int32)
    pair_valid = torch.cat((valid, pick_mask[..., None]), dim=-1)
    return pair_idx, pair_valid


def build_edge_feat(src_lla, sta_lla, scale_x_extend):
    """Bipartite read-in/out edge features: (src − sta)/scale in lat/lon/depth
    units, (n_src, n_sta, 3)."""
    src_lla = torch.as_tensor(src_lla)
    sta_lla = torch.as_tensor(sta_lla, device=src_lla.device)
    scale = torch.as_tensor(scale_x_extend, dtype=torch.float32,
                            device=src_lla.device).reshape(1, 1, 3)
    return (src_lla[:, None, :] - sta_lla[None, :, :]) / scale
