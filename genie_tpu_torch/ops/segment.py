"""Segment reductions, fixed-k gather means and the dense averaging matrix.

Port of ``genie_tpu/ops/segment.py``. The edge-list reductions
(``segment_sum``, ``segment_mean``, ``segment_max``, ``segment_softmax``)
reduce rows of ``data`` into ``num_segments`` buckets given per-row segment
ids, as ``jax.ops.segment_*`` do (an empty segment's max is -inf), and
:func:`spmm` is a sparse-by-dense product over an edge list. GENIE's
graphs have fixed fan-in (station kNN k=8, source kNN k=15), so a mean
aggregation on them is a gather plus a masked mean over a k axis, or, with
the row-stochastic matrix ``A`` that :func:`aggregation_matrix` builds, one
matrix product.

Product-graph tensors here carry any number of leading batch dimensions
before ``(n_src, n_sta, C)``.
"""

from __future__ import annotations

import torch


def segment_sum(data, segment_ids, num_segments: int):
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data, segment_ids, num_segments: int):
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    return s / torch.clamp_min(cnt, 1.0).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data, segment_ids, num_segments: int):
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments, *data.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, ids, data, reduce="amax", include_self=True)


def segment_softmax(scores, segment_ids, num_segments: int):
    """Numerically stable softmax within segments (PyG ``softmax`` twin);
    ``scores`` (E, …) with the segment axis first."""
    m = segment_max(scores, segment_ids, num_segments)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ids = segment_ids.long()
    e = torch.exp(scores - m[ids])
    z = segment_sum(e, ids, num_segments)
    return e / torch.clamp_min(z, 1e-20)[ids]


def spmm(edge_src, edge_dst, x, num_dst: int, edge_weight=None, aggr: str = "sum"):
    """For every edge (s → d), ``x[s]`` (times its weight) reduced into row
    ``d`` by ``aggr`` ("sum", "mean" or "max"); differentiable."""
    if aggr not in ("sum", "mean", "max"):
        raise ValueError(f"unknown aggr {aggr!r}")
    msg = x[edge_src.long()]
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    reduce = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}[aggr]
    return reduce(msg, edge_dst, num_dst)


def gather_sum(x, nbr_idx, nbr_valid=None):
    """``out[i] = Σ_k x[nbr_idx[i, k]]``; x (N, C), nbr_idx (M, k)."""
    g = x[nbr_idx.long()]
    if nbr_valid is not None:
        g = g * nbr_valid[..., None]
    return g.sum(dim=1)


def gather_mean(x, nbr_idx, nbr_valid=None):
    g = x[nbr_idx.long()]
    if nbr_valid is None:
        return g.mean(dim=1)
    g = g * nbr_valid[..., None]
    cnt = torch.clamp_min(nbr_valid.sum(dim=1, keepdim=True), 1)
    return g.sum(dim=1) / cnt


def gather_mean_sta_axis(feat, sta_nbr, sta_valid=None):
    """``out[..., s, i] = mean_k feat[..., s, sta_nbr[i, k]]`` over valid k
    (the station relation of the product graph)."""
    g = feat[..., sta_nbr.long(), :]                 # (..., n_src, n_sta, k, C)
    if sta_valid is None:
        return g.mean(dim=-2)
    g = g * sta_valid[..., None]
    cnt = torch.clamp_min(sta_valid.sum(dim=1), 1)[:, None]
    return g.sum(dim=-2) / cnt


def gather_mean_src_axis(feat, src_nbr, src_valid=None):
    """``out[..., s, i] = mean_k feat[..., src_nbr[s, k], i]`` (the source
    relation of the product graph)."""
    g = feat[..., src_nbr.long(), :, :]              # (..., n_src, k, n_sta, C)
    if src_valid is None:
        return g.mean(dim=-3)
    g = g * src_valid[:, :, None, None]
    cnt = torch.clamp_min(src_valid.sum(dim=1), 1)[:, None, None]
    return g.sum(dim=-3) / cnt


def aggregation_weights(nbr_idx, nbr_valid=None, dtype=torch.float32):
    """Per-slot weights ``valid / deg`` of the mean over a (m, k) neighbour
    table — the nonzeros of :func:`aggregation_matrix`, kept sparse."""
    w = (torch.ones(nbr_idx.shape, dtype=dtype, device=nbr_idx.device)
         if nbr_valid is None else nbr_valid.to(dtype))
    deg = torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    return w / deg


def aggregation_matrix(nbr_idx, n: int, nbr_valid=None, dtype=torch.float32):
    """Row-normalized averaging matrix A (m, n): ``A[i, j] = 1/deg(i)`` iff j
    is a valid neighbour of i."""
    return neighbours_to_dense(nbr_idx, aggregation_weights(nbr_idx, nbr_valid, dtype),
                               n)


def neighbours_to_dense(nbr, w, n: int):
    """The dense (m, n) matrix of padded ``(nbr, w)`` lists, ``A[i, j] =
    Σ_k w[i, k]·[nbr[i, k] = j]``: the inverse of :func:`dense_to_neighbours`."""
    m = nbr.shape[0]
    a = torch.zeros((m, n), dtype=w.dtype, device=w.device)
    rows = torch.arange(m, device=w.device)[:, None].expand_as(nbr)
    a.index_put_((rows.reshape(-1), nbr.long().reshape(-1)), w.reshape(-1),
                 accumulate=True)
    return a


def matmul_mean_sta_axis(feat, a_sta):
    """``out[..., s, i, c] = Σ_j A[i, j]·feat[..., s, j, c]``."""
    return torch.matmul(a_sta, feat)


def matmul_mean_src_axis(feat, a_src):
    """``out[..., i, s, c] = Σ_j A[i, j]·feat[..., j, s, c]``; a_src (n_src, n_src)."""
    *lead, n_src, n_sta, c = feat.shape
    out = torch.matmul(a_src, feat.reshape(*lead, n_src, n_sta * c))
    return out.reshape(*lead, n_src, n_sta, c)


def dense_to_neighbours(a):
    """Padded ``(nbr, w)`` lists of a dense (m, n) matrix: k is the largest
    count of nonzeros in any row; padded slots carry weight 0 and index 0.
    Exact: ``A @ x == Σ_k w[:, k]·x[nbr[:, k]]``."""
    nz = a != 0
    k = max(int(nz.sum(dim=1).max().item()), 1)
    # stable sort puts each row's nonzero columns first, in column order
    order = torch.sort((~nz).to(torch.int8), dim=1, stable=True).indices[:, :k]
    w = torch.gather(a, 1, order)
    nbr = torch.where(w != 0, order, torch.zeros_like(order))
    return nbr.to(torch.int32).contiguous(), w.contiguous()


def mean_sta_axis(feat, sta_nbr, sta_valid=None, via_matmul: bool = False):
    """Station-axis mean aggregation by the gather form or, with
    ``via_matmul``, by one product with the row-stochastic matrix."""
    if via_matmul:
        a = aggregation_matrix(sta_nbr, feat.shape[-2], sta_valid, feat.dtype)
        return matmul_mean_sta_axis(feat, a)
    return gather_mean_sta_axis(feat, sta_nbr, sta_valid)


def mean_src_axis(feat, src_nbr, src_valid=None, via_matmul: bool = False):
    """Source-axis mean aggregation, in either form (see :func:`mean_sta_axis`)."""
    if via_matmul:
        a = aggregation_matrix(src_nbr, feat.shape[-3], src_valid, feat.dtype)
        return matmul_mean_src_axis(feat, a)
    return gather_mean_src_axis(feat, src_nbr, src_valid)
