"""Plain PyTorch forward of the GENIE detector, for the benchmark's checks.

A frozen copy of the detector and its layers as the PyTorch port defines
them at the commit that added the benchmark, with every dual-relation round
computed by its plain form (gather mean over the station kNN table, two
linears, PReLU) and the source-axis mean by the dense row-stochastic
matrix: no kernel, no autograd function. It imports nothing of the program
and is held to the program's plain CPU path by
``benchmark/tests/test_bench_reference.py``. Float32; the caller turns TF32
off.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


def prelu(x, a):
    """``max(x, 0) + a·min(x, 0)``."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) + a * torch.minimum(x, zero)


def aggregation_weights(nbr_idx, nbr_valid=None, dtype=torch.float32):
    """Per-slot weights ``valid / deg`` of the mean over a (m, k) table."""
    w = (torch.ones(nbr_idx.shape, dtype=dtype, device=nbr_idx.device)
         if nbr_valid is None else nbr_valid.to(dtype))
    deg = torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    return w / deg


def neighbours_to_dense(nbr, w, n: int):
    """The dense (m, n) matrix ``A[i, j] = Σ_k w[i, k]·[nbr[i, k] = j]``."""
    m = nbr.shape[0]
    a = torch.zeros((m, n), dtype=w.dtype, device=w.device)
    rows = torch.arange(m, device=w.device)[:, None].expand_as(nbr)
    a.index_put_((rows.reshape(-1), nbr.long().reshape(-1)), w.reshape(-1),
                 accumulate=True)
    return a


def aggregation_matrix(nbr_idx, n: int, nbr_valid=None, dtype=torch.float32):
    """Row-normalized averaging matrix A (m, n)."""
    return neighbours_to_dense(nbr_idx, aggregation_weights(nbr_idx, nbr_valid, dtype),
                               n)


def matmul_mean_src_axis(feat, a_src):
    """``out[..., i, s, c] = Σ_j A[i, j]·feat[..., j, s, c]``."""
    *lead, n_src, n_sta, c = feat.shape
    out = torch.matmul(a_src, feat.reshape(*lead, n_src, n_sta * c))
    return out.reshape(*lead, n_src, n_sta, c)


def fused_round_plain(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                      e_sta=None, e_src=None):
    """One dual-relation round: the station mean of PReLU(z) over the
    ``(nbr, w)`` table, then ``PReLU([u1 @ W1ᵀ + b1 ‖ u2 @ W2ᵀ + b2])`` with
    ``u1 = [x ‖ agg_sta ‖ e_sta ‖ mask]`` and ``u2 = [x ‖ agg_src ‖ e_src ‖
    mask]`` (the edge columns only in the updated model definition)."""
    zp = prelu(z, slopes[0])
    agg_sta = (zp[..., nbr.long(), :] * w[..., None]).sum(dim=-2)
    if e_sta is None:
        u1 = torch.cat((x, agg_sta, mask), dim=-1)
        u2 = torch.cat((x, agg_src, mask), dim=-1)
    else:
        shp = (*x.shape[:-1], e_sta.shape[-1])
        u1 = torch.cat((x, agg_sta, e_sta.expand(shp), mask), dim=-1)
        u2 = torch.cat((x, agg_src, e_src[:, None, :].expand(shp), mask), dim=-1)
    h = torch.cat((F.linear(u1, w1, b1), F.linear(u2, w2, b2)), dim=-1)
    return prelu(h, slopes[1])


class PReLU(nn.Module):
    """PReLU with one learnable slope ``a``, init 0.25."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return prelu(x, self.a)


def _prelus(module: nn.Module, n: int):
    """Register ``PReLU_0 … PReLU_{n-1}`` (the flax auto-names, creation
    order) and keep them as the plain tuple ``module.acts``, which is not
    registered a second time."""
    acts = []
    for i in range(n):
        act = PReLU()
        module.add_module(f"PReLU_{i}", act)
        acts.append(act)
    module.acts = tuple(acts)


class ProductTables(NamedTuple):
    """Graph tables the dual-relation rounds read, shared across windows."""

    sta_nbr: torch.Tensor  # (n_sta, k_sta) int32 station kNN
    sta_w: torch.Tensor    # (n_sta, k_sta) f32 valid/deg weights
    # (n_src, n_src) row-stochastic source-kNN mean; None with src_agg
    a_src: torch.Tensor | None
    # edge tables of the updated model definition, None without it
    e_sta: torch.Tensor | None = None  # (n_sta, 4)
    e_src: torch.Tensor | None = None  # (n_src, 4)
    # source-axis mean override, (…, n_src, n_sta, C) -> the same shape: the
    # sharded trunks' halo-exchange aggregation (JAX ``src_agg``)
    src_agg: Callable | None = None


def src_mean(x, tables: ProductTables):
    """The source-axis mean of a product tensor: ``tables.src_agg`` where
    given, else the dense ``A_src`` product."""
    if tables.src_agg is not None:
        return tables.src_agg(x)
    return matmul_mean_src_axis(x, tables.a_src)


def mean_rel_pos_embed(pos, nbr, scale_rel, valid=None):
    """Per-receiver mean of Gaussian-embedded relative sender positions
    (``layers.py:42-68``): ``sign(Δ)·exp(−Δ²/2σ²)`` of (Δxyz, ‖Δ‖) with
    ``‖Δ‖ = sqrt(ΣΔ² + 1e-12)`` (so a self-edge's norm channel is
    ``exp(-0.5e-12/σ²) ≈ 1`` and its xyz channels ``sign(0) = 0``), averaged
    over the k neighbours, or over the ``valid`` ones divided by
    ``max(count, 1)``. pos (n, 3); nbr (n, k); valid (n, k) bool → (n, 4)."""
    rel = pos[nbr.long()] - pos[:, None, :]                # x_j − x_i, (n, k, 3)
    nrm = torch.sqrt((rel ** 2).sum(-1, keepdim=True) + 1e-12)
    rel = torch.cat((rel, nrm), dim=-1)
    emb = torch.sign(rel) * torch.exp(-0.5 * rel ** 2 / scale_rel ** 2)
    if valid is None:
        return emb.mean(dim=1)
    cnt = torch.clamp_min(valid.sum(dim=1, keepdim=True), 1).to(emb.dtype)
    return (emb * valid[..., None].to(emb.dtype)).sum(dim=1) / cnt


def _slopes(a, b):
    return torch.stack((a.a, b.a))


class DataAggregation(nn.Module):
    """Two rounds of dual-relation conv on the station×source product graph
    (``layers.py:71-132``, ref module.py:52-98). Input (B, n_src, n_sta,
    in_ch) + mask (B, n_src, n_sta, n_mask); output (B, n_src, n_sta,
    2·out_ch). The reference's unused ``l1_*_1`` linears are not created.
    ``use_edges`` widens the ``l*_t*_2`` linears by the 4 edge channels, in
    the JAX column order ``[x ‖ agg ‖ e ‖ mask]``, and the rounds read the
    edge tables of :class:`ProductTables`."""

    def __init__(self, in_channels: int = 4, out_channels: int = 15,
                 n_hidden: int = 30, n_mask: int = 4, use_edges: bool = False):
        super().__init__()
        h = n_hidden
        n_e = 4 if use_edges else 0
        _prelus(self, 7)  # act, act11, act12, act1, act21, act22, act2
        self.init_trns = nn.Linear(in_channels + n_mask, h)
        self.l1_t1_2 = nn.Linear(2 * h + n_e + n_mask, h)
        self.l1_t2_2 = nn.Linear(2 * h + n_e + n_mask, h)
        self.l2_t1_1 = nn.Linear(2 * h, h)
        self.l2_t2_1 = nn.Linear(2 * h, h)
        self.l2_t1_2 = nn.Linear(3 * h + n_e + n_mask, out_channels)
        self.l2_t2_2 = nn.Linear(3 * h + n_e + n_mask, out_channels)

    def forward(self, tr, mask, tables: ProductTables):
        act, act11, act12, act1, act21, act22, act2 = self.acts
        mask = mask.contiguous()
        tr = act(self.init_trns(torch.cat((tr, mask), dim=-1))).contiguous()
        # round 1: the station mean reads act11(tr) directly
        agg_src = src_mean(act12(tr), tables)
        tr = fused_round_plain(tr, tr, agg_src, mask, tables.sta_nbr, tables.sta_w,
                              self.l1_t1_2.weight, self.l1_t1_2.bias,
                              self.l1_t2_2.weight, self.l1_t2_2.bias,
                              _slopes(act11, act1), tables.e_sta, tables.e_src)
        # round 2: Dense before each PReLU, applied first as a plain linear
        z = self.l2_t1_1(tr).contiguous()
        agg_src = src_mean(act22(self.l2_t2_1(tr)), tables)
        return fused_round_plain(tr, z, agg_src, mask, tables.sta_nbr, tables.sta_w,
                                self.l2_t1_2.weight, self.l2_t1_2.bias,
                                self.l2_t2_2.weight, self.l2_t2_2.bias,
                                _slopes(act21, act2), tables.e_sta, tables.e_src)


class BipartiteReadIn(nn.Module):
    """Collapse product features onto source nodes (sum over stations, gated
    by pick presence; ``layers.py:135-160``). ``normalize`` divides the sum
    by the gated station count (at least 1) times a learnable ``sum_gain``,
    initialised to 8.0."""

    def __init__(self, ndim_in: int = 30, ndim_out: int = 15,
                 normalize: bool = False):
        super().__init__()
        _prelus(self, 2)  # act1, act2
        self.fc1 = nn.Linear(ndim_in + 3, ndim_in)
        self.fc2 = nn.Linear(ndim_in, ndim_out)
        self.normalize = normalize
        if normalize:
            self.sum_gain = nn.Parameter(torch.tensor(8.0))

    def forward(self, x, edge_feat, mask, sta_mask):
        act1, act2 = self.acts
        ef = edge_feat.expand(*x.shape[:-1], edge_feat.shape[-1])
        msg = act1(self.fc1(torch.cat((x, ef), dim=-1)))
        gate = mask.amax(dim=-1, keepdim=True) * sta_mask[:, None].to(x.dtype)
        out = (msg * gate).sum(dim=-2)
        if self.normalize:
            out = out * self.sum_gain / torch.clamp_min(gate.sum(dim=-2), 1.0)
        return act2(self.fc2(out))


class SpatialAggregation(nn.Module):
    """k-NN conv over the source grid with a global context channel
    (``layers.py:163-184``). x (B, n_src, C)."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_rel: float = 30e3, n_global: int = 5, n_hidden: int = 30):
        super().__init__()
        self.scale_rel = scale_rel
        _prelus(self, 3)  # act1 (message), act2 (output), act3 (global)
        self.fglobal = nn.Linear(in_channels, n_global)
        self.fc1 = nn.Linear(in_channels + 3 + n_global, n_hidden)
        self.fc2 = nn.Linear(in_channels + n_hidden, out_channels)

    def forward(self, x, src_nbr, pos):
        act1, act2, act3 = self.acts
        nbr = src_nbr.long()
        p = pos / self.scale_rel
        x_j = x[:, nbr]                                    # (B, n_src, k, C)
        rel = (p[:, None, :] - p[nbr]).expand(*x_j.shape[:-1], 3)
        glob = act3(self.fglobal(x_j)).mean(dim=(1, 2))   # (B, n_global)
        glob = glob[:, None, None, :].expand(*x_j.shape[:-1], glob.shape[-1])
        msg = act1(self.fc1(torch.cat((x_j, rel, glob), dim=-1)))
        return act2(self.fc2(torch.cat((x, msg.mean(dim=2)), dim=-1)))


class SpatialDirect(nn.Module):
    """Per-node linear readout (``layers.py:187-194``)."""

    def __init__(self, in_channels: int = 30, out_channels: int = 30):
        super().__init__()
        _prelus(self, 1)
        self.f_direct = nn.Linear(in_channels, out_channels)

    def forward(self, x):
        return self.acts[0](self.f_direct(x))


def _batch_gather(x, idx):
    """x (B, n, C), idx (n_q, k) shared or (B, n_q, k) → (B, n_q, k, C)."""
    idx = idx.long()
    if idx.dim() == 2:
        return x[:, idx]
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


class SpatialAttention(nn.Module):
    """Multi-head k-NN cross-attention from the source grid to query
    coordinates (``layers.py:197-222``). ``ctx_idx`` (n_q, k) and
    ``query_pos`` (n_q, 3) are shared across windows, or carry a leading
    window axis."""

    def __init__(self, inpt_dim: int = 30, out_channels: int = 30,
                 n_latent: int = 15, n_heads: int = 5, scale_rel: float = 30e3):
        super().__init__()
        self.H, self.L, self.scale_rel = n_heads, n_latent, scale_rel
        _prelus(self, 2)  # act1, act2
        self.f_queries = nn.Linear(3, n_heads * n_latent)
        self.f_context = nn.Linear(inpt_dim + 3, n_heads * n_latent)
        self.f_values = nn.Linear(inpt_dim + 3, n_heads * n_latent)
        self.proj = nn.Linear(n_latent, out_channels)

    def forward(self, x_context, ctx_idx, ctx_pos, query_pos):
        act1, act2 = self.acts
        H, L = self.H, self.L
        x_j = _batch_gather(x_context, ctx_idx)            # (B, n_q, k, C)
        edge = (query_pos[..., None, :] - ctx_pos[ctx_idx.long()]) / self.scale_rel
        edge = edge.expand(*x_j.shape[:-1], 3)
        shp = (*x_j.shape[:-1], H, L)
        q = self.f_queries(edge).reshape(shp)
        xe = torch.cat((x_j, edge), dim=-1)
        c = self.f_context(xe).reshape(shp)
        v = self.f_values(xe).reshape(shp)
        alpha = act1((q * c).sum(-1) / math.sqrt(L))  # (B, n_q, k, H)
        alpha = torch.softmax(alpha, dim=-2)
        out = (alpha[..., None] * v).sum(dim=-3)           # (B, n_q, H, L)
        return act2(self.proj(out.mean(dim=-2)))


class TemporalAttention(nn.Module):
    """Multi-head attention of node features against query time offsets
    (``layers.py:225-248``). x (..., n, C), t_query (n_t, 1) → (..., n, n_t,
    out)."""

    def __init__(self, inpt_dim: int = 30, out_channels: int = 1,
                 n_latent: int = 15, n_heads: int = 5, n_hidden: int = 30,
                 scale_t: float = 9.0):
        super().__init__()
        self.H, self.L, self.scale_t = n_heads, n_latent, scale_t
        _prelus(self, 5)  # context, values, query, scores, projection
        self.f_context_1 = nn.Linear(inpt_dim, n_hidden)
        self.f_context_2 = nn.Linear(n_hidden, n_heads * n_latent)
        self.f_values_1 = nn.Linear(inpt_dim, n_hidden)
        self.f_values_2 = nn.Linear(n_hidden, n_heads * n_latent)
        self.temporal_query_1 = nn.Linear(1, n_hidden)
        self.temporal_query_2 = nn.Linear(n_hidden, n_heads * n_latent)
        self.proj_1 = nn.Linear(n_latent, n_hidden)
        self.proj_2 = nn.Linear(n_hidden, out_channels)

    def forward(self, x, t_query):
        act1, act2, act3, act4, act5 = self.acts
        H, L = self.H, self.L
        lead = x.shape[:-1]
        ctx = self.f_context_2(act1(self.f_context_1(x))).reshape(*lead, H, L)
        val = self.f_values_2(act2(self.f_values_1(x))).reshape(*lead, H, L)
        qry = self.temporal_query_2(act3(self.temporal_query_1(
            t_query / self.scale_t))).reshape(t_query.shape[0], H, L)
        scores = ((ctx[..., None, :, :] * qry).sum(-1, keepdim=True)
                  / math.sqrt(L))                          # (..., n, n_t, H, 1)
        out = act4((scores * val[..., None, :, :]).mean(dim=-2))
        return self.proj_2(act5(self.proj_1(out)))


class BipartiteReadOut(nn.Module):
    """Broadcast source embeddings back onto product nodes, gated by the
    detection mask (``layers.py:251-267``). src_feat (B, n_src, C), mask_out
    (B, n_src, 1) → ((B, n_src, n_sta, out), (B, n_src, n_sta, 1))."""

    def __init__(self, ndim_in: int = 30, ndim_out: int = 15):
        super().__init__()
        _prelus(self, 2)  # act1, act2
        self.fc1 = nn.Linear(ndim_in + 3, ndim_in)
        self.fc2 = nn.Linear(ndim_in, ndim_out)

    def forward(self, src_feat, edge_feat, mask_out):
        act1, act2 = self.acts
        B, n_src, C = src_feat.shape
        n_sta = edge_feat.shape[1]
        x_j = src_feat[:, :, None, :].expand(B, n_src, n_sta, C)
        ef = edge_feat.expand(B, n_src, n_sta, edge_feat.shape[-1])
        msg = mask_out[:, :, None, :] * act1(self.fc1(torch.cat((x_j, ef), -1)))
        out = act2(self.fc2(msg))
        return out, mask_out[:, :, None, :].expand(B, n_src, n_sta, 1)


class DataAggregationAssociationPhase(nn.Module):
    """Second dual-relation conv for the association stage
    (``layers.py:270-321``): the first-round inputs pass through their
    ``l1_*_1`` linears. ``use_edges`` as in :class:`DataAggregation`."""

    def __init__(self, in_channels: int = 15, out_channels: int = 15,
                 n_hidden: int = 30, n_latent: int = 30, n_mask: int = 5,
                 use_edges: bool = False):
        super().__init__()
        h = n_hidden
        n_e = 4 if use_edges else 0
        _prelus(self, 7)  # act, act11, act12, act1, act21, act22, act2
        self.init_trns = nn.Linear(in_channels + n_latent + n_mask, h)
        self.l1_t1_1 = nn.Linear(h, h)
        self.l1_t2_1 = nn.Linear(h, h)
        self.l1_t1_2 = nn.Linear(2 * h + n_e + n_mask, h)
        self.l1_t2_2 = nn.Linear(2 * h + n_e + n_mask, h)
        self.l2_t1_1 = nn.Linear(2 * h, h)
        self.l2_t2_1 = nn.Linear(2 * h, h)
        self.l2_t1_2 = nn.Linear(3 * h + n_e + n_mask, out_channels)
        self.l2_t2_2 = nn.Linear(3 * h + n_e + n_mask, out_channels)

    def forward(self, tr, latent, mask1, mask2, tables: ProductTables):
        act, act11, act12, act1, act21, act22, act2 = self.acts
        mask = torch.cat((mask1, mask2), dim=-1)
        tr = act(self.init_trns(torch.cat((tr, latent, mask), dim=-1)))
        tr = tr.contiguous()
        for (t1_1, t2_1, t1_2, t2_2, a_sta, a_src, a_out) in (
                (self.l1_t1_1, self.l1_t2_1, self.l1_t1_2, self.l1_t2_2,
                 act11, act12, act1),
                (self.l2_t1_1, self.l2_t2_1, self.l2_t1_2, self.l2_t2_2,
                 act21, act22, act2)):
            z = t1_1(tr).contiguous()
            agg_src = src_mean(a_src(t2_1(tr)), tables)
            tr = fused_round_plain(tr, z, agg_src, mask, tables.sta_nbr, tables.sta_w,
                                  t1_2.weight, t1_2.bias, t2_2.weight, t2_2.bias,
                                  _slopes(a_sta, a_out), tables.e_sta, tables.e_src)
        return tr


class LocalSliceCollapse(nn.Module):
    """Per-pick embedding from the k product nodes whose theoretical arrival
    is nearest the pick time (``layers.py:324-362``). Picks carry a leading
    window axis; ``s`` is (B, n_src, n_sta, C)."""

    def __init__(self, ndim_in: int = 30, ndim_out: int = 15, n_hidden: int = 30,
                 eps: float = 15.0, use_phase_types: bool = True):
        super().__init__()
        self.eps = eps
        self.use_phase_types = use_phase_types
        _prelus(self, 2)  # act1, act2
        self.fc1 = nn.Linear(ndim_in + 2, n_hidden)
        self.fc2 = nn.Linear(n_hidden, ndim_out)

    def forward(self, time_ptr, dt0, dt, tpick, ipick, phase_label, s,
                trv_phase, pick_mask):
        act1, act2 = self.acts
        n_dt = time_ptr.shape[1]
        if not self.use_phase_types:
            phase_label = phase_label * 0.0
        ip = ipick.long()
        t_index = torch.clamp(torch.floor((tpick - dt0) / dt).to(torch.int32),
                              0, n_dt - 1).long()
        src_idx = time_ptr[ip, t_index].long()             # (B, n_pick, k)
        b = torch.arange(s.shape[0], device=s.device)[:, None, None]
        x_j = s[b, src_idx, ip[..., None]]                 # (B, n_pick, k, C)
        t_theory = trv_phase[src_idx, ip[..., None]]       # (B, n_pick, k)
        t_rel = tpick[..., None] - t_theory
        keep = (t_rel.abs() < 2.0 * self.eps) & pick_mask[..., None]
        phase = phase_label[:, :, None, :].expand(*x_j.shape[:-1], 1)
        msg = act1(self.fc1(torch.cat(
            (x_j, (t_rel / self.eps)[..., None], phase), dim=-1)))
        msg = msg * keep[..., None]
        cnt = torch.clamp_min(keep.sum(dim=2, keepdim=True), 1)
        return act2(self.fc2(msg.sum(dim=2) / cnt))


class _AssocChunk(nn.Module):
    """Parameters and body of one query-source chunk of the association
    attention (``layers.py:365-426``)."""

    def __init__(self, ndim_arv_in: int = 15, ndim_src_in: int = 30,
                 ndim_out: int = 2, n_latent: int = 15, n_heads: int = 3,
                 n_hidden: int = 30, eps: float = 15.0):
        super().__init__()
        self.H, self.L, self.eps = n_heads, n_latent, eps
        _prelus(self, 4)  # context, query, values, projection
        self.f_arrival_query_1 = nn.Linear(2 * ndim_arv_in + 6, n_hidden)
        self.f_arrival_query_2 = nn.Linear(n_hidden, n_heads * n_latent)
        self.f_src_context_1 = nn.Linear(ndim_src_in + 3, n_hidden)
        self.f_src_context_2 = nn.Linear(n_hidden, n_heads * n_latent)
        self.f_values_1 = nn.Linear(2 * ndim_arv_in + 8, n_hidden)
        self.f_values_2 = nn.Linear(n_hidden, n_heads * n_latent)
        self.proj_1 = nn.Linear(n_latent, n_hidden)
        self.proj_2 = nn.Linear(n_hidden, ndim_out)

    def forward(self, st, semb, trv_q, shared):
        """st (B, c); semb (B, c, C_src); trv_q (B, c, n_sta, 2) →
        (B, c, n_pick, ndim_out)."""
        act1, act2, act3, act4 = self.acts
        x_j, phase_j, at_j, sta_j, self_link, null_link, is_null, pair_valid = shared
        H, L, eps = self.H, self.L, self.eps
        B, n_pick, kp = at_j.shape
        c = st.shape[1]
        sta_flat = sta_j.reshape(B, 1, -1).expand(B, c, -1)

        def tsrc(ph):
            t = torch.gather(trv_q[..., ph], 2, sta_flat).reshape(B, c, n_pick, kp)
            return torch.where(is_null[:, None], torch.full_like(t, -eps), t)

        rel_p = at_j[:, None] - (tsrc(0) + st[:, :, None, None])
        rel_s = at_j[:, None] - (tsrc(1) + st[:, :, None, None])
        keep = (rel_p.abs() < 2.0 * eps) | (rel_s.abs() < 2.0 * eps)
        keep = keep & pair_valid[:, None]
        shp = (B, c, n_pick, kp)
        ph = phase_j[:, None].expand(*shp, 1)

        def feat(rel):
            return torch.cat((torch.exp(-0.5 * rel[..., None] ** 2 / eps**2),
                              torch.sign(rel)[..., None], ph), dim=-1)

        fp, fs = feat(rel_p), feat(rel_s)
        x_jb = x_j[:, None].expand(*shp, x_j.shape[-1])
        sl = self_link[:, None].expand(*shp, 1)
        nl = null_link[:, None].expand(*shp, 1)
        q = self.f_arrival_query_2(act2(self.f_arrival_query_1(
            torch.cat((x_jb, fp, fs), dim=-1)))).reshape(*shp, H, L)
        ctx_in = torch.cat((semb[:, :, None, None, :].expand(*shp, semb.shape[-1]),
                            st[:, :, None, None, None].expand(*shp, 1), sl, nl),
                           dim=-1)
        ctx = self.f_src_context_2(act1(self.f_src_context_1(ctx_in)))
        ctx = ctx.reshape(*shp, H, L)
        v = self.f_values_2(act3(self.f_values_1(
            torch.cat((x_jb, fp, fs, sl, nl), dim=-1)))).reshape(*shp, H, L)
        scores = (q * ctx).sum(-1) / math.sqrt(L)          # (B, c, n_pick, kp, H)
        scores = scores.masked_fill(~keep[..., None], float("-inf"))
        alpha = torch.softmax(scores, dim=3)
        alpha = torch.where(torch.isfinite(alpha), alpha, torch.zeros_like(alpha))
        agg = (alpha[..., None] * v).sum(dim=3).mean(dim=3)  # (B, c, n_pick, L)
        return self.proj_2(act4(self.proj_1(agg)))


class StationSourceAttention(nn.Module):
    """Final association head (``layers.py:429-507``): for each (query
    source, pick), attention over the pick's co-station picks plus a null
    sink, scoring P/S membership. Query sources run in ``src_chunk``-sized
    chunks (a Python loop over one shared parameter set, the JAX
    ``nn.scan``); the last chunk is not padded."""

    def __init__(self, ndim_src_in: int = 30, ndim_arv_in: int = 15,
                 ndim_out: int = 2, n_latent: int = 15, n_heads: int = 3,
                 n_hidden: int = 30, eps: float = 15.0,
                 use_phase_types: bool = True, src_chunk: int = 16):
        super().__init__()
        self.eps = eps
        self.use_phase_types = use_phase_types
        self.src_chunk = src_chunk
        self.chunks = _AssocChunk(ndim_arv_in, ndim_src_in, ndim_out, n_latent,
                                  n_heads, n_hidden, eps)

    def forward(self, stime, src_embed, trv_src, arv_p, arv_s, tpick, ipick,
                phase_label, pair_idx, pair_valid, pick_mask):
        """stime (B, n_qsrc); src_embed (B, n_qsrc, C); trv_src (B, n_qsrc,
        n_sta, 2); arv_p/arv_s (B, n_pick, C_arv); pick arrays (B, n_pick);
        pair_idx (B, n_pick, Kp) with value n_pick = null. Returns
        (B, n_qsrc, n_pick, 2)."""
        B, n_pick = tpick.shape
        eps = self.eps
        if not self.use_phase_types:
            phase_label = phase_label * 0.0
        arrival = torch.cat((arv_p, arv_s), dim=-1)
        arrival = torch.cat((arrival, arrival.new_zeros(B, 1, arrival.shape[-1])), 1)
        atime = torch.cat((tpick, tpick.new_full((B, 1), -eps)), dim=1)
        phase_aug = torch.cat((phase_label, phase_label.new_full((B, 1, 1), -1.0)), 1)
        ipick_aug = torch.cat((ipick.long(), ipick.new_zeros(B, 1).long()), dim=1)

        j_idx = pair_idx.long()                            # (B, n_pick, Kp)
        is_null = j_idx == n_pick
        b = torch.arange(B, device=tpick.device)[:, None, None]
        x_j = arrival[b, j_idx]
        phase_j = phase_aug[b, j_idx]
        at_j = atime[b, j_idx]
        sta_j = torch.where(is_null, torch.zeros_like(j_idx), ipick_aug[b, j_idx])
        self_link = (j_idx == torch.arange(n_pick, device=tpick.device)[:, None]
                     ).to(tpick.dtype)[..., None]
        null_link = is_null.to(tpick.dtype)[..., None]
        shared = (x_j, phase_j, at_j, sta_j, self_link, null_link, is_null,
                  pair_valid)
        outs = []
        for s in range(0, stime.shape[1], self.src_chunk):
            e = s + self.src_chunk
            outs.append(self.chunks(stime[:, s:e], src_embed[:, s:e],
                                    trv_src[:, s:e], shared))
        return torch.cat(outs, dim=1)


class GraphBundle(NamedTuple):
    """Fixed-k gather tables of one domain (shared by every window)."""

    sta_nbr: torch.Tensor        # (n_sta, k_sta) int32 station kNN
    sta_nbr_valid: torch.Tensor  # (n_sta, k_sta) bool
    src_nbr: torch.Tensor        # (n_src, k_spc) int32 source-grid kNN
    sta_mask: torch.Tensor       # (n_sta,) bool
    edge_feat: torch.Tensor      # (n_src, n_sta, 3)
    src_pos: torch.Tensor        # (n_src, 3) grid Cartesian (m)
    time_ptr_p: torch.Tensor     # (n_sta, n_dt, k_time) int32 source indices
    time_ptr_s: torch.Tensor
    dt0: torch.Tensor            # scalar f32
    dt: torch.Tensor             # scalar f32
    trv: torch.Tensor            # (n_src, n_sta, 2)


class PickSet(NamedTuple):
    """Padded pick windows, each array with a leading window axis."""

    tpick: torch.Tensor       # (B, n_pick) times relative to window t0
    ipick: torch.Tensor       # (B, n_pick) station index
    phase: torch.Tensor       # (B, n_pick, 1) float phase label (0=P, 1=S)
    mask: torch.Tensor        # (B, n_pick) bool
    pair_idx: torch.Tensor    # (B, n_pick, k_pair+1); == n_pick → null
    pair_valid: torch.Tensor  # (B, n_pick, k_pair+1) bool


class QuerySet(NamedTuple):
    x_query: torch.Tensor       # (n_q, 3) or (B, n_q, 3) detection queries
    x_query_idx: torch.Tensor   # (n_q, k_attn) or (B, n_q, k_attn)
    t_query: torch.Tensor       # (n_t, 1) time offsets
    x_qsrc: torch.Tensor        # (B, n_qsrc, 3) association queries
    x_qsrc_idx: torch.Tensor    # (B, n_qsrc, k_attn)
    tq_sample: torch.Tensor     # (B, n_qsrc) association query origin times
    trv_qsrc: torch.Tensor      # (B, n_qsrc, n_sta, 2)


def product_tables(graph: GraphBundle, sta_pos=None,
                   scale_rel: float = 30e3, src_agg=None) -> ProductTables:
    """The station (nbr, valid/deg) table and the dense source-kNN mean, or,
    with a ``src_agg`` hook (the sharded trunks), the hook in its place and
    no dense matrix (at 100k sources it alone would take 40 GB); with
    ``sta_pos`` (the updated model definition) also the edge tables
    ``e_sta`` (stations, over ``sta_nbr_valid``) and ``e_src`` (the grid's
    ``src_pos``) of :func:`mean_rel_pos_embed` (JAX ``_rel_tables``,
    ``detector.py:140-150``)."""
    e_sta = e_src = None
    if sta_pos is not None:
        e_sta = mean_rel_pos_embed(sta_pos, graph.sta_nbr, scale_rel,
                                   graph.sta_nbr_valid).contiguous()
        e_src = mean_rel_pos_embed(graph.src_pos, graph.src_nbr, scale_rel).contiguous()
    return ProductTables(
        sta_nbr=graph.sta_nbr.to(torch.int32).contiguous(),
        sta_w=aggregation_weights(graph.sta_nbr, graph.sta_nbr_valid).contiguous(),
        a_src=(None if src_agg is not None else
               aggregation_matrix(graph.src_nbr, graph.src_nbr.shape[0])),
        e_sta=e_sta, e_src=e_src, src_agg=src_agg)


class Detector(nn.Module):
    """Flagship model; channel widths as the JAX ``Detector`` (4→15/30
    hidden, 30 latent; with ``use_absolute_pos`` the trunk takes 4 + 6 input
    channels and the association conv 15 + 6). The forward methods keep the
    JAX signatures; ``sta_pos`` (the station Cartesian positions) is read by
    ``use_absolute_pos`` and the updated model definition."""

    def __init__(self, scale_rel: float = 30e3, kernel_sig_t: float = 3.0,
                 use_phase_types: bool = True, use_absolute_pos: bool = False,
                 src_chunk: int = 16, mask_p_thresh: float = 0.01,
                 use_updated_model_definition: bool = False,
                 normalize_readin: bool = False):
        super().__init__()
        self.scale_rel = scale_rel
        self.use_absolute_pos = use_absolute_pos
        self.use_edges = use_updated_model_definition
        self.mask_p_thresh = mask_p_thresh
        eps = 5.0 * kernel_sig_t
        n_abs = 6 if use_absolute_pos else 0
        self.data_agg = DataAggregation(in_channels=4 + n_abs, out_channels=15,
                                        use_edges=self.use_edges)
        self.read_in = BipartiteReadIn(30, 15, normalize=normalize_readin)
        self.spatial1 = SpatialAggregation(15, 30, scale_rel=scale_rel)
        self.spatial2 = SpatialAggregation(30, 30, scale_rel=scale_rel)
        self.spatial3 = SpatialAggregation(30, 30, scale_rel=scale_rel)
        self.spatial_direct = SpatialDirect(30, 30)
        self.spatial_attn = SpatialAttention(30, 30, n_latent=15, n_heads=5,
                                             scale_rel=scale_rel)
        self.temporal_attn = TemporalAttention(30, 1, n_latent=15, n_heads=5,
                                               scale_t=3.0 * kernel_sig_t)
        self.read_out = BipartiteReadOut(30, 15)
        self.assoc_agg = DataAggregationAssociationPhase(15 + n_abs, 15,
                                                         use_edges=self.use_edges)
        self.slice_p = LocalSliceCollapse(30, 15, eps=eps,
                                          use_phase_types=use_phase_types)
        self.slice_s = LocalSliceCollapse(30, 15, eps=eps,
                                          use_phase_types=use_phase_types)
        self.arrivals = StationSourceAttention(
            30, 15, 2, n_latent=15, n_heads=3, eps=eps,
            use_phase_types=use_phase_types, src_chunk=src_chunk)

    def _tables(self, graph: GraphBundle, sta_pos) -> ProductTables:
        return product_tables(graph, sta_pos if self.use_edges else None,
                              self.scale_rel)

    def _with_abs_pos(self, x, graph: GraphBundle, sta_pos):
        """``use_absolute_pos``: append station and source positions over
        3·scale_rel to a (B, n_src, n_sta, C) product tensor (JAX
        ``detector.py:157-161, 196-200``)."""
        if not self.use_absolute_pos:
            return x
        shp = (*x.shape[:-1], 3)
        sta_b = (sta_pos / (3.0 * self.scale_rel)).expand(shp)
        src_b = (graph.src_pos[:, None, :] / (3.0 * self.scale_rel)).expand(shp)
        return torch.cat((x, sta_b, src_b), dim=-1)

    def _trunk_product(self, feat, mask, graph: GraphBundle, tables, sta_pos):
        feat = self._with_abs_pos(feat, graph, sta_pos)
        x_latent = self.data_agg(feat, mask, tables)
        x = self.read_in(x_latent, graph.edge_feat, mask, graph.sta_mask)
        return x_latent, x

    def _trunk_nodes(self, x, graph: GraphBundle):
        x = self.spatial1(x, graph.src_nbr, graph.src_pos)
        x = self.spatial2(x, graph.src_nbr, graph.src_pos)
        x_spatial = self.spatial3(x, graph.src_nbr, graph.src_pos)
        return x_spatial, self.spatial_direct(x_spatial)

    def _detection_trunk(self, feat, mask, graph: GraphBundle, tables, sta_pos):
        x_latent, x = self._trunk_product(feat, mask, graph, tables, sta_pos)
        x_spatial, y_latent = self._trunk_nodes(x, graph)
        return x_latent, x_spatial, y_latent

    def forward(self, feat, mask, graph: GraphBundle, sta_pos, picks: PickSet,
                queries: QuerySet):
        """Full forward. Returns (y, x, arv_p, arv_s): y (B, n_src, n_t, 1)
        grid detection; x (B, n_q, n_t, 1) query detection; arv_p/arv_s
        (B, n_qsrc, n_pick, 1) association scores."""
        tables = self._tables(graph, sta_pos)
        x_latent, x_spatial, y_latent = self._detection_trunk(
            feat, mask, graph, tables, sta_pos)
        y = self.temporal_attn(y_latent, queries.t_query)
        x_q = self.spatial_attn(x_spatial, queries.x_query_idx, graph.src_pos,
                                queries.x_query)
        x_src = self.spatial_attn(x_spatial, queries.x_qsrc_idx, graph.src_pos,
                                  queries.x_qsrc)
        x_q = self.temporal_attn(x_q, queries.t_query)

        mask_out = (y[..., 0].detach().amax(dim=2, keepdim=True)
                    > self.mask_p_thresh).to(feat.dtype)   # (B, n_src, 1)
        s, mask_out_prod = self.read_out(y_latent, graph.edge_feat, mask_out)
        s = self._with_abs_pos(s, graph, sta_pos)
        s = self.assoc_agg(s, x_latent.detach(), mask_out_prod, mask, tables)
        arv_p = self.slice_p(graph.time_ptr_p, graph.dt0, graph.dt, picks.tpick,
                             picks.ipick, picks.phase, s, graph.trv[..., 0],
                             picks.mask)
        arv_s = self.slice_s(graph.time_ptr_s, graph.dt0, graph.dt, picks.tpick,
                             picks.ipick, picks.phase, s, graph.trv[..., 1],
                             picks.mask)
        arv = self.arrivals(queries.tq_sample, x_src, queries.trv_qsrc, arv_p,
                            arv_s, picks.tpick, picks.ipick, picks.phase,
                            picks.pair_idx, picks.pair_valid, picks.mask)
        return y, x_q, arv[..., 0:1], arv[..., 1:2]

    def _detection_heads(self, x_spatial, y_latent, graph: GraphBundle,
                         x_query, x_query_idx, t_query):
        """Grid and query detection from the node stage: (y, x_q)."""
        y = self.temporal_attn(y_latent, t_query)
        x_q = self.spatial_attn(x_spatial, x_query_idx, graph.src_pos, x_query)
        return y, self.temporal_attn(x_q, t_query)

    def forward_detection_only(self, feat, mask, graph: GraphBundle, sta_pos,
                               x_query, x_query_idx, t_query):
        """Detection sweep without the association head (the reference's
        ``forward_fixed_source``). Returns (y, x_q)."""
        _, x_spatial, y_latent = self._detection_trunk(
            feat, mask, graph, self._tables(graph, sta_pos), sta_pos)
        return self._detection_heads(x_spatial, y_latent, graph, x_query,
                                     x_query_idx, t_query)

    def forward_trunk(self, feat, mask, graph: GraphBundle, sta_pos):
        """Product trunk only: (x_spatial, y_latent), each (B, n_src, 30)."""
        _, x_spatial, y_latent = self._detection_trunk(
            feat, mask, graph, self._tables(graph, sta_pos), sta_pos)
        return x_spatial, y_latent

    def forward_query_head(self, x_spatial, graph: GraphBundle, x_query,
                           x_query_idx, t_query):
        """Query detection head on a precomputed trunk."""
        x_q = self.spatial_attn(x_spatial, x_query_idx, graph.src_pos, x_query)
        return self.temporal_attn(x_q, t_query)
