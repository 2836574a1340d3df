"""Layers of the detection/association GNN on the dense product layout.

Port of ``genie_tpu/models/layers.py``. Product-graph features are dense
``(B, n_src, n_sta, C)`` tensors: the leading window axis ``B`` takes the
place of the JAX package's ``vmap``, and the graph tables are shared across
it. Node tensors are ``(B, n_src, C)``. Every ``Dense`` is an ``nn.Linear``
and every PReLU keeps its flax creation-order name (``PReLU_0`` …), so a
flax checkpoint loads by name (``genie_tpu_torch/params.py``).

The four dual-relation rounds (two in :class:`DataAggregation`, two in
:class:`DataAggregationAssociationPhase`) each call the fused-round kernel
(``ops/fused_round.py``) through ``FusedRound``, which gives it a gradient
for training. The station mean runs inside it over the
``(sta_nbr, sta_w)`` table; the source-axis mean ``A_src @ x`` stays a
``torch.matmul`` (plain XLA in the JAX package), or is the hook
``ProductTables.src_agg`` (the JAX ``src_agg``), through which the sharded
trunks of ``parallel/sharded_detector.py`` take it over the halo exchange
while the kernel runs on each rank's rows. With ``use_edges`` (the
updated model definition) the kernel takes the per-station and per-source
relative-position tables of :func:`mean_rel_pos_embed` as its edge form.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from genie_tpu_torch.ops.fused_round import FusedRound, prelu
from genie_tpu_torch.ops.segment import matmul_mean_src_axis


class PReLU(nn.Module):
    """torch-style PReLU: one learnable slope ``a``, init 0.25, with JAX's
    derivative at x = 0 (``ops.fused_round.prelu``)."""

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
        tr = FusedRound.apply(tr, tr, agg_src, mask, tables.sta_nbr, tables.sta_w,
                              self.l1_t1_2.weight, self.l1_t1_2.bias,
                              self.l1_t2_2.weight, self.l1_t2_2.bias,
                              _slopes(act11, act1), tables.e_sta, tables.e_src)
        # round 2: Dense before each PReLU, applied first as a plain linear
        z = self.l2_t1_1(tr).contiguous()
        agg_src = src_mean(act22(self.l2_t2_1(tr)), tables)
        return FusedRound.apply(tr, z, agg_src, mask, tables.sta_nbr, tables.sta_w,
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
            tr = FusedRound.apply(tr, z, agg_src, mask, tables.sta_nbr, tables.sta_w,
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
