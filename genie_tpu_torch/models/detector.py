"""The full detection + association GNN.

Port of ``genie_tpu/models/detector.py``: DataAggregation → BipartiteReadIn
→ SpatialAggregation×3 → {SpatialDirect→TemporalAttention (grid detection),
SpatialAttention→TemporalAttention (query detection)} → masked
BipartiteReadOut → DataAggregationAssociationPhase → LocalSliceCollapse (P,
S) → StationSourceAttention → per-pick P/S association scores.

Inputs carry a leading window axis ``B`` (the JAX package ``vmap``s over
windows); the :class:`GraphBundle` tables are shared across it. The pick and
query sets carry ``B`` too, except detection query positions and their
attachment tables, which may be shared. The options of the JAX ``Detector``
(``detector.py:84-101``) are carried: ``use_updated_model_definition``
(edge-featured dual-relation rounds), ``use_absolute_pos`` (station and
source positions as six more input channels of the trunk and of the
association conv) and ``normalize_readin`` (the read-in's ``sum_gain``); the
edge and position tables are shared across windows as well.

The product stage (:meth:`Detector._trunk_product`) runs on any
:class:`GraphBundle` whose product-sized fields (``edge_feat``, ``src_pos``,
``sta_mask``, the station tables) describe the rows it is given, with the
source-axis mean taken by ``ProductTables.src_agg`` where set: the sharded
trunks of ``parallel/sharded_detector.py`` run it on one rank's rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from genie_tpu_torch.models.layers import (
    BipartiteReadIn,
    BipartiteReadOut,
    DataAggregation,
    DataAggregationAssociationPhase,
    LocalSliceCollapse,
    ProductTables,
    SpatialAggregation,
    SpatialAttention,
    SpatialDirect,
    StationSourceAttention,
    TemporalAttention,
    mean_rel_pos_embed,
)
from genie_tpu_torch.ops.segment import aggregation_matrix, aggregation_weights


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
