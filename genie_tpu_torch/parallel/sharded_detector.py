"""Detector forward with a source-partitioned product tensor.

Port of ``genie_tpu/parallel/sharded_detector.py``. At about 1,000 stations
× 100k-1M source nodes the (B, n_src, n_sta, C) product tensor no longer fits
one device. Each rank of a :class:`~genie_tpu_torch.parallel.mesh.Mesh` runs
the detector's product stage (``Detector._trunk_product``: the
dual-relation rounds and the station read-in, which hold the memory and the
operations) on its block of sources in the Morton order of
:mod:`.product_shard`:

* the station-axis means run inside the fused-round kernel, over this
  rank's ``B · n_local`` rows, as on one device;
* the source-axis means ride the halo exchange (``ProductTables.src_agg``);
* ``all_gather`` collects the (B, n_local, C) node latents, which are put
  back in the original order; the node stage and the detection heads,
  (B, n_src, C) only, then run on every rank, which all return the same
  ``(y, x_q)``.

The module and its weights are the dense detector's, so dense-trained
weights (``params.load_into`` of a flax tree) run sharded unchanged. The
forwards are inference only, run under ``torch.no_grad()``, as in the JAX
package. They take the full (B, n_src, n_sta, ·) window tensors in the
original source order on every rank and cut out this rank's rows.
"""

from __future__ import annotations

import torch

from genie_tpu_torch.models.detector import Detector, GraphBundle, product_tables
from genie_tpu_torch.models.layers import ProductTables, mean_rel_pos_embed
from genie_tpu_torch.ops.segment import aggregation_weights
from genie_tpu_torch.parallel.mesh import Mesh, all_gather_cat
from genie_tpu_torch.parallel.product_shard import (
    build_partition,
    build_station_subselection,
    sharded_gather_mean_src_axis,
    sharded_gather_mean_src_axis_subsel,
)


def pad_to_shards(n_src: int, n_shards: int) -> int:
    """Source-grid size padded so that the partition divides evenly."""
    return int(-(-n_src // n_shards) * n_shards)


def _node_stage(model: Detector, x_l, graph: GraphBundle, inv_perm, mesh: Mesh,
                x_query, x_query_idx, t_query):
    """Gather every rank's (B, n_local, C) node latents, restore the
    original source order, run the node stage and the detection heads."""
    x = all_gather_cat(x_l, mesh, dim=-2).index_select(-2, inv_perm)
    x_spatial, y_latent = model._trunk_nodes(x, graph)
    return model._detection_heads(x_spatial, y_latent, graph, x_query,
                                  x_query_idx, t_query)


def make_sharded_detection_forward(model: Detector, graph: GraphBundle, sta_pos,
                                   mesh: Mesh, wire_dtype=None):
    """``fn(feat, mask, x_query, x_query_idx, t_query) -> (y, x_q)``, equal to
    ``model.forward_detection_only(feat, mask, graph, sta_pos, …)`` with the
    product stage sharded over ``mesh``. The halo plan is built once here,
    on the host; n_src must divide by the group size (:func:`pad_to_shards`).
    ``wire_dtype`` (e.g. ``torch.bfloat16``) is the halo rows' type on the
    wire. ``graph`` and ``sta_pos`` lie on ``mesh.device``. Returns ``(fn,
    part)``."""
    dev = mesh.device
    part = build_partition(graph.src_pos, graph.src_nbr, mesh.size).to(dev)
    rows = part.local_rows(mesh.rank).long()
    inv_perm = part.inv_perm.long()

    def src_agg(x):
        return sharded_gather_mean_src_axis(x, part, mesh, wire_dtype=wire_dtype)

    tables = product_tables(graph, sta_pos if model.use_edges else None,
                            model.scale_rel, src_agg=src_agg)
    if tables.e_src is not None:   # per-source edge table: this rank's rows
        tables = tables._replace(e_src=tables.e_src[rows].contiguous())
    g_l = graph._replace(edge_feat=graph.edge_feat[rows], src_pos=graph.src_pos[rows])

    @torch.no_grad()
    def forward(feat, mask, x_query, x_query_idx, t_query):
        _, x_l = model._trunk_product(feat[..., rows, :, :], mask[..., rows, :, :],
                                      g_l, tables, sta_pos)
        return _node_stage(model, x_l, graph, inv_perm, mesh, x_query,
                           x_query_idx, t_query)

    return forward, part


def make_subgraph_sharded_detection_forward(model: Detector, graph: GraphBundle,
                                            sta_pos, mesh: Mesh, a_src_in_sta):
    """The sharded forward with per-rank station sub-selection (the
    distributed subgraph; the reference's ``use_subgraph``): each rank keeps
    only the stations its sources pair with under ``a_src_in_sta`` (the
    (n_src, n_sta) ε+kNN pair mask of ``graphs.subgraph.pair_mask``), so its
    product tensor is (B, n_local, n_sel + 1, C) instead of (B, n_local,
    n_sta, C); the last station is a zero sentinel. Halo rows are remapped
    between the ranks' station frames by the plan's column maps.

    With an all-True mask this is the dense forward; with a real mask it is
    the reference's true-subgraph semantics (absent pairs contribute
    nothing). Needs ``use_absolute_pos=False``: the position channels would
    bring the absent pairs back. Returns ``(fn, part, sub)``."""
    if model.use_absolute_pos:
        raise ValueError("subgraph sharding needs use_absolute_pos=False "
                         "(absolute-position channels would re-materialize "
                         "absent pairs)")
    dev = mesh.device
    r = mesh.rank
    part = build_partition(graph.src_pos, graph.src_nbr, mesh.size)
    sub = build_station_subselection(a_src_in_sta, part, graph.sta_nbr,
                                     graph.sta_nbr_valid)
    part = part.to(dev)
    rows = part.local_rows(r).long()
    inv_perm = part.inv_perm.long()
    sel = sub.sta_sel[r].to(dev, torch.long)
    sel_valid = sub.sel_valid[r].to(dev)

    def sel_rows(x):
        """(n_sta, …) → (n_sel + 1, …): this rank's stations, zero sentinel."""
        g = x.index_select(0, sel) * sel_valid.reshape(-1, *[1] * (x.dim() - 1)).to(x.dtype)
        return torch.cat((g, g.new_zeros((1, *g.shape[1:]))), dim=0)

    def sel_cols(x):
        """(…, n_sta, C) → (…, n_sel + 1, C)."""
        g = x.index_select(-2, sel) * sel_valid[:, None].to(x.dtype)
        return torch.cat((g, g.new_zeros((*g.shape[:-2], 1, g.shape[-1]))), dim=-2)

    sta_nbr_l = sub.sta_nbr[r].to(dev)
    sta_nbr_valid_l = sub.sta_nbr_valid[r].to(dev)
    sta_mask_l = torch.cat((graph.sta_mask.index_select(0, sel) & sel_valid,
                            sel_valid.new_zeros(1)))
    g_l = graph._replace(edge_feat=sel_cols(graph.edge_feat[rows]),
                         src_pos=graph.src_pos[rows], sta_nbr=sta_nbr_l,
                         sta_nbr_valid=sta_nbr_valid_l, sta_mask=sta_mask_l)
    col_map = sub.col_map[r].to(dev)
    keep = torch.ones(sub.n_sel + 1, 1, device=dev)
    keep[-1] = 0.0

    def src_agg(x):
        # zero the sentinel column so that absent stations contribute nothing
        return sharded_gather_mean_src_axis_subsel(x * keep, part, col_map, mesh)

    e_sta = e_src = None
    if model.use_edges:
        e_sta = sel_rows(mean_rel_pos_embed(sta_pos, graph.sta_nbr, model.scale_rel,
                                            graph.sta_nbr_valid)).contiguous()
        e_src = mean_rel_pos_embed(graph.src_pos, graph.src_nbr,
                                   model.scale_rel)[rows].contiguous()
    tables = ProductTables(
        sta_nbr=sta_nbr_l.to(torch.int32).contiguous(),
        sta_w=aggregation_weights(sta_nbr_l, sta_nbr_valid_l).contiguous(),
        a_src=None, e_sta=e_sta, e_src=e_src, src_agg=src_agg)
    sta_pos_l = sel_rows(sta_pos)

    @torch.no_grad()
    def forward(feat, mask, x_query, x_query_idx, t_query):
        _, x_l = model._trunk_product(sel_cols(feat[..., rows, :, :]),
                                      sel_cols(mask[..., rows, :, :]),
                                      g_l, tables, sta_pos_l)
        return _node_stage(model, x_l, graph, inv_perm, mesh, x_query,
                           x_query_idx, t_query)

    return forward, part, sub
