"""Per-project domain tables shared by training and inference.

Port of ``DomainContext`` and ``build_domain_context`` from
``genie_tpu/train/trainer.py:38-115``; the training loop itself is not
ported yet. Tables are built once per project, as torch tensors on the
pipeline's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genie_tpu_torch.config import Config
from genie_tpu_torch.graphs.build import (
    build_edge_feat,
    build_source_graph,
    build_time_pointers,
)


class DomainContext(NamedTuple):
    """Static per-project tensors (one device)."""

    sta_cart: torch.Tensor      # (n_sta, 3)
    sta_lla: torch.Tensor       # (n_sta, 3)
    grids_cart: torch.Tensor    # (n_grids, n_src, 3)
    grids_lla: torch.Tensor     # (n_grids, n_src, 3)
    trv_grids: torch.Tensor     # (n_grids, n_src, n_sta, 2)
    time_ptr_p: torch.Tensor    # (n_grids, n_sta, n_dt, k_time) int32
    time_ptr_s: torch.Tensor
    dt0: float
    dt: float
    edge_feat: torch.Tensor     # (n_grids, n_src, n_sta, 3)
    src_nbr: torch.Tensor       # (n_grids, n_src, k_spc) int32
    scale_cart: torch.Tensor    # (3,) cart sampling box scale
    offset_cart: torch.Tensor   # (3,) cart sampling box offset


def build_domain_context(cfg: Config, sta_lla, sta_cart, grids_lla, grids_cart,
                         trv_grids, device) -> DomainContext:
    """kNN graphs, time pointers and bipartite edge features of every grid,
    on ``device`` (inputs are numpy arrays or tensors)."""
    device = torch.device(device)

    def dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.array(a, np.float32), device=device)

    sta_cart, sta_lla = dev(sta_cart), dev(sta_lla)
    grids_cart, grids_lla, trv_grids = dev(grids_cart), dev(grids_lla), dev(trv_grids)
    max_t = float(trv_grids.max())
    scale, _ = cfg.region.scale_offset(extend=True)
    ptr_p, ptr_s, src_nbrs, efeats = [], [], [], []
    dt0 = dt = None
    for g in range(grids_cart.shape[0]):
        p, s, dt0, dt, _ = build_time_pointers(
            trv_grids[g], dt=1.0, k=cfg.graph.k_time_edges, win=cfg.model.t_win,
            max_t=max_t)
        ptr_p.append(p)
        ptr_s.append(s)
        src_nbrs.append(build_source_graph(grids_cart[g], cfg.graph.k_spc_edges))
        efeats.append(build_edge_feat(grids_lla[g], sta_lla, scale))
    flat = grids_cart.reshape(-1, 3)
    cart_min = flat.amin(dim=0)
    cart_max = flat.amax(dim=0)
    return DomainContext(
        sta_cart=sta_cart, sta_lla=sta_lla, grids_cart=grids_cart,
        grids_lla=grids_lla, trv_grids=trv_grids,
        time_ptr_p=torch.stack(ptr_p), time_ptr_s=torch.stack(ptr_s),
        dt0=dt0, dt=dt, edge_feat=torch.stack(efeats),
        src_nbr=torch.stack(src_nbrs), scale_cart=cart_max - cart_min,
        offset_cart=cart_min)
