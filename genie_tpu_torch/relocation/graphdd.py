"""GraphDD: GNN double-difference relocation.

Port of ``genie_tpu/relocation/graphdd.py``:

  * :func:`build_catalog_data`: per-pick residuals and travel-time partials
    (``torch.func.vmap(torch.func.jacfwd(…))`` through the surrogate);
  * :func:`prune_picks`, :func:`drop_isolated_sources` and the exact
    subset-sum :func:`select_sources_by_pick_budget`;
  * :func:`make_relocation_graphs`: static-shape relocation graphs from the
    3-tier random source sampler, on host numpy (the same draws as the JAX
    package for the same integer seed), with the station kNN of
    ``ops/knn.py``;
  * :func:`load_dtcc`, :func:`attach_dtcc`, :func:`attach_reference`;
  * :class:`GNNLocation`: ``n_rounds`` edge-featured dual-relation rounds
    over the (source × station) product, gated bipartite read-outs and the
    Δx / Δt / station-static heads, with an optional memory input;
  * :func:`make_feature_tensor`, :func:`make_dd_loss`,
    :func:`train_graphdd` (global-norm clipping at 1.0, then Adam) and
    :func:`relocate`.

Module and parameter names follow the flax tree, so ``params.transplant``
and ``params.to_flax`` carry weights across. ``_Seq2`` is
``Dense(n_out)(PReLU(Dense(n_hidden)(x)))``, whose outer ``Dense`` flax
creates first: ``Dense_0`` is the output layer and ``Dense_1`` the input
layer.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.models.layers import PReLU, _prelus
from genie_tpu_torch.ops.knn import knn
from genie_tpu_torch.train.optim import clip_by_global_norm_


class RelocGraph(NamedTuple):
    """One static-shape relocation graph (S sources × n_sta_g stations).

    The station axis is the graph's observed subset: ``sta_sel`` indexes
    the full station array and the obs arrays are sliced to it.
    ``node_type`` is the sampler's tier (0 seed, 1 neighbour, 2 second hop;
    padding 2); loss pairs connect tier-0/1 nodes only. The dt.cc fields
    hold graph-local indices (all-False ``dt_mask`` when unused); the
    reference fields are ``None`` until :func:`attach_reference`."""

    src_pos: torch.Tensor     # (S, 3) initial Cartesian positions
    src_time: torch.Tensor    # (S,) origin times
    src_mask: torch.Tensor    # (S,) bool
    node_type: torch.Tensor   # (S,) int 0/1/2
    node_ids: torch.Tensor    # (S,) global catalog indices (padding 0)
    obs_time: torch.Tensor    # (S, n_sta_g, 2) observed arrivals
    obs_mask: torch.Tensor    # (S, n_sta_g, 2) pick presence
    src_nbr: torch.Tensor     # (S, k_src)
    sta_nbr: torch.Tensor     # (n_sta_g, k_sta)
    sta_sel: torch.Tensor     # (n_sta_g,) indices into the full station set
    sta_mask: torch.Tensor    # (n_sta_g,) bool
    pair_a: torch.Tensor      # (n_pairs,) loss-edge source indices
    pair_b: torch.Tensor      # (n_pairs,)
    pair_mask: torch.Tensor   # (n_pairs,) bool
    dt_a: torch.Tensor = None
    dt_b: torch.Tensor = None
    dt_sta: torch.Tensor = None
    dt_ph: torch.Tensor = None
    dt_w: torch.Tensor = None
    dt_t: torch.Tensor = None
    dt_mask: torch.Tensor = None
    ref_pos: torch.Tensor = None    # (S, 3)
    ref_time: torch.Tensor = None   # (S,)
    ref_mask: torch.Tensor = None   # (S,) bool, True where matched


def graph_to(graph: RelocGraph, device) -> RelocGraph:
    """``graph`` with every tensor on ``device``."""
    return RelocGraph(*[None if v is None else v.to(device) for v in graph])


# -- catalog data and pruning ------------------------------------------------

def build_catalog_data(trv_from_cart, sta_cart, src_pos, src_time, obs_time, obs_mask):
    """Residuals and travel-time partials of a catalog: (resid (S, n_sta,
    2), partials (S, n_sta, 2, 3))."""
    pred = trv_from_cart(sta_cart, src_pos) + src_time[:, None, None]
    resid = (obs_time - pred) * obs_mask

    def t_of_x(x):
        return trv_from_cart(sta_cart, x[None])[0]        # (n_sta, 2)

    partials = torch.func.vmap(torch.func.jacfwd(t_of_x))(src_pos)
    return resid, partials


def prune_picks(resid, obs_mask, max_resid: float = 2.0, max_rel_resid: float = 0.1,
                trv=None):
    """Drop picks with large (relative) residuals; returns the cleaned
    obs_mask."""
    bad = resid.abs() > max_resid
    if trv is not None:
        bad = bad | (resid.abs() > max_rel_resid * torch.clamp_min(trv, 1.0))
    return obs_mask * (~bad)


def drop_isolated_sources(src_pos, src_mask, obs_mask, min_picks: int = 6,
                          max_nn_dist: float = 50e3):
    """Unmask sources with fewer than ``min_picks`` picks or no other
    source within ``max_nn_dist``; returns the updated src_mask."""
    n_picks = obs_mask.sum(dim=(1, 2))
    d = torch.linalg.norm(src_pos[:, None] - src_pos[None, :], dim=-1)
    eye = torch.eye(len(src_pos), dtype=torch.bool, device=src_pos.device)
    d = torch.where(eye | ~src_mask[None, :], torch.full_like(d, float("inf")), d)
    has_nbr = d.min(dim=1).values < max_nn_dist
    return src_mask & (n_picks >= min_picks) & has_nbr


def select_sources_by_pick_budget(cnt_per_source, n_total: int):
    """A source subset maximizing the total pick count subject to total ≤
    ``n_total``. Value equals weight, so this is subset-sum, solved exactly
    by DP over the budget. Returns the selected indices."""
    cnt = np.asarray(cnt_per_source, np.int64)
    budget = int(min(n_total, cnt.sum()))
    if budget <= 0:
        return np.zeros(0, np.int64)
    reach = np.zeros(budget + 1, bool)
    reach[0] = True
    choice = np.full((len(cnt), budget + 1), False)
    for i, c in enumerate(cnt):
        if c == 0 or c > budget:
            continue
        new = np.zeros_like(reach)
        new[c:] = reach[:-c]
        take = new & ~reach
        choice[i] = take
        reach |= new
    best = int(np.nonzero(reach)[0][-1])
    sel, b = [], best
    for i in range(len(cnt) - 1, -1, -1):
        if b > 0 and choice[i, b]:
            sel.append(i)
            b -= int(cnt[i])
    return np.asarray(sel[::-1], np.int64)


# -- graph sampling ------------------------------------------------------------

def _fixed_k_table(edges_a, edges_b, n_nodes, k, rng):
    """Directed edge list (a → receiver b) → fixed-k per-receiver
    neighbour table, padded with self-loops."""
    tbl = np.tile(np.arange(n_nodes)[:, None], (1, k))
    for j in range(n_nodes):
        nb = np.unique(edges_a[edges_b == j])
        if len(nb) > k:
            nb = rng.choice(nb, k, replace=False)
        tbl[j, :len(nb)] = nb
    return tbl


def _empty_dtcc(n_dt: int, device=None):
    def z(dtype):
        return torch.zeros(n_dt, dtype=dtype, device=device)

    return dict(dt_a=z(torch.int32), dt_b=z(torch.int32), dt_sta=z(torch.int32),
                dt_ph=z(torch.int32), dt_w=z(torch.float32), dt_t=z(torch.float32),
                dt_mask=z(torch.bool))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_relocation_graphs(seed: int, src_pos, src_time, obs_time, obs_mask, sta_cart,
                           n_graphs: int, graph_size: int = 32, k_src: int = 8,
                           k_sta: int = 8, max_pair_dist: float = 10e3,
                           n_pairs: int = 256, n_seed: int = 6,
                           max_src_pair_dist: float = 50e3,
                           sta_budget: int | None = None,
                           pick_budget: int | None = None, device=None):
    """Sample ``n_graphs`` relocation graphs with the 3-tier random source
    graph: ``n_seed`` random tier-0 sources, random neighbours within
    ``max_src_pair_dist`` (tier 1), their neighbours (tier 2), extra edges
    among tiers 0/1; loss pairs connect tier-0/1 nodes within
    ``max_pair_dist``. The station axis is the graph's observed stations,
    capped at ``sta_budget``; a tiered node set over ``graph_size`` keeps
    its seeds and selects the rest by pick budget.

    ``seed`` seeds ``np.random.default_rng``: every draw is numpy, so the
    JAX package's graphs for key k are these graphs for the integer
    ``jax.random.randint(k, (), 0, 2**31 - 1)``. Inputs are arrays or
    tensors; the graphs' tensors go to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    src_pos_np = np.asarray(_np(src_pos), np.float64)
    n_src = src_pos_np.shape[0]
    rng = np.random.default_rng(int(seed))
    obs_mask_np = _np(obs_mask)
    obs_time_np = _np(obs_time)
    src_time_np = _np(src_time)
    sta_np = _np(sta_cart)
    picks_per_src = obs_mask_np.sum(axis=(1, 2)).astype(np.int64)
    graphs = []

    d_all = None
    if n_src <= 4096:
        d_all = np.linalg.norm(src_pos_np[:, None] - src_pos_np[None], axis=-1)

    def neighbors_within(i):
        d = (d_all[i] if d_all is not None else
             np.linalg.norm(src_pos_np - src_pos_np[i], axis=1))
        return np.where((d < max_src_pair_dist) & (d > 0))[0]

    for _ in range(n_graphs):
        seeds = rng.choice(n_src, size=min(n_seed, n_src), replace=False)
        tier1, tier2 = [], []
        edges = []                                  # (sender, receiver) global
        for s in seeds:
            nb = neighbors_within(s)
            if len(nb):
                ch = rng.choice(nb, min(k_src, len(nb)), replace=False)
                tier1.append(ch)
                edges.append(np.stack((ch, np.full(len(ch), s)), 1))
        tier1 = (np.setdiff1d(np.unique(np.concatenate(tier1)), seeds)
                 if tier1 else np.zeros(0, np.int64))
        k2 = max(1, k_src // 3)
        for s in tier1:
            nb = neighbors_within(s)
            if len(nb):
                ch = rng.choice(nb, min(k2, len(nb)), replace=False)
                tier2.append(ch)
                edges.append(np.stack((ch, np.full(len(ch), s)), 1))
        known = np.concatenate((seeds, tier1))
        tier2 = (np.setdiff1d(np.unique(np.concatenate(tier2)), known)
                 if tier2 else np.zeros(0, np.int64))

        ids = np.concatenate((seeds, tier1, tier2))
        types = np.concatenate((np.zeros(len(seeds), np.int64),
                                np.ones(len(tier1), np.int64),
                                np.full(len(tier2), 2, np.int64)))
        if len(ids) > graph_size:
            # keep all seeds; budget-select the rest by pick count
            rest = np.arange(len(seeds), len(ids))
            budget = (pick_budget if pick_budget is not None
                      else int(picks_per_src[ids[rest]].mean()
                               * (graph_size - len(seeds))))
            keep_rest = rest[select_sources_by_pick_budget(
                picks_per_src[ids[rest]], budget)]
            if len(keep_rest) > graph_size - len(seeds):
                keep_rest = rng.choice(keep_rest, graph_size - len(seeds),
                                       replace=False)
            keep = np.concatenate((np.arange(len(seeds)), np.sort(keep_rest)))
            ids, types = ids[keep], types[keep]

        S = len(ids)
        pad = graph_size - S
        sel = np.concatenate((ids, np.zeros(pad, np.int64)))
        smask = np.arange(graph_size) < S
        types_p = np.concatenate((types, np.full(pad, 2, np.int64)))
        pos_g = src_pos_np[sel].astype(np.float32)

        # observed-station subset: stations with ≥1 pick among the graph's
        # sources, padded to a static budget
        om_g = obs_mask_np[sel] * smask[:, None, None]
        sta_obs = np.where(om_g.max(axis=(0, 2)) > 0)[0]
        n_sta_g = sta_budget or len(sta_np)
        if len(sta_obs) > n_sta_g:
            order = np.argsort(-om_g.sum(axis=(0, 2))[sta_obs])
            sta_obs = np.sort(sta_obs[order[:n_sta_g]])
        sta_sel = np.zeros(n_sta_g, np.int64)
        sta_sel[:len(sta_obs)] = sta_obs
        sta_gmask = np.arange(n_sta_g) < len(sta_obs)

        sc_g = torch.as_tensor(np.asarray(sta_np)[sta_sel], dtype=torch.float32) / 1000.0
        sta_nbr, _ = knn(sc_g, sc_g, min(k_sta + 1, n_sta_g),
                         context_mask=torch.as_tensor(sta_gmask))
        sta_nbr = sta_nbr.numpy()[:, 1:]

        # conv edges: the sampled tier edges (both directions) + extra edges
        # among tier-0/1 nodes within radius, as a fixed-k per-receiver
        # table in the graph's local frame
        glob_to_loc = -np.ones(n_src, np.int64)
        glob_to_loc[ids] = np.arange(S)
        e = np.concatenate(edges, 0) if edges else np.zeros((0, 2), np.int64)
        ea, eb = glob_to_loc[e[:, 0]], glob_to_loc[e[:, 1]]
        keep_e = (ea >= 0) & (eb >= 0)
        ea, eb = ea[keep_e], eb[keep_e]
        up = np.where(types <= 1)[0]
        if len(up) > 1:
            du = np.linalg.norm(pos_g[up][:, None] - pos_g[up][None], axis=-1)
            ui, uj = np.where((du < max_src_pair_dist) & (du > 0))
            ea = np.concatenate((ea, up[ui]))
            eb = np.concatenate((eb, up[uj]))
        ea, eb = np.concatenate((ea, eb)), np.concatenate((eb, ea))  # symmetrize
        nbr_idx = _fixed_k_table(ea, eb, graph_size, k_src, rng)

        # loss pairs: tier-0/1 nodes only
        dd = np.linalg.norm(pos_g[:, None] - pos_g[None, :], axis=-1)
        upper = types_p <= 1
        ii, jj = np.where((dd < max_pair_dist) & (dd > 0)
                          & smask[:, None] & smask[None, :]
                          & upper[:, None] & upper[None, :])
        if len(ii) > n_pairs:
            pick = rng.choice(len(ii), n_pairs, replace=False)
            ii, jj = ii[pick], jj[pick]
        pa = np.zeros(n_pairs, np.int64)
        pb = np.zeros(n_pairs, np.int64)
        pmask = np.zeros(n_pairs, bool)
        pa[:len(ii)] = ii
        pb[:len(jj)] = jj
        pmask[:len(ii)] = True

        ot_g = obs_time_np[sel][:, sta_sel]
        om_gs = om_g[:, sta_sel] * sta_gmask[None, :, None]

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        graphs.append(RelocGraph(
            src_pos=t(pos_g, torch.float32),
            src_time=t(src_time_np[sel], torch.float32),
            src_mask=t(smask, torch.bool),
            node_type=t(types_p, torch.int32),
            node_ids=t(sel, torch.int32),
            obs_time=t(ot_g, torch.float32),
            obs_mask=t(om_gs, torch.float32),
            src_nbr=t(nbr_idx, torch.int32),
            sta_nbr=t(sta_nbr, torch.int32),
            sta_sel=t(sta_sel, torch.int32),
            sta_mask=t(sta_gmask, torch.bool),
            pair_a=t(pa, torch.int32), pair_b=t(pb, torch.int32),
            pair_mask=t(pmask, torch.bool),
            **_empty_dtcc(1, dev),
        ))
    return graphs


# -- dt.cc and reference events ------------------------------------------------

def load_dtcc(path, sta_names):
    """Parse a HypoDD ``dt.cc`` cross-correlation differential-time file.
    Returns a dict of arrays: src_a, src_b (0-based catalog ids), sta, ph,
    w, dt."""
    name_to_idx = {str(n): i for i, n in enumerate(np.asarray(sta_names))}
    a, b, sta, ph, w, dt = [], [], [], [], [], []
    cur = None
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "#":
            cur = (int(parts[1]) - 1, int(parts[2]) - 1)
            continue
        if cur is None:
            raise ValueError("dt.cc pick line before any '#' pair line")
        if parts[0] not in name_to_idx:
            raise ValueError(f"dt.cc station {parts[0]!r} not in stations")
        if parts[3] not in ("P", "S"):
            raise ValueError(f"dt.cc phase must be P or S, got {parts[3]!r}")
        a.append(cur[0])
        b.append(cur[1])
        sta.append(name_to_idx[parts[0]])
        dt.append(float(parts[1]))
        w.append(float(parts[2]))
        ph.append(0 if parts[3] == "P" else 1)
    return {"src_a": np.asarray(a, np.int64), "src_b": np.asarray(b, np.int64),
            "sta": np.asarray(sta, np.int64), "ph": np.asarray(ph, np.int64),
            "w": np.asarray(w, np.float64), "dt": np.asarray(dt, np.float64)}


def attach_reference(graph: RelocGraph, matched_ids, ref_pos, ref_time):
    """Attach matched calibration-reference events: ``matched_ids[i]`` is
    the global catalog id matched to reference event i (``ref_pos``
    Cartesian, ``ref_time`` absolute). Unmatched sources get ref_mask
    False."""
    ids = _np(graph.node_ids)
    smask = _np(graph.src_mask)
    ref_pos, ref_time = _np(ref_pos), _np(ref_time)
    S = len(ids)
    rp = np.zeros((S, 3), np.float32)
    rt = np.zeros(S, np.float32)
    rm = np.zeros(S, bool)
    lookup = {int(g): i for i, g in enumerate(_np(matched_ids))}
    for r in range(S):
        if smask[r] and int(ids[r]) in lookup:
            i = lookup[int(ids[r])]
            rp[r] = ref_pos[i]
            rt[r] = ref_time[i]
            rm[r] = True
    dev = graph.src_pos.device
    return graph._replace(ref_pos=torch.as_tensor(rp, device=dev),
                          ref_time=torch.as_tensor(rt, device=dev),
                          ref_mask=torch.as_tensor(rm, device=dev))


def attach_dtcc(graph: RelocGraph, dtcc: dict, n_dt: int = 256):
    """Map global dt.cc observations into one graph's local indices; an
    observation is kept when both sources and its station are in the
    graph."""
    ids = _np(graph.node_ids)
    smask = _np(graph.src_mask)
    sta_sel = _np(graph.sta_sel)
    sta_gmask = _np(graph.sta_mask)
    src_local = -np.ones(int(max(ids.max() + 1, dtcc["src_a"].max() + 1,
                                 dtcc["src_b"].max() + 1)), np.int64)
    src_local[ids[smask]] = np.where(smask)[0]
    sta_local = -np.ones(int(max(sta_sel.max() + 1, dtcc["sta"].max() + 1)), np.int64)
    sta_local[sta_sel[sta_gmask]] = np.where(sta_gmask)[0]

    la = src_local[dtcc["src_a"]]
    lb = src_local[dtcc["src_b"]]
    ls = sta_local[dtcc["sta"]]
    ok = (la >= 0) & (lb >= 0) & (ls >= 0)
    idx = np.where(ok)[0][:n_dt]
    dev = graph.src_pos.device
    fill = _empty_dtcc(n_dt, dev)
    n = len(idx)
    for name, src in (("dt_a", la), ("dt_b", lb), ("dt_sta", ls),
                      ("dt_ph", dtcc["ph"]), ("dt_w", dtcc["w"]),
                      ("dt_t", dtcc["dt"])):
        arr = fill[name]
        if n:
            arr = arr.clone()
            arr[:n] = torch.as_tensor(np.asarray(src[idx]), device=dev).to(arr.dtype)
        fill[name] = arr
    fill["dt_mask"][:n] = True
    return graph._replace(**fill)


# -- the model -----------------------------------------------------------------

class _Seq2(nn.Module):
    """Linear → PReLU → Linear; flax names the outer (output) layer
    ``Dense_0`` and the input layer ``Dense_1``."""

    def __init__(self, n_in: int, n_hidden: int, n_out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(n_hidden, n_out)
        self.PReLU_0 = PReLU()
        self.Dense_1 = nn.Linear(n_in, n_hidden)

    def forward(self, x):
        return self.Dense_0(self.PReLU_0(self.Dense_1(x)))


class _DDConv(nn.Module):
    """One GraphDD dual-relation round on the (source × station) product.
    Every message passes a shared ``merge_edges`` Linear + PReLU carrying
    the sender − receiver offset (station offsets within a source, source
    offsets within a station); the embedded input mask joins every linear.
    Messages from unobserved cells are left out of the means.
    ``merge_edges(cat(x_j, e))`` is computed as ``merge_edges_x(x_j) +
    merge_edges_e(e)`` (no bias on the edge half), so the edge term is taken
    once per (receiver, k). ``PReLU_0`` is the input activation,
    ``PReLU_1…6`` are a11, a12, a1, a21, a22, a2 and ``PReLU_7`` the message
    activation; the reference's unused ``l1_t*_1`` linears are not
    created."""

    def __init__(self, in_channels: int, n_embed: int = 10, n_hidden: int = 30,
                 out_channels: int = 15):
        super().__init__()
        h = n_hidden
        _prelus(self, 8)
        self.merge_edges_x = nn.Linear(h, h)
        self.merge_edges_e = nn.Linear(3, h, bias=False)
        self.init_trns = nn.Linear(in_channels + n_embed, h)
        self.l1_t1_2 = nn.Linear(2 * h + n_embed, h)
        self.l1_t2_2 = nn.Linear(2 * h + n_embed, h)
        self.l2_t1_1 = nn.Linear(2 * h, h)
        self.l2_t2_1 = nn.Linear(2 * h, h)
        self.l2_t1_2 = nn.Linear(3 * h + n_embed, out_channels)
        self.l2_t2_2 = nn.Linear(3 * h + n_embed, out_channels)

    def forward(self, x, m, sta_nbr, src_nbr, e_sta, e_src, send):
        # x (S, n_sta, C); m (S, n_sta, n_embed); send (S, n_sta)
        # e_sta (n_sta, k_sta, 3); e_src (S, k_src, 3): scaled offsets
        act, a11, a12, a1, a21, a22, a2, me_act = self.acts
        fe_sta = self.merge_edges_e(e_sta)                  # (n_sta, k_sta, h)
        fe_src = self.merge_edges_e(e_src)                  # (S, k_src, h)
        v_sta = send[:, sta_nbr]                            # (S, n_sta, k_sta)
        v_src = send[src_nbr]                               # (S, k_src, n_sta)

        def agg_sta(v):
            msg = me_act(self.merge_edges_x(v)[:, sta_nbr] + fe_sta[None])
            msg = msg * v_sta[..., None]                    # (S, n_sta, k, h)
            return msg.sum(2) / torch.clamp_min(v_sta.sum(2), 1.0)[..., None]

        def agg_src(v):
            msg = me_act(self.merge_edges_x(v)[src_nbr] + fe_src[:, :, None])
            msg = msg * v_src[..., None]                    # (S, k, n_sta, h)
            return msg.sum(1) / torch.clamp_min(v_src.sum(1), 1.0)[..., None]

        tr = act(self.init_trns(torch.cat((x, m), -1)))
        # round 1 feeds act(tr) straight into the messages
        tr1 = self.l1_t1_2(torch.cat((tr, agg_sta(a11(tr)), m), -1))
        tr2 = self.l1_t2_2(torch.cat((tr, agg_src(a12(tr)), m), -1))
        tr = a1(torch.cat((tr1, tr2), -1))
        tr1 = self.l2_t1_2(torch.cat((tr, agg_sta(a21(self.l2_t1_1(tr))), m), -1))
        tr2 = self.l2_t2_2(torch.cat((tr, agg_src(a22(self.l2_t2_1(tr))), m), -1))
        return a2(torch.cat((tr1, tr2), -1))


class _DDReadOut(nn.Module):
    """Gated bipartite read-out: per product cell PReLU(fc1(cat(x, mask
    embedding, rel/scale))) with fc1 = Linear → PReLU → Linear, a masked
    mean over one product axis (``axis`` 1 collapses stations, 0 sources),
    then PReLU(fc2(·))."""

    def __init__(self, axis: int, inner: int = 30, n_embed: int = 10, n_out: int = 15,
                 scale_rel: float = 30e3):
        super().__init__()
        self.axis = axis
        self.scale_rel = scale_rel
        _prelus(self, 2)
        self.fc1 = _Seq2(inner + n_embed + 3, inner, inner)
        self.fc2 = nn.Linear(inner, n_out)

    def forward(self, x, m, rel, prod_mask):
        a1, a2 = self.acts
        msg = a1(self.fc1(torch.cat((x, m, rel / self.scale_rel), -1)))
        msg = msg * prod_mask
        agg = msg.sum(self.axis) / torch.clamp_min(prod_mask.sum(self.axis), 1.0)
        return a2(self.fc2(agg))


N_FEATURES = 18     # make_feature_tensor's channels without memory
N_MEMORY = 4        # memory channels: Δx / pos_scale (3) and Δt


class GNNLocation(nn.Module):
    """Relocation GNN: the input features embedded into an ``n_embed``
    mask channel joined at every round's linears, ``n_rounds`` rounds of
    :class:`_DDConv`, per-source and per-station read-outs, then the heads
    Δx = ``pos_scale``·proj(x1), Δt = proj_t(x1) and per-station P/S
    statics proj_c(x2). With ``use_memory`` the EMA of earlier predictions
    (:data:`N_MEMORY` channels per source) is a further input and merges into
    x1 through proj_memory / merge_data; the flax module infers that from
    its input, here it is fixed at construction."""

    def __init__(self, n_hidden: int = 30, n_embed: int = 10, n_embed_hidden: int = 20,
                 pos_scale: float = 5e3, n_rounds: int = 5, scale_rel_conv: float = 30.0,
                 scale_rel_read: float = 30e3, use_memory: bool = False):
        super().__init__()
        self.pos_scale = pos_scale
        self.n_rounds = n_rounds
        self.scale_rel_conv = scale_rel_conv
        self.use_memory = use_memory
        n_in = N_FEATURES + (N_MEMORY if use_memory else 0)
        self.embed_inpt = _Seq2(n_in, n_embed_hidden, n_embed)
        for r in range(n_rounds):
            self.add_module(f"_DDConv_{r}", _DDConv(n_in if r == 0 else 30, n_embed,
                                                    n_hidden))
        self.read_src = _DDReadOut(1, 30, n_embed, scale_rel=scale_rel_read)
        self.read_sta = _DDReadOut(0, 30, n_embed, scale_rel=scale_rel_read)
        n_x1 = 15
        if use_memory:
            self.proj_memory = _Seq2(N_MEMORY, 30, 15)
            self.merge_data = _Seq2(30, 30, 30)
            n_x1 = 30
        self.proj = _Seq2(n_x1, 30, 3)
        self.proj_t = _Seq2(n_x1, 15, 1)
        self.proj_c = _Seq2(15, 15, 2)

    def forward(self, feat, src_nbr, sta_nbr, prod_mask, src_pos, sta_pos, memory=None):
        # feat (S, n_sta, C); prod_mask (S, n_sta, 1)
        if (memory is not None) != self.use_memory:
            raise ValueError(f"GNNLocation(use_memory={self.use_memory}) called "
                             f"{'with' if memory is not None else 'without'} memory")
        src_nbr, sta_nbr = src_nbr.long(), sta_nbr.long()
        m = self.embed_inpt(feat)
        e_sta = (sta_pos[sta_nbr] - sta_pos[:, None]) / 1000.0 / self.scale_rel_conv
        e_src = (src_pos[src_nbr] - src_pos[:, None]) / 1000.0 / self.scale_rel_conv
        send = prod_mask[..., 0]
        x = feat
        for r in range(self.n_rounds):
            x = getattr(self, f"_DDConv_{r}")(x, m, sta_nbr, src_nbr, e_sta, e_src, send)
        rel = src_pos[:, None, :] - sta_pos[None, :, :]            # (S, n_sta, 3)
        x1 = self.read_src(x, m, rel, prod_mask)
        x2 = self.read_sta(x, m, -rel, prod_mask)
        if memory is not None:
            x1 = self.merge_data(torch.cat((x1, self.proj_memory(memory)), -1))
        d_pos = self.pos_scale * self.proj(x1)
        d_t = self.proj_t(x1)[:, 0]
        sta_corr = self.proj_c(x2)
        return d_pos, d_t, sta_corr


# -- features, loss, training ----------------------------------------------------

def make_feature_tensor(graph: RelocGraph, sta_cart, resid, partials,
                        scale_t: float = 5.0, scale_x: float = 50e3, memory=None):
    """The 18 per-(source, station) input channels: P/S residuals, P/S
    partials (3 + 3), the offset vector and its norm, the log pick count,
    the P/S masks and the normalized absolute source position; ``memory``
    appends its channels per source. ``sta_cart`` is the graph's station
    subset. Returns (feat × prod_mask, prod_mask (S, n_sta, 1))."""
    off = (graph.src_pos[:, None, :] - sta_cart[None, :, :]) / scale_x
    off_n = torch.linalg.norm(off, dim=-1, keepdim=True)
    pick_cnt = graph.obs_mask.sum(dim=(1, 2))
    log_cnt = torch.log1p(pick_cnt)[:, None, None] * torch.ones_like(off_n)
    scale = torch.tensor((1.0, 1.0, 100e3), dtype=partials.dtype, device=partials.device)
    p_scaled = partials * (1.0 / 60.0) * scale.reshape(1, 1, 1, 3)
    src_abs = (graph.src_pos[:, None, :] / scale_x).expand(off.shape)
    parts = [
        resid[:, :, 0:1] / scale_t, resid[:, :, 1:2] / scale_t,
        p_scaled[:, :, 0, :], p_scaled[:, :, 1, :],
        off, off_n, log_cnt,
        graph.obs_mask[:, :, 0:1], graph.obs_mask[:, :, 1:2],
        src_abs,
    ]
    if memory is not None:
        parts.append(memory[:, None, :].expand(memory.shape[0], sta_cart.shape[0],
                                               memory.shape[1]))
    feat = torch.cat(parts, dim=-1)
    prod_mask = (graph.obs_mask.amax(dim=-1, keepdim=True) > 0).to(torch.float32)
    return feat * prod_mask, prod_mask


def make_dd_loss(model: GNNLocation, trv_from_cart, sta_cart, w_dd: float = 0.8,
                 w_abs: float = 0.1, w_sta: float = 0.1, w_dtcc: float = 0.8,
                 w_cal: float = 0.5):
    """The relocation loss through the travel-time surrogate at the model's
    current weights: ``w_dd`` × double difference + ``w_abs`` × absolute +
    ``w_sta`` × station-mean L1 residuals, plus ``w_dtcc`` × the dt.cc loss
    when observations are attached and ``w_cal`` × the
    calibration-to-reference loss when reference events are attached.

    ``loss_fn(graph, memory=None, catalog=None)`` returns (total, (parts,
    Δx, Δt)) with Δx and Δt detached. ``catalog`` is the graph's
    :func:`build_catalog_data`, which does not depend on the weights and is
    computed when not given."""
    sta_cart = torch.as_tensor(sta_cart, dtype=torch.float32)

    def loss_fn(graph: RelocGraph, memory=None, catalog=None):
        sc = sta_cart[graph.sta_sel.long()]        # the graph's station subset
        if catalog is None:
            catalog = build_catalog_data(trv_from_cart, sc, graph.src_pos, graph.src_time,
                                         graph.obs_time, graph.obs_mask)
        feat, prod_mask = make_feature_tensor(graph, sc, *catalog, memory=memory)
        d_pos, d_t, sta_corr = model(feat, graph.src_nbr, graph.sta_nbr, prod_mask,
                                     graph.src_pos, sc, memory=memory)
        smask = graph.src_mask.to(d_pos.dtype)
        new_pos = graph.src_pos + d_pos * smask[:, None]
        new_t = graph.src_time + d_t * smask
        t_full = trv_from_cart(sc, new_pos)                         # (S, n_sta_g, 2)
        pred = t_full + new_t[:, None, None] + sta_corr[None, :, :]
        r = graph.obs_time - pred
        m = graph.obs_mask

        l_abs = (r.abs() * m).sum() / torch.clamp_min(m.sum(), 1.0)
        sta_mean = (r * m).sum(dim=0) / torch.clamp_min(m.sum(dim=0), 1.0)
        l_sta = sta_mean.abs().mean()
        # double difference: for shared stations/phases the difference of
        # residuals of a loss pair should vanish
        pa, pb = graph.pair_a.long(), graph.pair_b.long()
        ma = m[pa] * m[pb]
        dd = (r[pa] - r[pb]) * ma
        pmask = graph.pair_mask.to(r.dtype)
        l_dd = ((dd.abs().sum(dim=(1, 2)) / torch.clamp_min(ma.sum(dim=(1, 2)), 1.0)
                 * pmask).sum() / torch.clamp_min(pmask.sum(), 1.0))
        total = w_dd * l_dd + w_abs * l_abs + w_sta * l_sta

        # dt.cc: reproduce the cross-correlation differential times of
        # paired sources at a shared station/phase; S weighted 0.5
        da, db = graph.dt_a.long(), graph.dt_b.long()
        ds, dp = graph.dt_sta.long(), graph.dt_ph.long()
        t_a = t_full[da, ds, dp] + new_t[da] + sta_corr[ds, dp]
        t_b = t_full[db, ds, dp] + new_t[db] + sta_corr[ds, dp]
        wp = (torch.where(dp == 1, 0.5, 1.0) * graph.dt_w
              * graph.dt_mask.to(graph.dt_w.dtype))
        l_dtcc = ((wp * (graph.dt_t - (t_a - t_b)).abs()).sum()
                  / torch.clamp_min(wp.sum(), 1e-6))
        total = total + w_dtcc * l_dtcc * (graph.dt_mask.sum() > 0)

        # calibration to reference events: on matched sources the relocated
        # travel-time curve should match the one at the reference location,
        # and the observed arrivals the reference times + station statics
        # (S weighted 0.5)
        l_cal = torch.zeros((), device=r.device)
        if graph.ref_mask is not None:
            t_ref = trv_from_cart(sc, graph.ref_pos) + graph.ref_time[:, None, None]
            t_new = t_full + new_t[:, None, None]
            mc = m * graph.ref_mask.to(m.dtype)[:, None, None]
            denom = torch.clamp_min(mc.sum(), 1.0)
            l_cal_abs = ((t_new - t_ref).abs() * mc).sum() / denom
            wph = torch.tensor([1.0, 0.5], device=r.device).reshape(1, 1, 2)
            rc = (graph.obs_time - (t_ref + sta_corr[None, :, :])) * mc
            l_cal_data = (rc.abs() * wph).sum() / denom
            l_cal = 0.5 * (l_cal_abs + l_cal_data)
            total = total + w_cal * l_cal * (graph.ref_mask.sum() > 0)

        parts = {"dd": l_dd, "abs": l_abs, "sta": l_sta, "dtcc": l_dtcc, "cal": l_cal}
        return total, (parts, d_pos.detach(), d_t.detach())

    return loss_fn


def train_graphdd(generator, model: GNNLocation, trv_from_cart, sta_cart, graphs,
                  n_steps: int = 500, lr: float = 1e-3, buffer_weight: float = 0.98,
                  device=None, keep_weights: bool = False):
    """Adam over the relocation graphs, one graph per step in turn, after
    clipping the gradients to global norm 1. ``generator`` (a
    ``torch.Generator`` on the device) first gives ``model`` flax-default
    weights (``models.init.init_graphdd``), as the JAX trainer's key does;
    ``keep_weights=True`` trains the model's own weights instead (loaded
    ones; ``generator`` is then unused). A model built with ``use_memory``
    gets the EMA (``buffer_weight``) of its earlier (Δx / pos_scale, Δt)
    predictions as input, one buffer per graph. Runs on ``device`` (default
    ``cuda``). Returns (model, the loss of the last step)."""
    from genie_tpu_torch.models.init import init_graphdd

    dev = resolve_device(device)
    model = model.to(dev)
    if not keep_weights:
        if generator is None:
            raise ValueError("train_graphdd needs a generator for the initial weights "
                             "(or keep_weights=True)")
        init_graphdd(model, generator)
    sta_cart = torch.as_tensor(sta_cart, dtype=torch.float32, device=dev)
    graphs = [graph_to(g, dev) for g in graphs]
    loss_fn = make_dd_loss(model, trv_from_cart, sta_cart)
    catalogs = [build_catalog_data(trv_from_cart, sta_cart[g.sta_sel.long()], g.src_pos,
                                   g.src_time, g.obs_time, g.obs_mask) for g in graphs]
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    S = graphs[0].src_pos.shape[0]
    mems = ([torch.zeros((S, N_MEMORY), device=dev) for _ in graphs]
            if model.use_memory else [None] * len(graphs))
    total = None
    for i in range(n_steps):
        gi = i % len(graphs)
        opt.zero_grad(set_to_none=True)
        total, (_, dpos, dt) = loss_fn(graphs[gi], mems[gi], catalogs[gi])
        total.backward()
        clip_by_global_norm_(model.parameters(), 1.0)
        opt.step()
        if model.use_memory:
            upd = torch.cat((dpos / model.pos_scale, dt[:, None]), dim=1)
            mems[gi] = buffer_weight * mems[gi] + (1 - buffer_weight) * upd
    return model, (float("nan") if total is None else float(total.detach()))


@torch.no_grad()
def relocate(model: GNNLocation, trv_from_cart, sta_cart, graph: RelocGraph):
    """Apply the trained model to one graph on the model's device: returns
    (new_pos (S, 3), new_t (S,), sta_corr (n_sta_g, 2)), ``sta_corr`` rows
    following ``graph.sta_sel``."""
    dev = next(model.parameters()).device
    graph = graph_to(graph, dev)
    sta_cart = torch.as_tensor(sta_cart, dtype=torch.float32, device=dev)
    sc = sta_cart[graph.sta_sel.long()]
    resid, partials = build_catalog_data(trv_from_cart, sc, graph.src_pos,
                                         graph.src_time, graph.obs_time, graph.obs_mask)
    feat, prod_mask = make_feature_tensor(graph, sc, resid, partials)
    d_pos, d_t, sta_corr = model(feat, graph.src_nbr, graph.sta_nbr, prod_mask,
                                 graph.src_pos, sc)
    smask = graph.src_mask.to(d_pos.dtype)
    return graph.src_pos + d_pos * smask[:, None], graph.src_time + d_t * smask, sta_corr
