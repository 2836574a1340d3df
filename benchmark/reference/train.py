"""Plain detector training steps, for the check of the training cell.

Frozen copies, in plain PyTorch, of what one step of GENIE's detector
training computes from the random draws of its synthetic generator: the
training windows cut from a timeline of events and picks (the picks
nearest each window's centre at its kept stations, in (station, time)
order; the nearest-pick features; the events active in each window; the
grid, query and association labels; the per-window station graphs), the
detector's forward (:mod:`benchmark.reference.nn`) at training shapes,
run6's loss (per-cell mean squared error with ``positive_boost``, the
association terms over the real picks, the weighted sum over the outputs
averaged over the windows, no sensitivity term) and its gradient, and
optax's Adam update (bias-corrected moments, ``eps`` outside the square
root). The weights and the Adam state come from the checkpoint pickle
through this package's own loader. Float32; the caller turns TF32 off. It
imports nothing of the program.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.domain import (_Unpickler, build_domain, flax_state_dict,
                                        knn_graph, load_pickle, load_weights, pair_table,
                                        query_attachment)
from benchmark.reference.nn import GraphBundle, PickSet, QuerySet

N_T = 9                      # label time slices per window
WINDOW_FIELDS = ("feat", "mask", "sta_mask", "sta_nbr", "sta_nbr_valid", "grid_idx",
                 "tpick", "ipick", "phase", "pick_mask", "x_query", "x_qsrc",
                 "tq_sample", "lbl_grid", "lbl_query", "lbl_assoc")


# -- the checkpoint ---------------------------------------------------------

class _Fields(tuple):
    """An optax state record, kept as the tuple of its fields."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _OptaxUnpickler(_Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "optax":
            return _Fields
        return super().find_class(module, name)


def load_adam(path) -> tuple[int, dict, dict]:
    """(count, first moments, second moments) of the checkpoint's optax
    Adam state, the moments under the detector's parameter names (a
    ``Dense`` kernel's transposed as the kernel is)."""
    with open(Path(path), "rb") as f:
        blob = _OptaxUnpickler(f).load()
    for rec in blob["opt_state"]:
        if len(rec) == 3 and isinstance(rec[1], dict):
            count, mu, nu = rec
            return int(np.asarray(count)), flax_state_dict(mu), flax_state_dict(nu)
    raise pickle.UnpicklingError(f"{path}: no Adam state (count, mu, nu)")


@torch.no_grad()
def grid_tables(pinn, sta_cart, grids_cart, max_chunk: int = 50_000):
    """(n_grids, n_src, n_sta, 2): the PINN over each grid in chunks of at
    most ``max_chunk`` pairs, with no corrections."""
    rows = max(1, max_chunk // max(sta_cart.shape[0], 1))
    return torch.stack([torch.cat([pinn.from_cart(sta_cart, g[i:i + rows])
                                   for i in range(0, g.shape[0], rows)], dim=0)
                        for g in grids_cart])


# -- windows ----------------------------------------------------------------

def _nearest_gauss(query_t, sorted_keys, n_valid, kernel_sig_t):
    """exp(-Δt²/2σ²) to the nearest entry of each window's sorted keys."""
    idx = torch.searchsorted(sorted_keys, query_t.contiguous())
    hi = (n_valid - 1)[:, None]
    lo_c = torch.minimum(torch.clamp_min(idx - 1, 0), hi)
    hi_c = torch.minimum(torch.clamp_min(idx, 0), hi)
    lo_c = torch.where(lo_c < 0, lo_c + sorted_keys.shape[1], lo_c)
    hi_c = torch.where(hi_c < 0, hi_c + sorted_keys.shape[1], hi_c)
    rel = torch.minimum((query_t - torch.gather(sorted_keys, 1, lo_c)).abs(),
                        (query_t - torch.gather(sorted_keys, 1, hi_c)).abs())
    rel = torch.where((n_valid > 0)[:, None], rel,
                      torch.full_like(rel, 10.0 * kernel_sig_t))
    return torch.exp(-0.5 * rel ** 2 / kernel_sig_t ** 2)


def featurize(tpick, ipick, phase, pick_mask, trv_grid, kernel_sig_t, sta_mask):
    """The nearest-pick features (any pick against P and S, P picks against
    P, S picks against S), stations keyed apart by a span-scaled offset."""
    B = tpick.shape[0]
    n_src, n_sta = trv_grid.shape[:2]
    off = torch.maximum(tpick.abs().amax(dim=1), trv_grid.max()) * 1.25 + 100.0
    ipf = ipick.to(tpick.dtype)

    def sorted_keys(valid):
        keys = torch.where(valid, tpick + off[:, None] * ipf,
                           torch.full_like(tpick, float("inf")))
        return torch.sort(keys, dim=1).values, valid.sum(dim=1)

    k_any, n_any = sorted_keys(pick_mask)
    k_p, n_p = sorted_keys(pick_mask & (phase[..., 0] < 0.5))
    k_s, n_s = sorted_keys(pick_mask & (phase[..., 0] > 0.5))
    sta_off = off[:, None, None] * torch.arange(
        n_sta, device=tpick.device, dtype=tpick.dtype)[None, None, :]
    q_p = (trv_grid[None, :, :, 0] + sta_off).reshape(B, -1)
    q_s = (trv_grid[None, :, :, 1] + sta_off).reshape(B, -1)
    feats = [_nearest_gauss(q, k, n, kernel_sig_t).reshape(B, n_src, n_sta)
             for q, k, n in ((q_p, k_any, n_any), (q_s, k_any, n_any),
                             (q_p, k_p, n_p), (q_s, k_s, n_s))]
    feat = torch.stack(feats, dim=-1) * sta_mask[None, None, :, None]
    return feat, (feat.abs() > 0.01).to(feat.dtype)


def _gauss_labels(pos_q, t_abs, ev_pos, ev_time, active, sig_x, sig_z, sig_t):
    """Max over the active events of the separable space-time Gaussian."""
    d2 = (((pos_q[..., :, None, :2] - ev_pos[:, :2]) / sig_x) ** 2).sum(-1) \
        + ((pos_q[..., :, None, 2] - ev_pos[:, 2]) / sig_z) ** 2
    sp = torch.exp(-0.5 * d2)
    tm = torch.exp(-0.5 * ((t_abs[..., :, None] - ev_time) / sig_t) ** 2)
    val = sp[..., :, None, :] * tm[..., None, :, :]
    val = torch.where(active[..., None, None, :], val, 0.0)
    return val.amax(dim=-1)


def _select_picks(tl: dict, t0, smask, n_pick: int, t_win: float, max_t):
    """Each window's ``n_pick`` picks nearest its centre among those in the
    window at a kept station, in (station, time) order."""
    B = t0.shape[0]
    n_all = tl["pick_t"].shape[0]
    sta = tl["pick_sta"].long()[None].expand(B, n_all)
    t_rel = tl["pick_t"][None] - t0[:, None]
    in_win = (tl["pick_mask"][None] & (t_rel > -10.0) & (t_rel < t_win + max_t + 10.0)
              & torch.gather(smask, 1, sta))
    prio = torch.where(in_win, -(t_rel - t_win / 2).abs(), float("-inf"))
    sel = torch.topk(prio, n_pick, dim=1).indices
    pmask = torch.gather(in_win, 1, sel)
    key_off = t_win + max_t + 40.0
    sta_sel = torch.gather(sta, 1, sel)
    t_sel = torch.gather(t_rel, 1, sel)
    order = torch.argsort(torch.where(pmask, sta_sel.to(t_rel.dtype) * key_off + t_sel,
                                      float("inf")), dim=1)
    sel = torch.gather(sel, 1, order)
    pmask = torch.gather(pmask, 1, order)
    tp = torch.where(pmask, torch.gather(t_rel, 1, sel), 0.0)
    ip = torch.where(pmask, torch.gather(sta, 1, sel), 0).to(torch.int32)
    ph = torch.where(pmask, tl["pick_phase"].long()[sel], 0).to(torch.float32)[..., None]
    pev = torch.where(pmask, tl["pick_event"].long()[sel], -1)
    pok = pmask & tl["pick_assoc_ok"][sel]
    return tp, ip, ph, pmask, pev, pok


def _active_events(synth: dict, train: dict, tl: dict, t0, ip, pmask, pev, n_sta: int,
                   t_win: float):
    """(B, E): events with at least ``min_sta_arrival`` stations and
    ``min_pick_arrival`` picks among the window's picks and an origin time
    near the window."""
    B = ip.shape[0]
    E = tl["ev_pos_cart"].shape[0]
    dev = ip.device
    real = pmask & (pev >= 0)
    n_pick_ev = torch.zeros((B, E + 1), device=dev).scatter_add_(
        1, torch.where(real, pev, E), real.float())[:, :E]
    cell = torch.where(real, pev, 0) * n_sta + ip.long()
    uniq = torch.zeros((B, E * n_sta), device=dev).scatter_reduce_(
        1, cell, real.float(), "amax")
    n_sta_ev = uniq.reshape(B, E, n_sta).sum(-1)
    span = 2.5 * train["src_t_kernel"] * 3
    return (tl["ev_mask"][None] & (n_sta_ev >= synth["min_sta_arrival"])
            & (n_pick_ev >= synth["min_pick_arrival"])
            & (tl["ev_time"][None] >= t0[:, None] - span)
            & (tl["ev_time"][None] <= t0[:, None] + t_win + span))


def windows(cfg: dict, tl: dict, draws: dict, sta_cart, grids_cart, trv_grids) -> dict:
    """The windows of one batch from the timeline ``tl`` and the windows'
    draws (``t_sample``, ``grid_idx``, ``sta_mask``, ``x_query``,
    ``x_qsrc``, ``tq_sample``), with ``real_picks`` (window picks of an
    event) and ``active`` (the events each window labels) besides."""
    synth, train, graph = cfg["synth"], cfg["train"], cfg["graph"]
    t_win = cfg["model"]["t_win"]
    t0, smask = draws["t_sample"], draws["sta_mask"]
    g_idx = draws["grid_idx"].long()
    x_query, x_qsrc, tq = draws["x_query"], draws["x_qsrc"], draws["tq_sample"]
    B, n_sta = t0.shape[0], sta_cart.shape[0]
    E = tl["ev_pos_cart"].shape[0]
    dev = t0.device
    max_t = trv_grids.max()
    tp, ip, ph, pmask, pev, pok = _select_picks(tl, t0, smask, graph["max_picks"], t_win,
                                                max_t)
    feats = [featurize(tp[b:b + 1], ip[b:b + 1], ph[b:b + 1], pmask[b:b + 1],
                       trv_grids[g_idx[b]], train["src_t_kernel"], smask[b])
             for b in range(B)]
    active = _active_events(synth, train, tl, t0, ip, pmask, pev, n_sta, t_win)
    t_abs = t0[:, None] + torch.linspace(-t_win / 2.0, t_win / 2.0, N_T, device=dev)
    sig = (train["src_x_kernel"], train["src_depth_kernel"], train["src_t_kernel"])
    lbl_grid = _gauss_labels(grids_cart[g_idx], t_abs, tl["ev_pos_cart"], tl["ev_time"],
                             active, *sig)
    lbl_query = _gauss_labels(x_query, t_abs, tl["ev_pos_cart"], tl["ev_time"], active,
                              *sig)
    ev_of_pick = torch.where(pok & (pev >= 0), pev, E)
    act_of_pick = torch.gather(
        torch.cat((active, torch.zeros((B, 1), dtype=torch.bool, device=dev)), 1),
        1, ev_of_pick)
    ep = torch.cat((tl["ev_pos_cart"], tl["ev_pos_cart"].new_zeros(1, 3)))[ev_of_pick]
    et = torch.cat((tl["ev_time"], tl["ev_time"].new_zeros(1)))[ev_of_pick] - t0[:, None]
    d2 = (((x_qsrc[:, :, None, :2] - ep[:, None, :, :2]) / train["src_x_arv_kernel"]) ** 2
          ).sum(-1) + ((x_qsrc[:, :, None, 2] - ep[:, None, :, 2])
                       / train["src_depth_kernel"]) ** 2
    w = torch.exp(-0.5 * d2) * torch.exp(
        -0.5 * ((tq[:, :, None] - et[:, None, :]) / train["src_t_arv_kernel"]) ** 2)
    w = w * act_of_pick[:, None, :]
    lbl_assoc = torch.stack((w * (ph[..., 0] < 0.5)[:, None, :],
                             w * (ph[..., 0] > 0.5)[:, None, :]), dim=-1)
    nbrs = [knn_graph(sta_cart / 1000.0, graph["k_sta_edges"], mask=smask[b])
            for b in range(B)]
    return dict(feat=torch.cat([f[0] for f in feats]), mask=torch.cat([f[1] for f in feats]),
                sta_mask=smask, sta_nbr=torch.stack([n[0] for n in nbrs]),
                sta_nbr_valid=torch.stack([n[1] for n in nbrs]),
                grid_idx=g_idx.to(torch.int32), tpick=tp, ipick=ip, phase=ph,
                pick_mask=pmask, x_query=x_query, x_qsrc=x_qsrc, tq_sample=tq,
                lbl_grid=lbl_grid, lbl_query=lbl_query, lbl_assoc=lbl_assoc,
                real_picks=int((pmask & (pev >= 0)).sum()), active=int(active.sum()))


# -- the step -----------------------------------------------------------------

class Trainer:
    """The detector ``model`` on the domain ``dom`` with the travel times
    ``trv_from_cart``, stepped by Adam from the state ``(count, mu, nu)``."""

    def __init__(self, cfg: dict, dom, model, trv_from_cart, adam):
        self.cfg, self.dom, self.model, self.trv = cfg, dom, model, trv_from_cart
        train = cfg["train"]
        if train.get("sensitivity_weight", 0.0) != 0.0:
            raise ValueError("the reference has no sensitivity term")
        self.params = dict(model.named_parameters())
        self.theta0 = {n: p.detach().clone() for n, p in self.params.items()}
        count, mu, nu = adam
        dev = next(model.parameters()).device
        self.count = count
        self.mu = {n: mu[n].to(dev).reshape(p.shape).clone() for n, p in self.params.items()}
        self.nu = {n: nu[n].to(dev).reshape(p.shape).clone() for n, p in self.params.items()}

    def window_loss(self, win: dict, b: int):
        """(the weighted loss, the four losses) of window ``b``."""
        cfg, dom = self.cfg, self.dom
        g = int(win["grid_idx"][b])
        graph_cfg, t_win = cfg["graph"], cfg["model"]["t_win"]
        dev = dom.sta_cart.device
        one = {k: win[k][b:b + 1] for k in WINDOW_FIELDS}
        graph = GraphBundle(
            sta_nbr=one["sta_nbr"][0], sta_nbr_valid=one["sta_nbr_valid"][0],
            src_nbr=dom.src_nbr[g], sta_mask=one["sta_mask"][0],
            edge_feat=dom.edge_feat[g], src_pos=dom.grids_cart[g],
            time_ptr_p=dom.time_ptr_p[g], time_ptr_s=dom.time_ptr_s[g],
            dt0=torch.tensor(dom.dt0, dtype=torch.float32, device=dev),
            dt=torch.tensor(dom.dt, dtype=torch.float32, device=dev),
            trv=dom.trv_grids[g])
        pair_idx, pair_valid = pair_table(one["tpick"], one["ipick"], one["pick_mask"],
                                          graph_cfg["k_pick_pairs"])
        picks = PickSet(one["tpick"], one["ipick"], one["phase"], one["pick_mask"],
                        pair_idx, pair_valid)
        k = graph_cfg["k_spatial_attn"]
        t_query = torch.linspace(-t_win / 2, t_win / 2, N_T, device=dev)[:, None]
        with torch.no_grad():
            trv_qsrc = self.trv(dom.sta_cart, one["x_qsrc"])
        queries = QuerySet(
            x_query=one["x_query"], x_query_idx=query_attachment(graph.src_pos,
                                                                 one["x_query"], k),
            t_query=t_query, x_qsrc=one["x_qsrc"],
            x_qsrc_idx=query_attachment(graph.src_pos, one["x_qsrc"], k),
            tq_sample=one["tq_sample"], trv_qsrc=trv_qsrc)
        y, x, arv_p, arv_s = self.model(one["feat"], one["mask"], graph, dom.sta_cart,
                                        picks, queries)
        y, x, arv_p, arv_s = y[0, ..., 0], x[0, ..., 0], arv_p[0, ..., 0], arv_s[0, ..., 0]
        lbl_grid, lbl_query = one["lbl_grid"][0], one["lbl_query"][0]
        lbl_assoc = one["lbl_assoc"][0]
        boost = cfg["train"]["positive_boost"]

        def wmse(pred, lbl):
            w_cell = 1.0 + boost * lbl
            return ((pred - lbl) ** 2 * w_cell).sum() / w_cell.sum()

        pm = one["pick_mask"][0][None, :].to(y.dtype)
        denom = torch.clamp_min(pm.sum() * arv_p.shape[0], 1.0)
        losses = torch.stack((
            wmse(y, lbl_grid), wmse(x, lbl_query),
            (((arv_p - lbl_assoc[..., 0]) ** 2) * pm).sum() / denom,
            (((arv_s - lbl_assoc[..., 1]) ** 2) * pm).sum() / denom))
        w = torch.tensor(cfg["train"]["loss_weights"], dtype=torch.float32, device=dev)
        return (w * losses).sum(), losses

    def gradient(self, win: dict):
        """(the batch's loss, {name: gradient}): the mean over the windows
        of their weighted losses, and its gradient, one window's backward
        at a time."""
        B = win["feat"].shape[0]
        grads = {n: torch.zeros_like(p) for n, p in self.params.items()}
        total = 0.0
        for b in range(B):
            part, _ = self.window_loss(win, b)
            part = part / B
            got = torch.autograd.grad(part, list(self.params.values()), allow_unused=True)
            for (n, _), g in zip(self.params.items(), got):
                if g is not None:
                    grads[n] += g
            total += float(part.detach())
        return total, grads

    @torch.no_grad()
    def adam(self, grads: dict):
        """One Adam step of every parameter (optax's rule)."""
        lr = self.cfg["train"]["lr"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            self.mu[n] = b1 * self.mu[n] + (1.0 - b1) * g
            self.nu[n] = b2 * self.nu[n] + (1.0 - b2) * g * g
            p -= lr * (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + eps)


def make_trainer(cfg: dict, root, sta_lla, sta_cart, grids_lla, grids_cart, pinn, model,
                 device) -> Trainer:
    """The reference's domain on the PINN's grid tables, ``model`` with the
    configuration's weights, and the checkpoint's Adam state."""
    sta = torch.as_tensor(np.asarray(sta_cart, np.float32), device=device)
    grids = torch.as_tensor(np.asarray(grids_cart, np.float32), device=device)
    dom = build_domain(cfg, sta_lla, sta_cart, grids_lla, grids_cart,
                       grid_tables(pinn, sta, grids), device)
    path = Path(root) / cfg["weights"]
    load_weights(model, load_pickle(path)["params"])
    model = model.to(device)
    return Trainer(cfg, dom, model, pinn.from_cart, load_adam(path))


def leaf_gap(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's |‖got‖ − ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖, over the leaves ``keep`` (default all); returns
    (gap, leaf)."""
    names = list(want) if keep is None else [n for n in want if n in keep]
    norms = {n: float(torch.linalg.vector_norm(want[n].double())) for n in want}
    med = float(np.median(list(norms.values())))
    worst, which = 0.0, ""
    for n in names:
        a = float(torch.linalg.vector_norm(got[n].double()))
        gap = abs(a - norms[n]) / max(norms[n], med, 1e-300)
        if not math.isfinite(a):
            gap = math.inf
        if gap >= worst:
            worst, which = gap, n
    return worst, which
