"""Plain stages of GENIE's continuous-window inference, for the checks.

Frozen copies, in plain PyTorch and NumPy, of the stages that
``InferencePipeline`` runs: the pick windows, the rasterized featurizer,
the detection sweep (ensemble over grids, overlap-stacked), the candidates
(peaks, clustering), refinement by random re-querying around a candidate,
the per-source association weights and the pick assignment
(:mod:`benchmark.reference.assign`), and location (trimmed-residual
differential evolution, the Gauss-Newton covariance, residual QC and one
re-location, the covariance cut), the duplicate merge and the magnitudes
with their magnitude → distance QC. The detector is
:mod:`benchmark.reference.nn`; travel times and magnitudes come from
:mod:`benchmark.reference.domain`. Random draws come from
``torch.Generator``s seeded as the deployment states (refinement 0,
location 0). Given ``trv_loc``, the travel times in float64, location
and magnitudes run in float64 (``mag`` then in float64 too; the float32
draws widened), so they are not the deployment's float32 arithmetic in
another guise: where the two runs' selections part, the differential
evolution follows another path and may end in another of the objective's
near-equal minima.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import assign as rassign
from benchmark.reference.domain import (Domain, magnitude_distance, pair_table,
                                        query_attachment, knn_graph)
from benchmark.reference.nn import (Detector, GraphBundle, PickSet, QuerySet)


class Event:
    """One catalog event: position, origin time, picks and their phases."""

    def __init__(self, pos_cart, time, picks, pick_phases, mag=None):
        self.pos_cart = np.asarray(pos_cart)
        self.time = float(time)
        self.picks = np.asarray(picks, np.int64)
        self.pick_phases = np.asarray(pick_phases)
        self.cov = None
        self.mag = mag


def make_detector(cfg: dict) -> Detector:
    m = cfg["model"]
    return Detector(scale_rel=m["scale_rel"], kernel_sig_t=m["kernel_sig_t"],
                    use_phase_types=m["use_phase_types"],
                    use_absolute_pos=m["use_absolute_pos"],
                    use_updated_model_definition=m["use_updated_model_definition"],
                    normalize_readin=m["normalize_readin"])


def local_marching(cands, values, tc_win: float, sp_win: float,
                   n_steps: int = 100, tol: float = 1e-12):
    """Indices of the local maxima of ``values`` over the ε-graph of
    candidates within ``tc_win`` in time and ``sp_win`` in space (directed
    max-flooding to a fixed point)."""
    n = len(cands)
    if n <= 1:
        return np.zeros(n, np.int64)
    pos = np.asarray(cands[:, :3], np.float64)
    t = np.asarray(cands[:, 3], np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(t, kind="stable")
    ts, ps, vs = t[order], pos[order], values[order]
    lo = np.searchsorted(ts, ts - tc_win, side="left")
    hi = np.searchsorted(ts, ts + tc_win, side="right")
    w = int((hi - lo).max())
    band = lo[:, None] + np.arange(w)[None, :]
    valid = band < hi[:, None]
    band = np.minimum(band, n - 1)
    d2 = ((ps[band] - ps[:, None, :]) ** 2).sum(-1)
    ok = valid & (d2 < sp_win ** 2) & (vs[band] >= vs[:, None])
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(ok.sum(1), out=indptr[1:])
    cols = band[ok]
    v = vs.copy()
    for _ in range(n_steps):
        flooded = np.maximum.reduceat(v[cols], indptr[:-1])
        if np.abs(flooded - v).max() <= tol:
            v = flooded
            break
        v = flooded
    keep = np.where(np.abs(v - vs) <= tol * np.maximum(1, np.abs(vs)))[0]
    return np.sort(order[keep]).astype(np.int64)


class Pipeline:
    """The deployment's stages over one domain, on one device."""

    def __init__(self, cfg: dict, dom: Domain, model: Detector, trv_from_cart,
                 x_query, mag=None, n_t: int = 9, trv_loc=None):
        self.cfg = cfg
        self.dom = dom
        self.model = model.eval()
        self.trv = trv_from_cart
        self.trv_loc = trv_loc or trv_from_cart
        self.sta_loc = dom.sta_cart.to(torch.float64 if trv_loc else torch.float32)
        self.mag = mag
        self.n_t = n_t
        self.dev = dom.sta_cart.device
        g, m = cfg["graph"], cfg["model"]
        self.n_grids = int(dom.grids_cart.shape[0])
        self.max_t = float(dom.trv_grids.max())
        n_sta = dom.sta_cart.shape[0]
        self.sta_mask = torch.ones(n_sta, dtype=torch.bool, device=self.dev)
        nbr, valid = knn_graph(dom.sta_cart / 1000.0, g["k_sta_edges"], self.sta_mask)
        self.graphs = [GraphBundle(
            sta_nbr=nbr, sta_nbr_valid=valid, src_nbr=dom.src_nbr[i],
            sta_mask=self.sta_mask, edge_feat=dom.edge_feat[i],
            src_pos=dom.grids_cart[i], time_ptr_p=dom.time_ptr_p[i],
            time_ptr_s=dom.time_ptr_s[i],
            dt0=torch.tensor(dom.dt0, dtype=torch.float32, device=self.dev),
            dt=torch.tensor(dom.dt, dtype=torch.float32, device=self.dev),
            trv=dom.trv_grids[i]) for i in range(self.n_grids)]
        self.x_query = torch.as_tensor(np.asarray(x_query, np.float32), device=self.dev)
        self.t_query = torch.linspace(-m["t_win"] / 2, m["t_win"] / 2, n_t,
                                      device=self.dev)[:, None]
        self.xq_idx = [query_attachment(dom.grids_cart[i], self.x_query,
                                        g["k_spatial_attn"])
                       for i in range(self.n_grids)]

    # -- windows and features -------------------------------------------------
    def window_picks(self, pick_t, pick_sta, pick_phase, t0):
        """One window's padded picks (centre-priority on overflow, then
        (station, time) order) and their day indices."""
        n_pick = self.cfg["graph"]["max_picks"]
        t_win = self.cfg["model"]["t_win"]
        rel = pick_t - t0
        sel = np.where((rel > -10.0) & (rel < t_win + self.max_t + 10.0))[0]
        if len(sel) > n_pick:
            prio = -np.abs(rel[sel] - t_win / 2)
            sel = sel[np.argsort(-prio)[:n_pick]]
        sel = sel[np.lexsort((rel[sel], pick_sta[sel]))]
        tp = np.zeros(n_pick, np.float32)
        ip = np.zeros(n_pick, np.int32)
        ph = np.zeros((n_pick, 1), np.float32)
        pm = np.zeros(n_pick, bool)
        tp[:len(sel)] = rel[sel]
        ip[:len(sel)] = pick_sta[sel]
        ph[:len(sel), 0] = pick_phase[sel]
        pm[:len(sel)] = True
        return tp, ip, ph, pm, sel

    def to_device(self, wins):
        return tuple(torch.as_tensor(np.stack([w[i] for w in wins]), device=self.dev)
                     for i in range(4))

    def featurize(self, tpick, ipick, phase, pick_mask, grid: int):
        """Rasterize picks into per-station series (bins of σ/10) by
        scatter-max of Gaussian bumps, then read each (source, station,
        phase) at its travel-time bin."""
        sig = float(self.cfg["train"]["src_t_kernel"])
        trv_grid = self.dom.trv_grids[grid]
        t_lo = -10.0
        t_hi = float(self.cfg["model"]["t_win"] + self.max_t + 10.0)
        dt = sig / 10.0
        n_bins = int(np.ceil((t_hi - t_lo) / dt)) + 1
        B = tpick.shape[0]
        n_sta = trv_grid.shape[1]
        offs = torch.arange(-50, 51, device=tpick.device, dtype=torch.int32)
        bins = torch.round((tpick - t_lo) / dt).to(torch.int32)[..., None] + offs
        bump = torch.exp(-0.5 * ((t_lo + bins * dt - tpick[..., None]) / sig) ** 2)
        in_range = (bins >= 0) & (bins < n_bins)
        flat_all = ipick.to(torch.int64)[..., None] * n_bins + bins

        def series(valid):
            ok = valid[..., None] & in_range
            flat = torch.where(ok, flat_all, torch.zeros_like(flat_all)).reshape(B, -1)
            vals = torch.where(ok, bump, torch.zeros_like(bump)).reshape(B, -1)
            s = torch.zeros((B, n_sta * n_bins), dtype=tpick.dtype, device=tpick.device)
            return s.scatter_reduce_(1, flat, vals, "amax", include_self=True)

        s_any = series(pick_mask)
        s_p = series(pick_mask & (phase[..., 0] < 0.5))
        s_s = series(pick_mask & (phase[..., 0] > 0.5))
        base = torch.arange(n_sta, device=tpick.device)[None, :] * n_bins

        def gather(s, ph):
            idx = torch.clamp(torch.round((trv_grid[:, :, ph] - t_lo) / dt), 0,
                              n_bins - 1).to(torch.int32)
            return s[:, (base + idx).reshape(-1)].reshape(B, *idx.shape)

        feat = torch.stack((gather(s_any, 0), gather(s_any, 1),
                            gather(s_p, 0), gather(s_s, 1)), dim=-1)
        return feat, (feat.abs() > 0.01).to(feat.dtype)

    # -- stage 1: the detection sweep ---------------------------------------
    @torch.no_grad()
    def detection_sweep(self, pick_t, pick_sta, pick_phase, t_start, t_end,
                        window_batch: int = 16):
        """(times (n_bins,), series (n_q, n_bins)): every non-empty window's
        query scores, averaged over the grids and over overlapping windows."""
        cfg = self.cfg
        t_win = cfg["model"]["t_win"]
        grids = [0] if cfg["process"]["use_only_one_grid"] else list(range(self.n_grids))
        step = t_win / cfg["process"]["step_size"]
        t0s = np.arange(t_start, t_end, step)
        t_rel = np.linspace(-t_win / 2, t_win / 2, self.n_t)
        dt_axis = t_rel[1] - t_rel[0]
        t_min = t_start - t_win / 2
        n_bins = int(np.round((t_end + t_win / 2 - t_min) / dt_axis)) + 1
        acc = np.zeros((n_bins, self.x_query.shape[0]), np.float32)
        cnt = np.zeros(n_bins, np.float32)
        idx, data = [], []
        for w, t0 in enumerate(t0s):
            tp, ip, ph, pm, _ = self.window_picks(pick_t, pick_sta, pick_phase, t0)
            if pm.sum():
                idx.append(w)
                data.append((tp, ip, ph, pm))
        for s in range(0, len(idx), window_batch):
            tp, ip, ph, pm = self.to_device(data[s:s + window_batch])
            out = None
            for g in grids:
                feat, fmask = self.featurize(tp, ip, ph, pm, g)
                _, x = self.model.forward_detection_only(
                    feat, fmask, self.graphs[g], self.dom.sta_cart, self.x_query,
                    self.xq_idx[g], self.t_query)
                out = x[..., 0] if out is None else out + x[..., 0]
            out = (out / len(grids)).cpu().numpy()
            for j, w in enumerate(idx[s:s + window_batch]):
                bins = np.round((t0s[w] + t_rel - t_min) / dt_axis).astype(np.int64)
                acc[bins] += out[j].T
                cnt[bins] += 1.0
        series = (acc / np.maximum(cnt, 1.0)[:, None]).T
        return t_min + dt_axis * np.arange(n_bins), series

    # -- stages 2-3: candidates -------------------------------------------
    def candidates(self, times_s, series):
        """Peaks of each query node's series above ``thresh``, at least
        1.5 σ apart, clustered by local maxima in each time group: (srcs (n,
        4) of x, y, z, t; values (n,))."""
        p = self.cfg["process"]
        dt_axis = times_s[1] - times_s[0] if len(times_s) > 1 else 1.0
        spacing = max(1, int(1.5 * self.cfg["train"]["src_t_kernel"] / max(dt_axis, 1e-6)))
        xq = self.x_query.cpu().numpy()
        rows = [(xq[q, 0], xq[q, 1], xq[q, 2], times_s[i], series[q, i])
                for q in range(series.shape[0])
                for i in rassign.find_peaks_1d(series[q], p["thresh"], spacing)]
        if not rows:
            return np.zeros((0, 4)), np.zeros(0)
        cands = np.array(rows)
        cands, vals = cands[:, :4], cands[:, 4]
        pos, val = [], []
        for g in rassign.split_time_groups(cands[:, 3], p["break_win"]):
            keep = local_marching(cands[g], vals[g], p["tc_win"], p["sp_win"])
            pos.append(cands[g][keep])
            val.append(vals[g][keep])
        return np.concatenate(pos), np.concatenate(val)

    def association_groups(self, srcs):
        """The refined sources' groups, each in time order, as association
        takes them."""
        out = []
        for g in rassign.split_time_groups(srcs[:, 3], self.cfg["process"]["break_win"]):
            out.append(g[np.argsort(srcs[g, 3])])
        return out

    def assign_picks(self, pick_t, pick_sta, pick_phase, srcs, w_p, w_s):
        """A group's events from its per-source weights (``w_p``, ``w_s``
        (n_live, max_picks), the sources whose window holds a pick, in
        order): weights above ``thresh_assoc`` gathered over the union of
        the windows' picks, then assigned. Returns [(pos, time, picks,
        phases)]."""
        p = self.cfg["process"]
        sels, live = [], []
        for i in range(len(srcs)):
            _, _, _, pm, sel = self.window_picks(pick_t, pick_sta, pick_phase, srcs[i, 3])
            if pm.sum():
                sels.append(sel)
                live.append(i)
        if not live:
            return []
        gids = np.array(sorted({int(g) for sel in sels for g in sel}), np.int64)
        col = {g: j for j, g in enumerate(gids)}
        W = np.zeros((len(live), len(gids), 2), np.float32)
        thr = p["thresh_assoc"]
        for r, sel in enumerate(sels):
            n = len(sel)
            cols = [col[int(g)] for g in sel]
            W[r, cols, 0] = np.maximum(W[r, cols, 0], np.where(w_p[r, :n] > thr,
                                                               w_p[r, :n], 0.0))
            W[r, cols, 1] = np.maximum(W[r, cols, 1], np.where(w_s[r, :n] > thr,
                                                               w_s[r, :n], 0.0))
        rows = np.asarray(live)
        events = rassign.assign_events(W, pick_sta[gids], srcs[rows, :3], srcs[rows, 3],
                                       p["cost_assignment"], p["max_sources_per_component"],
                                       p["max_splits"])
        return [(srcs[live[q], :3].copy(), float(srcs[live[q], 3]), gids[cols], phases)
                for q, cols, phases in events]

    # -- stage 4: refinement --------------------------------------------------
    @torch.no_grad()
    def refine_sources(self, pick_t, pick_sta, pick_phase, srcs, vals,
                       seed: int = 0, batch: int = 8, grid: int = 0):
        """Per candidate: the trunk over its window once, then ``n_rand_query``
        random offsets (N(0, σ), σ = (sp_win, sp_win, sp_win/2); row 0 of
        each chunk the candidate itself) through the query head, keeping the
        best (position, time) where it beats the candidate's value."""
        cfg = self.cfg
        if len(srcs) == 0:
            return srcs, vals
        p = cfg["process"]
        n_rand, chunk = p["n_rand_query"], p["refine_chunk"]
        t_win = cfg["model"]["t_win"]
        out, vals = srcs.copy(), vals.copy()
        t_rel_ax = np.linspace(-t_win / 2, t_win / 2, self.n_t)
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))
        graph = self.graphs[grid]
        sig = torch.tensor([p["sp_win"], p["sp_win"], 0.5 * p["sp_win"]],
                           device=self.dev)
        win, live = [], []
        for i in range(len(srcs)):
            tp, ip, ph, pm, _ = self.window_picks(pick_t, pick_sta, pick_phase,
                                                  srcs[i, 3])
            if pm.sum():
                win.append((tp, ip, ph, pm))
                live.append(i)
        for s in range(0, len(live), batch):
            sel = live[s:s + batch]
            tp, ip, ph, pm = self.to_device(win[s:s + batch])
            pos0 = torch.as_tensor(srcs[sel, :3].astype(np.float32), device=self.dev)
            best_val = torch.as_tensor(vals[sel].astype(np.float32), device=self.dev)
            feat, fmask = self.featurize(tp, ip, ph, pm, grid)
            x_spatial, _ = self.model.forward_trunk(feat, fmask, graph, self.dom.sta_cart)
            B = pos0.shape[0]
            rows = torch.arange(B, device=self.dev)
            best_pos = pos0.clone()
            best_ti = torch.full((B,), self.n_t // 2, dtype=torch.int64, device=self.dev)
            for _ in range(-(-n_rand // chunk)):
                offs = torch.randn((B, chunk, 3), generator=gen, device=self.dev) * sig
                offs[:, 0] = 0.0
                xq = pos0[:, None] + offs
                xq_idx = query_attachment(self.dom.grids_cart[grid], xq,
                                          cfg["graph"]["k_spatial_attn"])
                x = self.model.forward_query_head(x_spatial, graph, xq, xq_idx,
                                                  self.t_query)[..., 0]
                flat = torch.argmax(x.reshape(B, -1), dim=1)
                qi, ti = flat // x.shape[2], flat % x.shape[2]
                v = x[rows, qi, ti]
                better = v > best_val
                best_pos = torch.where(better[:, None], xq[rows, qi], best_pos)
                best_ti = torch.where(better, ti, best_ti)
                best_val = torch.where(better, v, best_val)
            bp, bt, bv = (a.cpu().numpy() for a in (best_pos, best_ti, best_val))
            for j, i in enumerate(sel):
                if bv[j] > vals[i]:
                    out[i, :3] = bp[j]
                    out[i, 3] = srcs[i, 3] + t_rel_ax[bt[j]]
                    vals[i] = bv[j]
        return out, vals

    # -- stage 5: association weights --------------------------------------
    @torch.no_grad()
    def association_weights(self, pick_t, pick_sta, pick_phase, srcs,
                            batch: int = 16, grid: int = 0):
        """Per source (n, 4), in its own window anchored at its time: the
        full forward's P and S weights of every pick of the window, (n_live,
        max_picks) each, with the rows of the sources whose window holds a
        pick (``live``) and the window's pick count."""
        cfg = self.cfg
        graph = self.graphs[grid]
        wins, live = [], []
        for i in range(len(srcs)):
            tp, ip, ph, pm, _ = self.window_picks(pick_t, pick_sta, pick_phase,
                                                  srcs[i, 3])
            if pm.sum():
                wins.append((tp, ip, ph, pm))
                live.append(i)
        n_pick = cfg["graph"]["max_picks"]
        w_p = np.zeros((len(live), n_pick), np.float32)
        w_s = np.zeros((len(live), n_pick), np.float32)
        counts = np.array([int(w[3].sum()) for w in wins], np.int64)
        for s in range(0, len(live), batch):
            sel = live[s:s + batch]
            tp, ip, ph, pm = self.to_device(wins[s:s + batch])
            x_qsrc = torch.as_tensor(srcs[sel, :3].astype(np.float32),
                                     device=self.dev)[:, None, :]
            tq = torch.zeros((len(sel), 1), device=self.dev)
            feat, fmask = self.featurize(tp, ip, ph, pm, grid)
            pair_idx, pair_valid = pair_table(tp, ip, pm, cfg["graph"]["k_pick_pairs"])
            picks = PickSet(tp, ip, ph, pm, pair_idx, pair_valid)
            xqs_idx = query_attachment(self.dom.grids_cart[grid], x_qsrc,
                                       cfg["graph"]["k_spatial_attn"])
            queries = QuerySet(x_query=x_qsrc, x_query_idx=xqs_idx, t_query=self.t_query,
                               x_qsrc=x_qsrc, x_qsrc_idx=xqs_idx, tq_sample=tq,
                               trv_qsrc=self.trv(self.dom.sta_cart, x_qsrc))
            _, _, arv_p, arv_s = self.model(feat, fmask, graph, self.dom.sta_cart,
                                            picks, queries)
            w_p[s:s + len(sel)] = arv_p[:, 0, :, 0].cpu().numpy()
            w_s[s:s + len(sel)] = arv_s[:, 0, :, 0].cpu().numpy()
        return w_p, w_s, np.asarray(live, np.int64), counts

    # -- stages 7-8: location, QC, duplicates, magnitudes -------------------
    @torch.no_grad()
    def _objective(self, tpick, ipick, phase, pick_mask, trim_fraction: float):
        n_pick = tpick.shape[1]
        n_valid = pick_mask.sum(dim=1)
        n_keep = n_valid - torch.floor(trim_fraction * n_valid).to(n_valid.dtype)
        ip = ipick.long()
        ph = phase[..., 0].long()
        rank = torch.arange(n_pick, device=tpick.device)
        sta = self.sta_loc

        def objective(cand):
            n_ev, pop = cand.shape[:2]
            trv = self.trv_loc(sta, cand[..., :3])
            idx = ip[:, None, :, None].expand(n_ev, pop, n_pick, 2)
            t_theory = torch.gather(trv, 2, idx)
            t_ph = torch.gather(t_theory, 3,
                                ph[:, None, :, None].expand(n_ev, pop, n_pick, 1))[..., 0]
            res = (tpick[:, None, :] - (t_ph + cand[..., 3:4])).abs()
            res = torch.where(pick_mask[:, None, :], res,
                              torch.full_like(res, float("inf")))
            res_sorted = torch.sort(res, dim=2).values
            keep = rank[None, None, :] < n_keep[:, None, None]
            v = torch.where(keep & torch.isfinite(res_sorted), res_sorted,
                            torch.zeros_like(res_sorted))
            return v.sum(dim=2) / torch.clamp_min(n_keep, 1)[:, None]

        return objective

    @torch.no_grad()
    def _de(self, fn, lo, hi, n_ev, gen, popsize=128, n_iter=150, f_w=0.6, cr=0.9):
        d = lo.shape[0]
        dev = lo.device

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=dev).to(lo.dtype)

        def randint(top, *shape):
            return torch.randint(0, top, shape, generator=gen, device=dev)

        def take(pop, i):
            return torch.gather(pop, 1, i[..., None].expand(n_ev, popsize, d))

        pop = lo + (hi - lo) * rand(n_ev, popsize, d)
        cost = fn(pop)
        dims = torch.arange(d, device=dev)
        for _ in range(n_iter):
            a, b, c = (randint(popsize, n_ev, popsize) for _ in range(3))
            mutant = take(pop, a) + f_w * (take(pop, b) - take(pop, c))
            mutant = torch.minimum(torch.maximum(mutant, lo), hi)
            cross = rand(n_ev, popsize, d) < cr
            cross = cross | (dims == randint(d, n_ev, popsize)[..., None])
            trial = torch.where(cross, mutant, pop)
            c_trial = fn(trial)
            better = c_trial < cost
            pop = torch.where(better[..., None], trial, pop)
            cost = torch.where(better, c_trial, cost)
        ib = torch.argmin(cost, dim=1)
        return pop[torch.arange(n_ev, device=dev), ib]

    def _covariance(self, pos, t0, tpick, ipick, phase, pick_mask):
        ip = ipick.long()
        ph = phase[..., 0].long()
        sta = self.sta_loc

        def resid(x, tp, ip_e, ph_e):
            trv = self.trv_loc(sta, x[None, :3])[0]
            t_ph = torch.gather(trv[ip_e], 1, ph_e[:, None])[:, 0]
            return tp - (t_ph + x[3])

        x = torch.cat((pos, t0[:, None]), dim=1)
        J = torch.func.vmap(torch.func.jacfwd(resid))(x, tpick, ip, ph)
        J = J * pick_mask[..., None]
        JtJ = J.transpose(1, 2) @ J
        eye = torch.eye(4, dtype=JtJ.dtype, device=JtJ.device)
        return torch.linalg.pinv(JtJ + 1e-8 * eye,
                                 rtol=10.0 * 4 * torch.finfo(torch.float32).eps)

    def _locate_batch(self, evs, pick_t, pick_sta, gen, max_batch: int = 256):
        dom = self.dom
        dt = self.sta_loc.dtype
        lo = torch.cat((dom.offset_cart, torch.tensor([-30.0], device=self.dev))).to(dt)
        hi = torch.cat((dom.offset_cart + dom.scale_cart,
                        torch.tensor([30.0], device=self.dev))).to(dt)
        trim = self.cfg["process"]["trim_fraction"]
        for s in range(0, len(evs), max_batch):
            chunk = evs[s:s + max_batch]
            L = max(len(ev.picks) for ev in chunk)
            tp = np.zeros((len(chunk), L), np.float64)
            ip = np.zeros((len(chunk), L), np.int32)
            ph = np.zeros((len(chunk), L, 1), np.float32)
            mk = np.zeros((len(chunk), L), bool)
            for r, ev in enumerate(chunk):
                n = len(ev.picks)
                tp[r, :n] = pick_t[ev.picks] - ev.time
                ip[r, :n] = pick_sta[ev.picks]
                ph[r, :n, 0] = ev.pick_phases
                mk[r, :n] = True
            tp = torch.as_tensor(tp, dtype=dt, device=self.dev)
            ip, ph, mk = (torch.as_tensor(a, device=self.dev) for a in (ip, ph, mk))
            x = self._de(self._objective(tp, ip, ph, mk, trim), lo, hi, len(chunk), gen)
            pos, t0 = x[:, :3], x[:, 3]
            cov = self._covariance(pos, t0, tp, ip, ph, mk)
            pos, t0, cov = pos.cpu().numpy(), t0.cpu().numpy(), cov.cpu().numpy()
            for r, ev in enumerate(chunk):
                ev.pos_cart = pos[r].copy()
                ev.time = ev.time + float(t0[r])
                ev.cov = cov[r]

    @torch.no_grad()
    def _residuals(self, ev, pick_t, pick_sta):
        pos = torch.as_tensor(np.asarray(ev.pos_cart)[None], dtype=self.sta_loc.dtype,
                              device=self.dev)
        tt = self.trv_loc(self.sta_loc, pos)[0].cpu().numpy()
        pred = tt[pick_sta[ev.picks], ev.pick_phases.astype(np.int64)]
        return (pick_t[ev.picks] - ev.time) - pred

    @torch.no_grad()
    def location_cost(self, pos, time, picks, phases, pick_t, pick_sta) -> float:
        """The location objective (trimmed mean |residual|, s) of an event at
        ``pos`` and origin ``time`` with its picks."""
        dt = self.sta_loc.dtype
        tp = torch.as_tensor((pick_t[picks] - time)[None], dtype=dt, device=self.dev)
        ip = torch.as_tensor(pick_sta[picks][None], device=self.dev)
        ph = torch.as_tensor(np.asarray(phases, np.float32)[None, :, None], device=self.dev)
        mk = torch.ones_like(ip, dtype=torch.bool)
        fn = self._objective(tp, ip, ph, mk, self.cfg["process"]["trim_fraction"])
        x = torch.zeros((1, 1, 4), dtype=dt, device=self.dev)
        x[0, 0, :3] = torch.as_tensor(np.asarray(pos, np.float64), dtype=dt)
        return float(fn(x)[0, 0])

    def locate(self, events, pick_t, pick_sta, seed: int = 0, qc_mult: float = 3.0,
               qc_min: float = 1.5, max_sigma_xy: float = 60e3,
               max_sigma_t: float = 15.0):
        """DE location of the eligible events, residual QC with one
        re-location, then the covariance cut."""
        p = self.cfg["process"]
        gen = torch.Generator(device=self.dev).manual_seed(int(seed))

        def eligible(ev):
            return (len(ev.picks) >= p["min_required_picks"] and
                    len(np.unique(pick_sta[ev.picks])) >= p["min_required_sta"])

        evs = [ev for ev in events if eligible(ev)]
        self._locate_batch(evs, pick_t, pick_sta, gen)
        survivors, redo = [], []
        for ev in evs:
            res = self._residuals(ev, pick_t, pick_sta)
            sigma = 1.4826 * np.median(np.abs(res - np.median(res))) + 1e-6
            keep = np.abs(res) <= max(qc_mult * sigma, qc_min)
            if keep.sum() < len(keep):
                ev.picks = ev.picks[keep]
                ev.pick_phases = ev.pick_phases[keep]
                if not eligible(ev):
                    continue
                redo.append(ev)
            survivors.append(ev)
        self._locate_batch(redo, pick_t, pick_sta, gen)
        out = []
        for ev in survivors:
            if ev.cov is not None and np.all(np.isfinite(ev.cov)):
                sig = np.sqrt(np.maximum(np.diag(ev.cov), 0.0))
                if sig[:2].max() > max_sigma_xy or sig[3] > max_sigma_t:
                    continue
            out.append(ev)
        return out

    def dedup(self, events):
        if len(events) <= 1:
            return events
        p = self.cfg["process"]
        cands = np.array([[*ev.pos_cart, ev.time] for ev in events])
        vals = np.array([len(ev.picks) for ev in events], float)
        keep = local_marching(cands, vals, 2 * p["tc_win"], p["sp_win"])
        out, seen = [], set()
        for i in keep:
            k = (round(float(cands[i, 0]) / 1e3), round(float(cands[i, 1]) / 1e3),
                 round(float(cands[i, 3]) / p["tc_win"]))
            if k not in seen:
                seen.add(k)
                out.append(events[i])
        return out

    @torch.no_grad()
    def magnitudes(self, events, pick_sta, pick_amp, margin: float = 1.5):
        """Median inverted magnitude over each event's picks with a positive
        amplitude, then drop picks beyond ``margin`` × the distance its
        magnitude allows and re-apply the pick and station minimums."""
        if self.mag is None or pick_amp is None:
            return events
        rows, src, phase, owner = [], [], [], []
        for i, ev in enumerate(events):
            ok = pick_amp[ev.picks] > 0
            if ok.any():
                rows.append(ev.picks[ok])
                phase.append(np.asarray(ev.pick_phases)[ok])
                src.append(np.repeat(np.asarray(ev.pos_cart, np.float64)[None],
                                     ok.sum(), 0))
                owner.append(i)
        if rows:
            picks = np.concatenate(rows)
            log_amp = np.log10(np.maximum(pick_amp[picks], 1e-12)).astype(np.float32)
            dev, dt = self.dev, self.sta_loc.dtype
            mags = self.mag["model"](
                torch.as_tensor(np.concatenate(src), dtype=dt, device=dev), self.sta_loc,
                self.mag["grid_cart"], torch.as_tensor(pick_sta[picks], device=dev),
                torch.as_tensor(np.concatenate(phase).astype(np.int64), device=dev),
                log_amp=torch.as_tensor(log_amp, dtype=dt, device=dev)).cpu().numpy()
            bounds = np.cumsum([0] + [len(r) for r in rows])
            for j, i in enumerate(owner):
                events[i].mag = float(np.median(mags[bounds[j]:bounds[j + 1]]))
        dm = self.mag.get("dist_model")
        if dm is None:
            return events
        p = self.cfg["process"]
        sta = self.dom.sta_cart.cpu().numpy()
        out = []
        for ev in events:
            if ev.mag is None or not np.isfinite(ev.mag):
                out.append(ev)
                continue
            d_max = margin * float(magnitude_distance(dm, ev.mag))
            d = np.linalg.norm(sta[pick_sta[ev.picks], :2] - ev.pos_cart[None, :2], axis=1)
            keep = d <= d_max
            if not keep.all():
                ev.picks = ev.picks[keep]
                ev.pick_phases = ev.pick_phases[keep]
                if (len(ev.picks) < p["min_required_picks"] or
                        len(np.unique(pick_sta[ev.picks])) < p["min_required_sta"]):
                    continue
            out.append(ev)
        return out
