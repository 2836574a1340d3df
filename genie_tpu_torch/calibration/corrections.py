"""Travel-time calibration: interpolated station/phase corrections.

Port of ``genie_tpu/calibration/corrections.py``: the kNN,
Gaussian-weighted, anisotropic and inverse-distance interpolators of
per-(grid node, station, phase) coefficient fields, the random-walk graph
Laplacian, :class:`TravelTimeCorrection` (a travel-time callable plus the
interpolated corrections), the matched-catalog statistics,
:func:`fit_corrections` (Adam on the corrections) and
:func:`relocation_benchmark` (DE relocation of matched events).

Sources are ``(n_src, 3)`` tensors; coefficient fields ``(n_grid, …)``.
"""

from __future__ import annotations

import numpy as np
import torch

from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.infer.assign import maximize_bipartite_assignment
from genie_tpu_torch.ops.knn import knn, knn_graph


def _weighted_sum(coefs, idx, w):
    """Σ_k w[n, k]·coefs[idx[n, k]] → (n, …)."""
    n, k = idx.shape
    g = coefs[idx.long()].reshape(n, k, -1)              # (n, k, Π…)
    return torch.einsum("nk,nkc->nc", w, g).reshape(n, *coefs.shape[1:])


def interp_knn_mean(grid_cart, coefs, src_cart, k: int = 5):
    """kNN mean interpolation: coefs (n_grid, …) → (n_src, …)."""
    idx, _ = knn(grid_cart / 1000.0, src_cart / 1000.0, k)
    return coefs[idx.long()].mean(dim=1)


def _gaussian_weights(grid_cart, src_cart, k: int = 5, sig: float = 15e3):
    """The k nearest grid nodes of each source and their normalized
    Gaussian weights: ``(idx, w)``, each (n_src, k)."""
    idx, _ = knn(grid_cart / 1000.0, src_cart / 1000.0, k)
    d2 = ((src_cart[:, None, :] - grid_cart[idx.long()]) ** 2).sum(-1)
    w = torch.exp(-0.5 * d2 / sig ** 2)
    return idx, w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)


def interp_weighted(grid_cart, coefs, src_cart, k: int = 5, sig: float = 15e3):
    """Gaussian-weight normalized interpolation over the k nearest nodes."""
    return _weighted_sum(coefs, *_gaussian_weights(grid_cart, src_cart, k, sig))


def interp_anisotropic(grid_cart, coefs, src_cart, kernels, k: int = 5):
    """Anisotropic interpolation with per-node 3-axis kernel widths
    (``kernels`` (n_grid, 3), softplus-scaled, plus 1 km)."""
    idx, _ = knn(grid_cart / 1000.0, src_cart / 1000.0, k)
    sig = torch.nn.functional.softplus(kernels[idx.long()]) + 1e3   # (n_src, k, 3)
    d2 = (((src_cart[:, None, :] - grid_cart[idx.long()]) / sig) ** 2).sum(-1)
    w = torch.exp(-0.5 * d2)
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return _weighted_sum(coefs, idx, w)


def interp_scattered(points, values, query, k: int = 8, p: float = 2.0):
    """Inverse-distance-weighted interpolation of scattered ``values``."""
    idx, _ = knn(points, query, min(k, points.shape[0]))
    d = torch.linalg.norm(query[:, None, :] - points[idx.long()], dim=-1)
    w = 1.0 / torch.clamp_min(d, 1e-6) ** p
    w = w / w.sum(dim=1, keepdim=True)
    return _weighted_sum(values, idx, w)


def rw_laplacian_apply(x, nbr):
    """Random-walk-normalized graph Laplacian: (L x)_i = x_i − mean_j x_j
    over the kNN graph ``nbr`` (n, k)."""
    return x - x[nbr.long()].mean(dim=1)


class TravelTimeCorrection:
    """A travel-time callable plus interpolated corrections. ``from_cart``
    keeps the port's contract, ``(…, n_src, 3)`` sources → ``(…, n_src,
    n_sta, 2)``: the sources are flattened once for the kNN and the
    coefficient gather, then the leading shape is restored."""

    def __init__(self, base_trv_from_cart, grid_cart, coefs, kernels=None, k: int = 5):
        self.base = base_trv_from_cart
        self.grid_cart = torch.as_tensor(grid_cart, dtype=torch.float32)
        self.coefs = torch.as_tensor(coefs, dtype=torch.float32)   # (n_grid, n_sta, 2)
        self.kernels = (None if kernels is None
                        else torch.as_tensor(kernels, dtype=torch.float32))
        self.k = k

    def to(self, device) -> "TravelTimeCorrection":
        self.grid_cart = self.grid_cart.to(device)
        self.coefs = self.coefs.to(device)
        if self.kernels is not None:
            self.kernels = self.kernels.to(device)
        return self

    def _corr(self, src_cart):
        flat = src_cart.reshape(-1, 3)
        if self.kernels is not None:
            c = interp_anisotropic(self.grid_cart, self.coefs, flat, self.kernels,
                                   self.k)
        else:
            c = interp_weighted(self.grid_cart, self.coefs, flat, self.k)
        return c.reshape(*src_cart.shape[:-1], *self.coefs.shape[1:])

    def from_cart(self, sta_cart, src_cart):
        return self.base(sta_cart, src_cart) + self._corr(src_cart)

    def pairwise_from_cart(self, sta_cart, src_cart, sta_idx):
        """As :meth:`from_cart`; the caller slices the stations."""
        return self.from_cart(sta_cart, src_cart)


def matched_catalog_stats(srcs_det, srcs_ref, sig_x=15e3, sig_t=5.0,
                          mags_ref=None, mag_bins=(1.0, 2.0, 3.0, 4.0)):
    """Detection rate and residual statistics against a reference catalog
    through optimal bipartite matching. srcs_*: (n, 4) Cartesian + time."""
    ia, ib = maximize_bipartite_assignment(srcs_det, srcs_ref, sig_x, sig_t)
    stats = {
        "n_detected": len(srcs_det),
        "n_reference": len(srcs_ref),
        "n_matched": len(ia),
        "detection_rate": len(ia) / max(len(srcs_ref), 1),
    }
    if len(ia):
        d = srcs_det[ia] - srcs_ref[ib]
        stats["residual_xy_mean"] = float(np.linalg.norm(d[:, :2], axis=1).mean())
        stats["residual_xy_std"] = float(np.linalg.norm(d[:, :2], axis=1).std())
        stats["residual_z_mean"] = float(np.abs(d[:, 2]).mean())
        stats["residual_t_mean"] = float(np.abs(d[:, 3]).mean())
    if mags_ref is not None:
        for m in mag_bins:
            sel = np.where(mags_ref >= m)[0]
            hit = len(set(sel) & set(ib.tolist()))
            stats[f"detection_rate_M{m:g}"] = hit / max(len(sel), 1)
            stats[f"n_matched_M{m:g}"] = hit
            stats[f"n_reference_M{m:g}"] = int(len(sel))
    return stats


def fit_corrections(base_trv_from_cart, sta_cart, grid_cart, src_cart, obs_times,
                    obs_mask, k_lap: int = 8, n_steps: int = 1000, lr: float = 1e-2,
                    w_smooth: float = 1.0, w_norm: float = 0.1, device=None):
    """Fit per-(grid node, station, phase) corrections on matched reference
    events by Adam on MSE(base + interpolated corrections, observed) plus
    ``w_smooth`` × the squared random-walk Laplacian over the grid's kNN
    graph plus ``w_norm`` × the squared coefficients.

    src_cart (n_ev, 3) reference positions; obs_times/obs_mask (n_ev, n_sta,
    2) origin-corrected arrivals. Runs on ``device`` (default ``cuda``).
    Returns (coefs (n_grid, n_sta, 2), the loss of the last step)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    sta_cart, grid_cart, src_cart = t(sta_cart), t(grid_cart), t(src_cart)
    obs_times, obs_mask = t(obs_times), t(obs_mask)
    n_grid, n_sta = grid_cart.shape[0], sta_cart.shape[0]
    coefs = torch.zeros((n_grid, n_sta, 2), device=dev, requires_grad=True)
    nbr, _ = knn_graph(grid_cart / 1000.0, min(k_lap, n_grid - 1))
    with torch.no_grad():
        pred_base = base_trv_from_cart(sta_cart, src_cart)
    # the interpolation's nodes and weights depend on the sources only
    idx, w = _gaussian_weights(grid_cart, src_cart)
    n_obs = torch.clamp_min(obs_mask.sum(), 1.0)

    def loss_fn(c):
        pred = pred_base + _weighted_sum(c, idx, w)
        mse = (((pred - obs_times) ** 2) * obs_mask).sum() / n_obs
        lap = rw_laplacian_apply(c, nbr)
        return mse + w_smooth * (lap ** 2).mean() + w_norm * (c ** 2).mean()

    opt = torch.optim.Adam([coefs], lr=lr)
    loss = None
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(coefs)
        loss.backward()
        opt.step()
    return coefs.detach(), (float("nan") if loss is None else float(loss.detach()))


def nanmedian(x, dim: int):
    """``jnp.nanmedian`` along ``dim``: the mean of the two middle values
    of an even count (``torch.nanmedian`` takes the lower one)."""
    return torch.nanquantile(x, 0.5, dim=dim, interpolation="midpoint")


def relocation_benchmark(generator, trv_from_cart, sta_cart, srcs_init, srcs_target,
                         pick_t, pick_sta, pick_phase, pick_event, bounds_lo, bounds_hi,
                         grid_cart=None, bias_radius: float = 75e3, max_picks: int = 64,
                         popsize: int = 96, n_iter: int = 120, device=None):
    """Relocate matched events with a (corrected) travel-time model and
    report the residual and local-bias improvement.

    srcs_init/srcs_target (n_ev, 4) Cartesian + time (detected vs
    reference); pick_* flat pick arrays, ``pick_event`` giving each pick's
    event. Every event is DE-located in one batch on ``device`` (default
    ``cuda``) with draws from ``generator`` (a ``torch.Generator`` on that
    device), then its origin time is shifted by its median residual.
    Returns a dict with ``srcs_relocated``, the initial and relocated
    summaries and, given ``grid_cart``, the local-bias summaries."""
    from genie_tpu_torch.infer.locate import locate_sources_batched

    dev = resolve_device(device)
    srcs_init = np.asarray(srcs_init, np.float32)
    srcs_target = np.asarray(srcs_target, np.float32)
    pick_event = np.asarray(pick_event)
    n_ev = len(srcs_init)
    tp = np.zeros((n_ev, max_picks), np.float32)
    ip = np.zeros((n_ev, max_picks), np.int64)
    ph = np.zeros((n_ev, max_picks, 1), np.float32)
    pm = np.zeros((n_ev, max_picks), bool)
    for e in range(n_ev):
        sel = np.where(pick_event == e)[0][:max_picks]
        tp[e, :len(sel)] = pick_t[sel]
        ip[e, :len(sel)] = pick_sta[sel]
        ph[e, :len(sel), 0] = pick_phase[sel]
        pm[e, :len(sel)] = True

    sta = torch.as_tensor(np.asarray(sta_cart), dtype=torch.float32, device=dev)
    tp_d, ip_d = torch.as_tensor(tp, device=dev), torch.as_tensor(ip, device=dev)
    ph_d, pm_d = torch.as_tensor(ph, device=dev), torch.as_tensor(pm, device=dev)
    lo = torch.as_tensor(np.asarray(bounds_lo), dtype=torch.float32, device=dev)
    hi = torch.as_tensor(np.asarray(bounds_hi), dtype=torch.float32, device=dev)
    with torch.no_grad():
        pos, t0, _ = locate_sources_batched(generator, trv_from_cart, sta, tp_d, ip_d,
                                            ph_d, pm_d, lo, hi, popsize=popsize,
                                            n_iter=n_iter)
        # origin time shifted by the median residual of the event's picks
        trv = trv_from_cart(sta, pos)                                   # (n_ev, n_sta, 2)
        t_sta = torch.gather(trv, 1, ip_d[..., None].expand(-1, -1, 2))
        t_ph = torch.gather(t_sta, 2, ph_d.long())[..., 0]
        res = torch.where(pm_d, t0[:, None] + t_ph - tp_d,
                          torch.full_like(tp_d, float("nan")))
        t0 = t0 - nanmedian(res, dim=1)
    srcs_reloc = torch.cat((pos, t0[:, None]), dim=1).cpu().numpy()

    def summary(a):
        d = a - srcs_target
        return {
            "horizontal_m": float(np.linalg.norm(d[:, :2], axis=1).mean()),
            "vertical_m": float(np.abs(d[:, 2]).mean()),
            "time_s": float(np.abs(d[:, 3]).mean()),
        }

    out = {"srcs_relocated": srcs_reloc,
           "initial": summary(srcs_init), "relocated": summary(srcs_reloc)}

    if grid_cart is not None and n_ev:
        # local bias: mean residual over target events within bias_radius of
        # each grid node
        from scipy.spatial import cKDTree
        tree = cKDTree(srcs_target[:, :3])
        groups = tree.query_ball_point(np.asarray(grid_cart), r=bias_radius)
        b1, b2 = [], []
        for g in groups:
            if g:
                b1.append((srcs_init[g, :4] - srcs_target[g, :4]).mean(0))
                b2.append((srcs_reloc[g, :4] - srcs_target[g, :4]).mean(0))
        if b1:
            out["bias_initial"] = np.abs(np.stack(b1)).mean(0).tolist()
            out["bias_relocated"] = np.abs(np.stack(b2)).mean(0).tolist()
    return out
