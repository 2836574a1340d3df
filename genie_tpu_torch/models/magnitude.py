"""Local-magnitude model, forward and inversion.

Port of ``genie_tpu/models/magnitude.py``:

  log_amp = Softplus(C1[ph])·M − Softplus(C2[ph])·log10(d_epi + 1)
            + C3[ph]·log10(d_depth + 1) + bias(grid, station, ph)

with the per-(grid node, station, phase) bias taken at the source's ``k``
nearest grid nodes. Given ``mag`` the model predicts log-amplitudes; given
``log_amp`` it inverts for magnitudes. :func:`fit_magnitude_model` fits
(C1, C2, C3, bias) by Adam on the log-amplitude MSE plus a same-event
station-pair differential loss.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.ops.knn import knn


class MagnitudeModel(nn.Module):
    """Parameters only; the geometry comes with each call. Parameter names
    are those of the flax module (``params.load_into`` maps them)."""

    def __init__(self, n_sta: int, n_grid: int, k: int = 1):
        super().__init__()
        self.n_sta = n_sta
        self.n_grid = n_grid
        self.k = k
        self.mag_coef = nn.Parameter(torch.ones(2))
        self.epicenter_spatial_coef = nn.Parameter(torch.ones(2))
        self.depth_spatial_coef = nn.Parameter(torch.zeros(2))
        self.bias = nn.Parameter(torch.zeros(n_grid, n_sta, 2))

    def forward(self, src_cart, sta_cart, grid_cart, sta_idx, phase,
                log_amp=None, mag=None):
        """Per-observation inputs: src_cart (n_obs, 3) (one source row per
        observation), sta_idx and phase (n_obs,) ints. With ``mag`` → the
        predicted log-amplitudes; with ``log_amp`` → magnitudes."""
        sta_idx = sta_idx.long()
        phase = phase.long()
        d_epi = torch.linalg.norm(src_cart[:, :2] - sta_cart[sta_idx, :2], dim=-1)
        d_dep = (src_cart[:, 2] - sta_cart[sta_idx, 2]).abs()
        log_d0 = torch.log10(d_epi + 1.0)
        log_dz = torch.log10(d_dep + 1.0)
        gidx, _ = knn(grid_cart / 1000.0, src_cart / 1000.0, self.k)
        # every index is advanced and broadcasts to (n_obs, k); a slice in
        # the middle would move the k axis to the front and broadcast the
        # result to (n_obs, n_obs)
        b = self.bias[gidx.long(), sta_idx[:, None], phase[:, None]].mean(dim=1)
        a1 = torch.clamp_min(nn.functional.softplus(self.mag_coef[phase]), 1e-12)
        a2 = nn.functional.softplus(self.epicenter_spatial_coef[phase])
        a3 = self.depth_spatial_coef[phase]
        if mag is not None:
            return mag * a1 - a2 * log_d0 + a3 * log_dz + b
        return (log_amp + a2 * log_d0 - a3 * log_dz - b) / a1


def same_event_pairs(src_cart, sta_idx, phase, max_pairs: int = 200_000):
    """Index pairs (i, j) of observations of one event (identical source
    row), one phase and two different stations, subsampled to
    ``max_pairs`` with ``np.random.default_rng(0)``."""
    src_np, sta_np, ph_np = np.asarray(src_cart), np.asarray(sta_idx), np.asarray(phase)
    _, ev_lab = np.unique(src_np, axis=0, return_inverse=True)
    ev_lab = ev_lab.reshape(-1)
    pi, pj = [], []
    for e in np.unique(ev_lab):
        idx = np.where(ev_lab == e)[0]
        ii, jj = np.meshgrid(idx, idx, indexing="ij")
        m = (ph_np[ii] == ph_np[jj]) & (sta_np[ii] != sta_np[jj])
        pi.append(ii[m])
        pj.append(jj[m])
    pi = np.concatenate(pi) if pi else np.zeros(0, np.int64)
    pj = np.concatenate(pj) if pj else np.zeros(0, np.int64)
    if len(pi) > max_pairs:
        sel = np.random.default_rng(0).choice(len(pi), max_pairs, replace=False)
        pi, pj = pi[sel], pj[sel]
    return pi, pj


def fit_magnitude_model(sta_cart, grid_cart, src_cart, sta_idx, phase, log_amp,
                        mag_obs, k: int = 1, n_steps: int = 2000, lr: float = 1e-2,
                        w_diff: float = 0.5, max_pairs: int = 200_000,
                        w_bias_reg: float = 0.0, device=None) -> MagnitudeModel:
    """Fit the model on observed (source, station, phase, log-amplitude,
    catalog magnitude) tuples, one source row per observation, by Adam from
    the deterministic start (ones, ones, zeros, zeros) on ``device``
    (default ``cuda``). The loss is the log-amplitude MSE plus ``w_diff`` ×
    the MSE of same-event station-pair differences
    (:func:`same_event_pairs`) plus ``w_bias_reg`` × the spatial variance
    of the bias field around its per-station mean; without pairs it is the
    MSE alone. Returns the fitted :class:`MagnitudeModel`."""
    dev = resolve_device(device)
    pi, pj = same_event_pairs(src_cart, sta_idx, phase, max_pairs)
    has_pairs = len(pi) > 0

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def i64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    sta_cart, grid_cart, src_cart = f32(sta_cart), f32(grid_cart), f32(src_cart)
    log_amp, mag_obs = f32(log_amp), f32(mag_obs)
    sta_idx, phase, pi, pj = i64(sta_idx), i64(phase), i64(pi), i64(pj)
    model = MagnitudeModel(n_sta=sta_cart.shape[0], n_grid=grid_cart.shape[0],
                           k=k).to(dev)

    def loss_fn():
        pred = model(src_cart, sta_cart, grid_cart, sta_idx, phase, mag=mag_obs)
        mse = ((pred - log_amp) ** 2).mean()
        if not has_pairs:
            return mse
        diff = (((pred[pi] - pred[pj]) - (log_amp[pi] - log_amp[pj])) ** 2).mean()
        loss = mse + w_diff * diff
        if w_bias_reg > 0.0:
            b = model.bias
            loss = loss + w_bias_reg * ((b - b.mean(0, keepdim=True)) ** 2).mean()
        return loss

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss_fn().backward()
        opt.step()
    return model
