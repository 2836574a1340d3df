"""Local-magnitude model, forward and inversion.

Port of ``genie_tpu/models/magnitude.py:26-74``:

  log_amp = Softplus(C1[ph])·M − Softplus(C2[ph])·log10(d_epi + 1)
            + C3[ph]·log10(d_depth + 1) + bias(grid, station, ph)

with the per-(grid node, station, phase) bias taken at the source's ``k``
nearest grid nodes. Given ``mag`` the model predicts log-amplitudes; given
``log_amp`` it inverts for magnitudes. Fitting (``fit_magnitude_model``) is
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

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
