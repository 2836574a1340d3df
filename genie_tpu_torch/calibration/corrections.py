"""Travel-time calibration: interpolated station/phase corrections.

Port of ``genie_tpu/calibration/corrections.py:27-98, 135-165``: the kNN,
Gaussian-weighted, anisotropic and inverse-distance interpolators of
per-(grid node, station, phase) coefficient fields, the random-walk graph
Laplacian, :class:`TravelTimeCorrection` (a travel-time callable plus the
interpolated corrections) and the matched-catalog statistics. Fitting the
corrections (``fit_corrections``) and the relocation benchmark are not
ported yet.

Sources are ``(n_src, 3)`` tensors; coefficient fields ``(n_grid, …)``.
"""

from __future__ import annotations

import numpy as np
import torch

from genie_tpu_torch.infer.assign import maximize_bipartite_assignment
from genie_tpu_torch.ops.knn import knn


def _weighted_sum(coefs, idx, w):
    """Σ_k w[n, k]·coefs[idx[n, k]] → (n, …)."""
    n, k = idx.shape
    g = coefs[idx.long()].reshape(n, k, -1)              # (n, k, Π…)
    return torch.einsum("nk,nkc->nc", w, g).reshape(n, *coefs.shape[1:])


def interp_knn_mean(grid_cart, coefs, src_cart, k: int = 5):
    """kNN mean interpolation: coefs (n_grid, …) → (n_src, …)."""
    idx, _ = knn(grid_cart / 1000.0, src_cart / 1000.0, k)
    return coefs[idx.long()].mean(dim=1)


def interp_weighted(grid_cart, coefs, src_cart, k: int = 5, sig: float = 15e3):
    """Gaussian-weight normalized interpolation over the k nearest nodes."""
    idx, _ = knn(grid_cart / 1000.0, src_cart / 1000.0, k)
    d2 = ((src_cart[:, None, :] - grid_cart[idx.long()]) ** 2).sum(-1)
    w = torch.exp(-0.5 * d2 / sig ** 2)
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return _weighted_sum(coefs, idx, w)


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
