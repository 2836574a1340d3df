"""Travel-time surrogates mapping (stations, sources) to P/S arrival times.

Port of ``genie_tpu/models/travel_time.py:37-101``. ``from_cart(sta_cart,
src_cart)`` returns ``(..., n_src, n_sta, 2)`` seconds; leading batch
dimensions of ``src_cart`` carry through. Both surrogates are plain torch
ops, differentiable (``torch.func.jacfwd`` goes through them for the
location covariance) and device-agnostic. The physics-informed network
(``models/travel_time_pinn.py``) and ``TravelTimeCorrection``
(``calibration/corrections.py``) keep the same contract; the legacy MLP is
not ported yet.
"""

from __future__ import annotations

import torch

from genie_tpu_torch.geometry import Projection


class HomogeneousTravelTime:
    """t = ‖x_src − x_sta‖ / v for constant vp, vs."""

    def __init__(self, projection: Projection, vp: float = 5500.0,
                 vs: float = 3100.0):
        self.proj = projection
        self.vp = vp
        self.vs = vs

    def from_cart(self, sta_cart, src_cart):
        d = torch.linalg.norm(src_cart[..., :, None, :] - sta_cart[..., None, :, :],
                              dim=-1)
        return torch.stack((d / self.vp, d / self.vs), dim=-1)

    def __call__(self, sta_lla, src_lla):
        return self.from_cart(self.proj.to_cart(sta_lla), self.proj.to_cart(src_lla))

    def pairwise(self, sta_lla, src_lla):
        d = torch.linalg.norm(self.proj.to_cart(src_lla) - self.proj.to_cart(sta_lla),
                              dim=-1)
        return torch.stack((d / self.vp, d / self.vs), dim=-1)


class GridTravelTime:
    """Trilinear interpolation of per-station tables on a regular (lat, lon,
    depth) grid. ``table``: (n_sta, n_lat, n_lon, n_dep, 2)."""

    def __init__(self, table, lats, lons, deps):
        self.table = torch.as_tensor(table, dtype=torch.float32)
        self.lats = torch.as_tensor(lats, dtype=torch.float32)
        self.lons = torch.as_tensor(lons, dtype=torch.float32)
        self.deps = torch.as_tensor(deps, dtype=torch.float32)

    @staticmethod
    def _locate(vals, grid):
        grid = grid.to(vals.device)
        i = torch.clamp(torch.searchsorted(grid, vals.contiguous()) - 1, 0,
                        grid.shape[0] - 2)
        w = (vals - grid[i]) / (grid[i + 1] - grid[i])
        return i, torch.clamp(w, 0.0, 1.0)

    def _interp(self, src_lla, sta_idx, paired: bool):
        """src_lla (n, 3). ``paired``: sta_idx (n,) pairs with the rows of
        src_lla → (n, 2); else sta_idx (n_s,) → (n_s, n, 2)."""
        ia, wa = self._locate(src_lla[:, 0], self.lats)
        ib, wb = self._locate(src_lla[:, 1], self.lons)
        ic, wc = self._locate(src_lla[:, 2], self.deps)
        table = self.table.to(src_lla.device)
        out = 0.0
        for da, fa in ((0, 1 - wa), (1, wa)):
            for db, fb in ((0, 1 - wb), (1, wb)):
                for dc, fc in ((0, 1 - wc), (1, wc)):
                    if paired:
                        t = table[sta_idx, ia + da, ib + db, ic + dc]
                    else:
                        t = table[sta_idx[:, None], ia + da, ib + db, ic + dc]
                    out = out + (fa * fb * fc)[..., None] * t
        return out

    def __call__(self, sta_lla, src_lla, sta_indices=None):
        n_sta = self.table.shape[0] if sta_indices is None else len(sta_indices)
        idx = (torch.arange(n_sta, device=src_lla.device) if sta_indices is None
               else torch.as_tensor(sta_indices, device=src_lla.device).long())
        return self._interp(src_lla, idx, paired=False).transpose(0, 1)

    def pairwise(self, sta_lla, src_lla, sta_indices=None):
        idx = (torch.arange(src_lla.shape[0], device=src_lla.device)
               if sta_indices is None
               else torch.as_tensor(sta_indices, device=src_lla.device).long())
        return self._interp(src_lla, idx, paired=True)
