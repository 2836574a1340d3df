"""Travel-time surrogates mapping (stations, sources) to P/S arrival times.

Port of ``genie_tpu/models/travel_time.py:37-158``. ``from_cart(sta_cart,
src_cart)`` returns ``(..., n_src, n_sta, 2)`` seconds; leading batch
dimensions of ``src_cart`` carry through. Both surrogates are plain torch
ops, differentiable (``torch.func.jacfwd`` goes through them for the
location covariance) and device-agnostic. The physics-informed network
(``models/travel_time_pinn.py``) and ``TravelTimeCorrection``
(``calibration/corrections.py``) keep the same contract. The legacy MLP
surrogate :class:`LegacyTravelTimes` returns times and a validity mask; its
parameter names are those of the flax tree (``fc1.Dense_0`` …), so
``params.load_into`` and ``params.to_flax`` carry its weights across.
"""

from __future__ import annotations

import torch
from torch import nn

from genie_tpu_torch.device import resolve_device
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


class _ReluMLP(nn.Module):
    """3×80 ReLU MLP head (the reference's fc1..fc4 Sequentials)."""

    def __init__(self, n_in: int, n_out: int = 1, n_hidden: int = 80, device=None):
        super().__init__()
        widths = (n_in, n_hidden, n_hidden, n_hidden, n_out)
        for i in range(4):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1], device=device))

    def forward(self, x):
        for i in range(3):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return self.Dense_3(x)


class LegacyTravelTimes(nn.Module):
    """The legacy two-branch travel-time surrogate with validity-mask heads
    (the reference's ``TravelTimes``, module.py:1190-1321): time =
    ``trav_val·(fc1(relative offset) + fc2(absolute positions))``, validity
    = ``sigmoid(fc3(relative) + fc4(absolute))``, inputs divided by
    ``scale_val``. ``relative=True`` uses fc1 and fc3 only; ``train=True``
    drops the absolute branch of each (source, station) pair with
    probability ``drop_p``, from a keep mask drawn from ``generator``.
    Inputs are Cartesian; outputs (n_src, n_sta, n_phases). Built on
    ``device`` (default ``cuda``) with ``nn.Linear``'s own initialisation;
    ``models.init.init_legacy_travel_times`` gives flax's."""

    def __init__(self, n_phases: int = 2, scale_val: float = 1e6,
                 trav_val: float = 200.0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.scale_val, self.trav_val = scale_val, trav_val
        self.fc1 = _ReluMLP(3, n_phases, device=dev)
        self.fc2 = _ReluMLP(6, n_phases, device=dev)
        self.fc3 = _ReluMLP(3, n_phases, device=dev)
        self.fc4 = _ReluMLP(6, n_phases, device=dev)

    def forward(self, sta_cart, src_cart, train: bool = False, relative: bool = False,
                drop_p: float = 0.5, generator=None):
        sta = sta_cart / self.scale_val
        src = src_cart / self.scale_val
        rel = sta[None, :, :] - src[:, None, :]                 # (S, n_sta, 3)
        t = self.fc1(rel)
        m = self.fc3(rel)
        if not relative:
            absq = torch.cat((sta[None].expand(rel.shape), src[:, None].expand(rel.shape)),
                             dim=-1)
            t_abs = self.fc2(absq)
            m_abs = self.fc4(absq)
            if train:
                if generator is None:
                    raise ValueError("train=True draws its keep mask: pass a generator")
                keep = (torch.rand(rel.shape[:2] + (1,), generator=generator,
                                   device=rel.device) > drop_p).to(t.dtype)
                t_abs = t_abs * keep
                m_abs = m_abs * keep
            t = t + t_abs
            m = m + m_abs
        return self.trav_val * t, torch.sigmoid(m)
