"""Plain domain tables, travel times and magnitudes for the benchmark.

Frozen copies, in plain PyTorch and NumPy, of what the program derives in
its set-up: the local Cartesian projection, kNN tables, the per-grid graph
tables of the detector (station and source kNN, time pointers, bipartite
edge features), the travel-time PINN read from its pickle, the calibrated
station corrections and the local-magnitude model. The pickles are read by
a restricted unpickler of this file's own. Nothing here imports the
program.
"""

from __future__ import annotations

import copy
import math
import pickle
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.nn import prelu

WGS84_A = 6378137.0
WGS84_E = 8.18191908426215e-2


# -- geometry -------------------------------------------------------------

def lla2ecef(p, a: float = WGS84_A, e: float = WGS84_E):
    """Geodetic (lat deg, lon deg, alt m) → ECEF (m), torch."""
    p = torch.as_tensor(p)
    lat = p[..., 0] * (math.pi / 180.0)
    lon = p[..., 1] * (math.pi / 180.0)
    alt = p[..., 2]
    n = a / torch.sqrt(1.0 - (e**2) * torch.sin(lat) ** 2)
    x = (n + alt) * torch.cos(lat) * torch.cos(lon)
    y = (n + alt) * torch.cos(lat) * torch.sin(lon)
    z = ((1.0 - e**2) * n + alt) * torch.sin(lat)
    return torch.stack((x, y, z), dim=-1)


def lla2ecef_np(p, a: float = WGS84_A, e: float = WGS84_E):
    """Float64 host twin of :func:`lla2ecef`."""
    p = np.asarray(p, dtype=np.float64)
    lat = np.deg2rad(p[..., 0])
    lon = np.deg2rad(p[..., 1])
    alt = p[..., 2]
    n = a / np.sqrt(1.0 - (e**2) * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = ((1.0 - e**2) * n + alt) * np.sin(lat)
    return np.stack((x, y, z), axis=-1)


def to_cart_np(lla, center_latlon):
    """Local ENU metres (+x east, +y north, +z up) about ``center_latlon``;
    the origin held at float32 precision, as the projection of GENIE's
    projects."""
    lat0 = float(center_latlon[0]) * np.pi / 180.0
    lon0 = float(center_latlon[1]) * np.pi / 180.0
    rbest = np.stack((np.array([-np.sin(lon0), np.cos(lon0), 0.0]),
                      np.array([-np.sin(lat0) * np.cos(lon0),
                                -np.sin(lat0) * np.sin(lon0), np.cos(lat0)]),
                      np.array([np.cos(lat0) * np.cos(lon0),
                                np.cos(lat0) * np.sin(lon0), np.sin(lat0)])))
    centre = torch.tensor([[center_latlon[0], center_latlon[1], 0.0]],
                          dtype=torch.float32)
    mn = lla2ecef(centre)[0].numpy().astype(np.float32).astype(np.float64)
    rbest = rbest.astype(np.float32).astype(np.float64)
    return (lla2ecef_np(lla) - mn) @ rbest.T


def region_center(region: dict):
    return (0.5 * (region["lat_range"][0] + region["lat_range"][1]),
            0.5 * (region["lon_range"][0] + region["lon_range"][1]))


def region_scale_extend(region: dict):
    """The lat/lon/depth extent of the padded region."""
    pad = region["degree_padding"]
    lat = (region["lat_range"][0] - pad, region["lat_range"][1] + pad)
    lon = (region["lon_range"][0] - pad, region["lon_range"][1] + pad)
    dep = region["depth_range"]
    return (lat[1] - lat[0], lon[1] - lon[0], dep[1] - dep[0])


# -- kNN and graph tables -------------------------------------------------

def pairwise_sq_dist(x_query, x_context):
    q2 = (x_query ** 2).sum(-1, keepdim=True)
    c2 = (x_context ** 2).sum(-1, keepdim=True).transpose(-1, -2)
    cross = x_query @ x_context.transpose(-1, -2)
    return torch.clamp_min(q2 + c2 - 2.0 * cross, 0.0)


def knn(x_context, x_query, k: int):
    """Indices (int32) of the ``k`` nearest context points per query."""
    d = pairwise_sq_dist(x_query, x_context)
    _, idx = torch.topk(-d, k, dim=-1)
    return idx.to(torch.int32)


def knn_graph(x, k: int, mask=None):
    """k-NN graph over one point set, self excluded: (nbr, valid)."""
    n = x.shape[0]
    d = pairwise_sq_dist(x, x)
    d = d.masked_fill(torch.eye(n, dtype=torch.bool, device=x.device), float("inf"))
    if mask is not None:
        d = torch.where(mask[None, :], d, torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, k, dim=-1)
    valid = torch.isfinite(neg)
    if mask is not None:
        valid = valid & mask[:, None]
    idx = torch.where(valid, idx, torch.arange(n, device=x.device)[:, None])
    return idx.to(torch.int32), valid


def query_attachment(src_cart, x_query_cart, k: int):
    """kNN of query points into one source grid (km-scaled)."""
    return knn(src_cart / 1000.0, x_query_cart / 1000.0, k)


def time_pointers(trv, k: int, win: float, max_t: float, dt: float = 1.0):
    """Per-(station, time bin) the k source nodes whose travel time is
    nearest the bin, for P and S: (ptr_p, ptr_s, dt0, dt)."""
    part_np = np.arange(-win, win + max_t + dt, dt, dtype=np.float32)
    part = torch.as_tensor(part_np, device=trv.device)

    def one(tp):
        d = (tp.T[:, None, :] - part[None, :, None]).abs()
        return torch.topk(-d, k, dim=-1).indices.to(torch.int32)

    return one(trv[:, :, 0]), one(trv[:, :, 1]), float(part_np[0]), float(dt)


def pair_table(tpick, ipick, pick_mask, k_pair: int):
    """For every pick the ``k_pair`` nearest-in-time picks at its station,
    plus a null slot (index n_pick)."""
    n_pick = tpick.shape[-1]
    same_sta = ipick[..., :, None] == ipick[..., None, :]
    both = pick_mask[..., :, None] & pick_mask[..., None, :]
    d = (tpick[..., :, None] - tpick[..., None, :]).abs()
    d = torch.where(same_sta & both, d, torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, min(k_pair, n_pick), dim=-1)
    valid = torch.isfinite(neg)
    idx = torch.where(valid, idx, torch.full_like(idx, n_pick))
    null_col = torch.full((*idx.shape[:-1], 1), n_pick, dtype=idx.dtype,
                          device=idx.device)
    return (torch.cat((idx, null_col), dim=-1).to(torch.int32),
            torch.cat((valid, pick_mask[..., None]), dim=-1))


class Domain(NamedTuple):
    """The static tables of one deployment on one device."""

    sta_cart: torch.Tensor      # (n_sta, 3)
    grids_cart: torch.Tensor    # (n_grids, n_src, 3)
    trv_grids: torch.Tensor     # (n_grids, n_src, n_sta, 2)
    time_ptr_p: torch.Tensor    # (n_grids, n_sta, n_dt, k_time)
    time_ptr_s: torch.Tensor
    dt0: float
    dt: float
    edge_feat: torch.Tensor     # (n_grids, n_src, n_sta, 3)
    src_nbr: torch.Tensor       # (n_grids, n_src, k_spc)
    offset_cart: torch.Tensor   # (3,)
    scale_cart: torch.Tensor    # (3,)


def build_domain(cfg: dict, sta_lla, sta_cart, grids_lla, grids_cart, trv_grids,
                 device) -> Domain:
    """The detector's per-grid tables from the raw positions and the grid
    travel-time tables."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    sta_cart, sta_lla = f32(sta_cart), f32(sta_lla)
    grids_cart, grids_lla = f32(grids_cart), f32(grids_lla)
    g = cfg["graph"]
    max_t = float(trv_grids.max())
    scale = torch.as_tensor(np.asarray(region_scale_extend(cfg["region"]), np.float32),
                            device=device).reshape(1, 1, 3)
    ptr_p, ptr_s, nbrs, efeat = [], [], [], []
    dt0 = dt = None
    for i in range(grids_cart.shape[0]):
        p, s, dt0, dt = time_pointers(trv_grids[i], g["k_time_edges"],
                                      cfg["model"]["t_win"], max_t)
        ptr_p.append(p)
        ptr_s.append(s)
        nbrs.append(knn_graph(grids_cart[i] / 1000.0, g["k_spc_edges"])[0])
        efeat.append((grids_lla[i][:, None, :] - sta_lla[None, :, :]) / scale)
    flat = grids_cart.reshape(-1, 3)
    lo, hi = flat.amin(dim=0), flat.amax(dim=0)
    return Domain(sta_cart, grids_cart, trv_grids, torch.stack(ptr_p),
                  torch.stack(ptr_s), dt0, dt, torch.stack(efeat), torch.stack(nbrs),
                  lo, hi - lo)


# -- pickles --------------------------------------------------------------

class _Stub:
    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _stub_factory(*args, **kwargs):
    return _Stub()


def _jax_array_to_numpy(fun, args, arr_state, aval_state):
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _Unpickler(pickle.Unpickler):
    """Reads the numpy arrays of a flax checkpoint or artifact pickle; an
    optimizer class becomes an inert stub, and a pickled ``jax.Array`` the
    numpy array it carries. Any other JAX or flax class is refused."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "optax":
            return _Stub if name[:1].isupper() else _stub_factory
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _jax_array_to_numpy
        if top in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(f"{module}.{name} in a pickle")
        return super().find_class(module, name)


def load_pickle(path) -> dict:
    with open(Path(path), "rb") as f:
        return _Unpickler(f).load()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def flax_state_dict(tree: dict) -> dict:
    """A flax weight tree (``{'params': …}`` or bare) as a ``state_dict``:
    ``Dense`` kernels transposed to ``Linear.weight``, PReLU ``a`` scalars,
    root-level raw parameters by name."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    sd = {}
    for path, arr in _flatten(tree).items():
        arr = np.asarray(arr, np.float32)
        *mods, leaf = path.split("/")
        name = ".".join(mods)
        key = f"{name}.{leaf}" if name else leaf
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "a":
            sd[key] = torch.from_numpy(arr.reshape(()).copy())
        else:
            sd[key] = torch.from_numpy(np.array(arr))
    return sd


def load_weights(module: nn.Module, tree: dict) -> nn.Module:
    """Load a flax weight tree into ``module``, every leaf used."""
    module.load_state_dict(flax_state_dict(tree), strict=True)
    return module


# -- travel times ---------------------------------------------------------

def _sin_block(x, d1, d2, d3):
    x1 = torch.sin(d1(x))
    x2 = torch.sin(d2(x1)) + x1
    return torch.sin(d3(x2)) + x2


def _cat(parts):
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(*lead, p.shape[-1]) for p in parts], dim=-1)


class _Slope(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(0.25))

    def forward(self, x):
        return prelu(x, self.a)


class _VModel(nn.Module):
    """Present for the checkpoint's names; travel times do not read it."""

    def __init__(self, n_phases, h, n_embed):
        super().__init__()
        self.fc1_1 = nn.Linear(3 + n_embed, h)
        self.fc1_2 = nn.Linear(h, h)
        self.fc1_3 = nn.Linear(h, h)
        for j in range(n_phases):
            setattr(self, f"fc1_4_{j}", nn.Linear(h, 1))


class TravelTimesPN(nn.Module):
    """The PINN surrogate: a source embedding, two sin-residual perturbation
    branches on the normalized distance (or, ``per_phase_base``, on the
    per-phase normalized homogeneous times), merged by an MLP; travel time
    ``relu((homogeneous + perturbation) · t_scale)`` seconds."""

    def __init__(self, n_phases: int, n_hidden: int, n_embed: int,
                 per_phase_base: bool):
        super().__init__()
        h = n_hidden
        nb = n_phases if per_phase_base else 1
        self.per_phase_base = per_phase_base
        for b, n_in in ((1, 3 + nb + n_embed), (2, 6 + nb + n_embed), (3, 3)):
            setattr(self, f"fc{b}_1", nn.Linear(n_in, h))
            setattr(self, f"fc{b}_2", nn.Linear(h, h))
            setattr(self, f"fc{b}_3", nn.Linear(h, h))
        self.fc3_4 = nn.Linear(h, n_embed)
        self.merge_1 = nn.Linear(2 * h, h)
        self.merge_act = _Slope()
        self.merge_2 = nn.Linear(h, n_phases)
        self.vmodel = _VModel(n_phases, h, n_embed)

    def _branch(self, b):
        return tuple(getattr(self, f"fc{b}_{i}") for i in (1, 2, 3))

    def forward(self, sta_n, src_n, conversion_factor, v_mean, t_scale):
        embed = self.fc3_4(_sin_block(src_n, *self._branch(3)))
        rel = sta_n - src_n
        base = torch.sqrt((rel ** 2).sum(-1, keepdim=True) + 1e-12)
        if self.per_phase_base:
            base = conversion_factor * base / v_mean
        p1 = _sin_block(_cat((rel, base, embed)), *self._branch(1))
        p2 = _sin_block(_cat((sta_n, src_n, base, embed)), *self._branch(2))
        pred = self.merge_2(self.merge_act(self.merge_1(torch.cat((p1, p2), -1))))
        if self.per_phase_base:
            t = base + pred
        else:
            t = conversion_factor * base / v_mean + pred
        return torch.relu(t * t_scale)


class PINNTravelTimes:
    """``from_cart(sta (n_sta, 3), src (…, n_src, 3)) → (…, n_src, n_sta,
    2)`` seconds, at most ``max_pairs`` (source, station) pairs per call."""

    max_pairs = 1 << 22

    def __init__(self, path, device):
        blob = load_pickle(path)
        tree = blob["params"]
        if "params" in tree:
            tree = tree["params"]
        h = np.asarray(tree["fc1_1"]["kernel"]).shape[1]
        n_embed = np.asarray(tree["fc3_4"]["kernel"]).shape[1]
        n_ph = np.asarray(tree["merge_2"]["kernel"]).shape[1]
        n_base = np.asarray(tree["fc1_1"]["kernel"]).shape[0] - 3 - n_embed
        self.model = load_weights(TravelTimesPN(n_ph, h, n_embed, n_base > 1),
                                  tree).to(device)
        self.model.requires_grad_(False)
        s = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
             for k, v in blob["scales"].items()}
        self.center, self.x_scale = s["center"], s["x_scale"]
        self.t_scale, self.v_mean = s["t_scale"], s["v_mean"]

    def from_cart(self, sta_cart, src_cart):
        sta_n = (sta_cart - self.center) / self.x_scale
        src_n = (src_cart - self.center) / self.x_scale
        lead = src_n.shape[:-1]
        flat = src_n.reshape(-1, 1, 3)
        step = max(1, self.max_pairs // max(sta_n.shape[0], 1))
        cf = self.x_scale / self.t_scale
        outs = [self.model(sta_n, flat[i:i + step], cf, self.v_mean, self.t_scale)
                for i in range(0, flat.shape[0], step)]
        out = torch.cat(outs, dim=0)
        return out.reshape(*lead, sta_n.shape[0], out.shape[-1])


def gaussian_interp(grid_cart, coefs, src_cart, k: int = 5, sig: float = 15e3):
    """Normalized Gaussian-weight interpolation of ``coefs`` (n_grid, …)
    over the k nearest grid nodes."""
    idx = knn(grid_cart / 1000.0, src_cart / 1000.0, k)
    d2 = ((src_cart[:, None, :] - grid_cart[idx.long()]) ** 2).sum(-1)
    w = torch.exp(-0.5 * d2 / sig ** 2)
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    n = idx.shape[0]
    g = coefs[idx.long()].reshape(n, k, -1)
    return torch.einsum("nk,nkc->nc", w, g).reshape(n, *coefs.shape[1:])


class CorrectedTravelTimes:
    """The PINN plus the calibrated per-(grid node, station, phase)
    corrections, interpolated at each source."""

    def __init__(self, base: PINNTravelTimes, path, n_sta: int, device):
        z = np.load(path)
        self.base = base
        self.grid_cart = torch.as_tensor(np.asarray(z["grid_cart"], np.float32),
                                         device=device)
        self.coefs = torch.as_tensor(np.asarray(z["coefs"][:, :n_sta], np.float32),
                                     device=device)

    def double(self) -> "CorrectedTravelTimes":
        """The same travel times computed in float64."""
        base = copy.copy(self.base)
        base.model = copy.deepcopy(self.base.model).double()
        for k in ("center", "x_scale", "t_scale", "v_mean"):
            setattr(base, k, getattr(self.base, k).double())
        out = copy.copy(self)
        out.base = base
        out.grid_cart, out.coefs = self.grid_cart.double(), self.coefs.double()
        return out

    def from_cart(self, sta_cart, src_cart):
        flat = src_cart.reshape(-1, 3)
        c = gaussian_interp(self.grid_cart, self.coefs, flat)
        c = c.reshape(*src_cart.shape[:-1], *self.coefs.shape[1:])
        return self.base.from_cart(sta_cart, src_cart) + c


@torch.no_grad()
def grid_travel_times(trv: CorrectedTravelTimes, sta_cart, grids_cart,
                      max_chunk: int = 50_000):
    """(n_grids, n_src, n_sta, 2): the PINN in chunks of at most
    ``max_chunk`` pairs, plus the interpolated corrections."""
    n_sta = sta_cart.shape[0]
    rows = max(1, max_chunk // max(n_sta, 1))
    out = []
    for g in grids_cart:
        base = torch.cat([trv.base.from_cart(sta_cart, g[i:i + rows])
                          for i in range(0, g.shape[0], rows)], dim=0)
        out.append(base + gaussian_interp(trv.grid_cart, trv.coefs, g))
    return torch.stack(out)


# -- magnitudes -----------------------------------------------------------

class MagnitudeModel(nn.Module):
    """``log_amp = softplus(C1[ph])·M − softplus(C2[ph])·log10(d_epi + 1) +
    C3[ph]·log10(d_depth + 1) + bias(grid node, station, ph)``, the bias
    averaged over the source's k nearest grid nodes; given ``log_amp`` it is
    solved for M."""

    def __init__(self, n_sta: int, n_grid: int, k: int):
        super().__init__()
        self.k = k
        self.mag_coef = nn.Parameter(torch.ones(2))
        self.epicenter_spatial_coef = nn.Parameter(torch.ones(2))
        self.depth_spatial_coef = nn.Parameter(torch.zeros(2))
        self.bias = nn.Parameter(torch.zeros(n_grid, n_sta, 2))

    def forward(self, src_cart, sta_cart, grid_cart, sta_idx, phase,
                log_amp=None, mag=None):
        sta_idx = sta_idx.long()
        phase = phase.long()
        d_epi = torch.linalg.norm(src_cart[:, :2] - sta_cart[sta_idx, :2], dim=-1)
        d_dep = (src_cart[:, 2] - sta_cart[sta_idx, 2]).abs()
        gidx = knn(grid_cart / 1000.0, src_cart / 1000.0, self.k)
        b = self.bias[gidx.long(), sta_idx[:, None], phase[:, None]].mean(dim=1)
        a1 = torch.clamp_min(nn.functional.softplus(self.mag_coef[phase]), 1e-12)
        a2 = nn.functional.softplus(self.epicenter_spatial_coef[phase])
        a3 = self.depth_spatial_coef[phase]
        log_d0 = torch.log10(d_epi + 1.0)
        log_dz = torch.log10(d_dep + 1.0)
        if mag is not None:
            return mag * a1 - a2 * log_d0 + a3 * log_dz + b
        return (log_amp + a2 * log_d0 - a3 * log_dz - b) / a1


def load_magnitudes(path, n_sta: int, device) -> dict:
    """``{model, grid_cart, dist_model}``; the model's station bias cut to
    the first ``n_sta`` stations."""
    blob = load_pickle(path)
    grid_cart = np.asarray(blob["grid_cart"], np.float32)
    model = MagnitudeModel(int(blob["n_sta"]), len(grid_cart), int(blob.get("k", 1)))
    load_weights(model, blob["params"])
    model.bias = nn.Parameter(model.bias[:, :n_sta].contiguous())
    model = model.to(device).requires_grad_(False)
    return {"model": model, "grid_cart": torch.as_tensor(grid_cart, device=device),
            "dist_model": blob.get("dist_model")}


def magnitude_distance(params: dict, m):
    """The magnitude → largest association distance curve."""
    if params.get("kind") == "softplus":
        a, b, c, d0 = params["popt"]
        return a * np.log1p(np.exp(np.clip(b * (np.asarray(m) - c), -50, 50))) + d0
    return np.interp(np.asarray(m), params["centers"], params["q"])

