"""Physics-informed neural travel-time surrogate, forward only.

Port of ``genie_tpu/models/travel_time_pinn.py`` (``ScaleParams``,
``_sin_block``, ``VModel``, ``TravelTimesPN``, ``TravelTimePN`` :30-167;
``velocity_r2``, ``scales_from_domain``, ``load_reference_pinn`` :290-358).
Sin-activated residual MLPs: a 10-d source embedding, a homogeneous baseline
``conversion_factor·‖Δx‖/v_mean`` and two perturbation branches
(relative-offset and absolute-position) merged by an MLP; the travel time is
``relu(time_norm · t_scale)``. The PINN losses and training are not ported.

The module takes broadcast-compatible station and source inputs, so
:meth:`TravelTimePN.from_cart` runs the source embedding once per source
and the pair branches once per (source, station) pair. It has no in-place
op, no ``.item()`` and no branch on values, so ``torch.func.jacfwd`` and
``vmap`` go through it (the location covariance does).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.models.layers import PReLU


class ScaleParams(NamedTuple):
    """Normalization scalars persisted with the weights."""

    center: torch.Tensor   # (3,) Cartesian centre
    x_scale: torch.Tensor  # scalar: max extent (m)
    t_scale: torch.Tensor  # scalar: max travel time (s)
    v_mean: torch.Tensor   # (n_phases,) mean velocities (m/s)

    @property
    def conversion_factor(self):
        return self.x_scale / self.t_scale

    def to(self, device) -> "ScaleParams":
        return ScaleParams(*(v.to(device) for v in self))


def _sin_block(x, d1, d2, d3):
    x1 = torch.sin(d1(x))
    x2 = torch.sin(d2(x1)) + x1
    return torch.sin(d3(x2)) + x2


def _cat(parts):
    """Concatenate on the last axis after broadcasting the leading ones."""
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(*lead, p.shape[-1]) for p in parts], dim=-1)


class VModel(nn.Module):
    """Velocity net: sin-residual MLP → Softplus; Vs = Vp × ratio."""

    def __init__(self, n_phases: int = 2, n_hidden: int = 50, n_embed: int = 10):
        super().__init__()
        h = n_hidden
        self.n_phases = n_phases
        self.fc1_1 = nn.Linear(3 + n_embed, h)
        self.fc1_2 = nn.Linear(h, h)
        self.fc1_3 = nn.Linear(h, h)
        for j in range(n_phases):
            setattr(self, f"fc1_4_{j}", nn.Linear(h, 1))

    def forward(self, src_n, embed):
        x1 = _sin_block(_cat((src_n, embed)), self.fc1_1, self.fc1_2, self.fc1_3)
        outs = [nn.functional.softplus(getattr(self, f"fc1_4_{j}")(x1))
                for j in range(self.n_phases)]
        lout = [outs[0]] + [outs[0] * outs[j] for j in range(1, self.n_phases)]
        return torch.cat(lout, dim=-1)


class TravelTimesPN(nn.Module):
    """``per_phase_base``: the two perturbation branches take the per-phase
    normalized baseline times (``n_phases`` columns) instead of the raw
    normalized distance (1 column), the layout of the reference's shipped
    weights."""

    def __init__(self, n_phases: int = 2, n_hidden: int = 50, n_embed: int = 10,
                 per_phase_base: bool = False):
        super().__init__()
        h = n_hidden
        self.n_phases = n_phases
        self.per_phase_base = per_phase_base
        nb = n_phases if per_phase_base else 1
        for b, n_in in ((1, 3 + nb + n_embed), (2, 6 + nb + n_embed), (3, 3)):
            setattr(self, f"fc{b}_1", nn.Linear(n_in, h))
            setattr(self, f"fc{b}_2", nn.Linear(h, h))
            setattr(self, f"fc{b}_3", nn.Linear(h, h))
        self.fc3_4 = nn.Linear(h, n_embed)
        self.merge_1 = nn.Linear(2 * h, h)
        self.merge_act = PReLU()
        self.merge_2 = nn.Linear(h, n_phases)
        self.vmodel = VModel(n_phases, n_hidden, n_embed)

    def _branch(self, b: int):
        return tuple(getattr(self, f"fc{b}_{i}") for i in (1, 2, 3))

    def embed_src(self, src_n):
        return self.fc3_4(_sin_block(src_n, *self._branch(3)))

    def _pred_norm(self, sta_n, src_n, embed, conversion_factor=None, v_mean=None):
        """Normalized (base, perturbation) for broadcast-compatible inputs."""
        # safe norm: the gradient of sqrt at exactly 0 would be NaN
        rel = sta_n - src_n
        base = torch.sqrt((rel ** 2).sum(-1, keepdim=True) + 1e-12)
        if self.per_phase_base:
            base = conversion_factor * base / v_mean
        p1 = _sin_block(_cat((rel, base, embed)), *self._branch(1))
        p2 = _sin_block(_cat((sta_n, src_n, base, embed)), *self._branch(2))
        pred = self.merge_2(self.merge_act(self.merge_1(torch.cat((p1, p2), -1))))
        return base, pred

    def velocity(self, src_n, embed=None):
        if embed is None:
            embed = self.embed_src(src_n)
        return self.vmodel(src_n, embed)

    def time_norm(self, sta_n, src_n, conversion_factor, v_mean):
        """Normalized travel times (…, n_phases) before relu/denorm."""
        embed = self.embed_src(src_n)
        base, pred = self._pred_norm(sta_n, src_n, embed, conversion_factor, v_mean)
        if self.per_phase_base:
            return base + pred
        return conversion_factor * base / v_mean + pred

    def forward(self, sta_n, src_n, conversion_factor, v_mean, t_scale):
        return torch.relu(self.time_norm(sta_n, src_n, conversion_factor, v_mean)
                          * t_scale)


class TravelTimePN:
    """Bound surrogate with the port's travel-time contract: ``from_cart``
    maps ``(n_sta, 3)`` stations and ``(…, n_src, 3)`` sources to ``(…,
    n_src, n_sta, 2)`` seconds. At most ``max_pairs`` (source, station)
    pairs go through the network at once, so the DE objective's millions of
    pairs do not hold every 50-wide activation in device memory; the chunks
    are split by sources, so the result is the same."""

    max_pairs = 1 << 22

    def __init__(self, model: TravelTimesPN, scales: ScaleParams, projection=None):
        self.model = model
        self.scales = scales
        self.proj = projection

    def _norm(self, x):
        return (x - self.scales.center) / self.scales.x_scale

    def _apply(self, sta_n, src_n):
        s = self.scales
        return self.model(sta_n, src_n, s.conversion_factor, s.v_mean, s.t_scale)

    def from_cart(self, sta_cart, src_cart):
        sta_n = self._norm(sta_cart)
        src_n = self._norm(src_cart)
        lead = src_n.shape[:-1]
        flat = src_n.reshape(-1, 1, 3)
        step = max(1, self.max_pairs // max(sta_n.shape[0], 1))
        outs = [self._apply(sta_n, flat[i:i + step])
                for i in range(0, flat.shape[0], step)]
        out = torch.cat(outs, dim=0)
        return out.reshape(*lead, sta_n.shape[0], out.shape[-1])

    def __call__(self, sta_lla, src_lla):
        return self.from_cart(self.proj.to_cart(sta_lla), self.proj.to_cart(src_lla))

    def pairwise_from_cart(self, sta_cart, src_cart):
        """Row-paired stations and sources, (n, 3) each → (n, 2)."""
        return self._apply(self._norm(sta_cart), self._norm(src_cart))


def scales_from_domain(center, x_scale, t_scale, v_mean) -> ScaleParams:
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32))

    return ScaleParams(center=t(center), x_scale=t(x_scale), t_scale=t(t_scale),
                       v_mean=t(v_mean))


@torch.no_grad()
def velocity_r2(model: TravelTimesPN, scales: ScaleParams, src_n, v_true_phys):
    """R² of the recovered velocity field against the truth, per phase.
    src_n: (n, 3) normalized positions; v_true_phys: (n, n_phases) m/s."""
    v_n = model.velocity(torch.as_tensor(src_n, dtype=torch.float32,
                                         device=scales.center.device))
    v_phys = v_n.cpu().numpy() * float(scales.conversion_factor)
    v_true = np.asarray(v_true_phys)
    ss_res = ((v_phys - v_true) ** 2).sum(axis=0)
    ss_tot = ((v_true - v_true.mean(axis=0)) ** 2).sum(axis=0) + 1e-12
    return 1.0 - ss_res / ss_tot


def load_reference_pinn(weights_path, scale_params, v_mean, device=None):
    """Load the reference's shipped trained PINN (a torch state dict such as
    ``travel_time_neural_network_physics_informed_p_s_ver_1.h5``) and return
    ``(model, scales)`` on ``device`` (default ``cuda``).

    ``scale_params`` is the reference's 6-vector ``[max_dist, max_time,
    vp_max, vs_min, scale_norm_factor, conversion_factor]``. Its
    normalization is uncentred, which equals ours with ``center=0,
    x_scale=max_dist, t_scale=max_time`` and ``per_phase_base``."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().to(torch.float32) for k, v in sd.items()}
    n_phases = sd["merge.2.weight"].shape[0]
    model = TravelTimesPN(n_phases=n_phases, n_hidden=sd["fc1_1.weight"].shape[0],
                          n_embed=sd["fc3_4.weight"].shape[0], per_phase_base=True)
    ref = {"merge_1": "merge.0", "merge_2": "merge.2", "merge_act": "merge.1"}
    ref.update({f"vmodel.fc1_4_{j}": f"vmodel.fc1_4.{j}" for j in range(n_phases)})
    own = {}
    for name, p in model.state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        if prefix == "merge_act":
            own[name] = sd["merge.1.weight"].reshape(p.shape)
        else:
            own[name] = sd[f"{ref.get(prefix, prefix)}.{leaf}"]
    model.load_state_dict(own, strict=True)
    scales = scales_from_domain(np.zeros(3), float(scale_params[0]),
                                float(scale_params[1]), v_mean)
    dev = resolve_device(device)
    return model.to(dev), scales.to(dev)
