"""Physics-informed neural travel-time surrogate and its training.

Port of ``genie_tpu/models/travel_time_pinn.py``: the forward
(``ScaleParams``, ``_sin_block``, ``VModel``, ``TravelTimesPN``,
``TravelTimePN`` :30-167; ``velocity_r2``, ``scales_from_domain``,
``load_reference_pinn`` :290-358) and the training half (``make_pinn_loss``,
``train_pinn``, ``importance_sample_volume`` :170-287).
Sin-activated residual MLPs: a 10-d source embedding, a homogeneous baseline
``conversion_factor·‖Δx‖/v_mean`` and two perturbation branches
(relative-offset and absolute-position) merged by an MLP; the travel time is
``relu(time_norm · t_scale)``. The loss has five terms: the data misfit, the
eikonal residual ``‖∇_src T_n‖ = 1/v_n`` (a second derivative for the
parameter gradients), the station boundary ``T(sta, sta) = 0``, causality
and damping of the velocity net toward a prior.

The module takes broadcast-compatible station and source inputs, so
:meth:`TravelTimePN.plain_from_cart` runs the source embedding once per
source and the pair branches once per (source, station) pair. It has no
in-place op, no ``.item()`` and no branch on values, so ``torch.func.jacfwd``
and ``vmap`` go through it (the location covariance does).
:meth:`TravelTimePN.from_cart` takes the hand-written kernel
(``ops/pinn_trv.py``) instead where the inputs allow it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from genie_tpu_torch import tracing
from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.models.layers import PReLU
from genie_tpu_torch.ops import pinn_trv


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
    n_src, n_sta, 2)`` seconds.

    The path follows the inputs: CUDA float32 tensors that nothing
    differentiates through go to the hand-written kernel
    (``ops/pinn_trv.py``), one call for any number of pairs; CPU tensors,
    and calls that autograd records or a ``torch.func`` transform wraps
    (the trainer's sensitivity, the covariance's and GraphDD's ``jacfwd``,
    GraphDD's training), take :meth:`plain_from_cart`, whose derivatives
    they need. The kernel is built for the widths of the port's PINNs (50
    hidden, 10 embedding, 2 phases); on the kernel's path a PINN of other
    widths raises, and :meth:`plain_from_cart` serves it. There at most ``max_pairs`` (source, station) pairs go
    through the network at once, so millions of pairs do not hold every
    50-wide activation in device memory; the chunks are split by sources,
    so the result is the same. The tracer counts ``trv.plain_calls`` where
    CUDA tensors take the plain forward."""

    max_pairs = 1 << 22

    def __init__(self, model: TravelTimesPN, scales: ScaleParams, projection=None):
        self.model = model
        self.scales = scales
        self.proj = projection
        self._params = (None, [])
        self._packed = (None, None)

    def _kernel_weights(self, sta_cart, src_cart):
        """The packed weights if this call takes the kernel, else None.
        They are packed again after any parameter or scale changes (a new
        tensor or an in-place update). Raises for a PINN whose widths the
        kernel is not built for (``pinn_trv.check_widths``)."""
        if not (sta_cart.is_cuda and src_cart.is_cuda
                and sta_cart.dtype == src_cart.dtype == torch.float32):
            return None
        if self._params[0] is not self.model:
            self._params = (self.model, list(self.model.parameters()))
        params = self._params[1]
        if pinn_trv.differentiated((sta_cart, src_cart), params):
            return None
        key = tuple((t.data_ptr(), t._version) for t in (*params, *self.scales))
        if self._packed[0] != key:
            pinn_trv.check_widths(self.model)
            self._packed = (key, pinn_trv.pack_weights(self.model, self.scales))
        return self._packed[1]

    def _norm(self, x):
        return (x - self.scales.center) / self.scales.x_scale

    def _apply(self, sta_n, src_n):
        s = self.scales
        return self.model(sta_n, src_n, s.conversion_factor, s.v_mean, s.t_scale)

    def from_cart(self, sta_cart, src_cart):
        packed = self._kernel_weights(sta_cart, src_cart)
        if packed is not None:
            return pinn_trv.pinn_trv(sta_cart, src_cart, packed, pinn_trv.n_base(self.model))
        if sta_cart.is_cuda:
            tracing.count("trv.plain_calls")
        return self.plain_from_cart(sta_cart, src_cart)

    def plain_from_cart(self, sta_cart, src_cart):
        """:meth:`from_cart` through the PyTorch modules, in chunks of at
        most ``max_pairs`` pairs."""
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


def interp(x, xp, fp):
    """``np.interp`` on tensors, with its end clamping: ``fp[0]`` left of
    ``xp[0]``, ``fp[-1]`` right of ``xp[-1]`` (``jnp.interp``'s arithmetic)."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def eikonal_gradient(model: TravelTimesPN, sta_n, src_n, conversion_factor, v_mean,
                     create_graph: bool = True):
    """``(∇_src time_norm, time_norm)``: the derivative of each phase's
    normalized time with respect to the source, through the source
    embedding too, ``(B, n_ph, 3)``, and the times ``(B, n_ph)``. Rows are
    independent, so the gradient of a phase's column sum is every row's own
    gradient (what JAX's per-sample ``vmap(jacrev)`` gives). With
    ``create_graph`` the result can be differentiated again."""
    src = src_n.detach().requires_grad_(True)
    raw = model.time_norm(sta_n, src, conversion_factor, v_mean)
    grads = [torch.autograd.grad(raw[:, j].sum(), src, create_graph=create_graph,
                                 retain_graph=True)[0]
             for j in range(raw.shape[-1])]
    return torch.stack(grads, dim=1), raw


PINN_PARTS = ("data", "pde", "bound", "sign")


def make_pinn_loss(model: TravelTimesPN, scales: ScaleParams, v_init_fn=None,
                   w_pde: float = 0.5, w_bound: float = 0.5, w_data: float = 1.0,
                   w_sign: float = 0.1, w_vdamp: float = 0.1):
    """``loss_fn(sta_n, src_n, t_obs_n) -> (total, parts)`` over a batch of
    normalized samples, ``parts`` the data, eikonal (``pde``), boundary and
    sign terms. All in normalized units: the velocity net outputs ``v_n =
    v·τ/L``, so ``‖∇_{x_n} T_n‖`` must equal ``1/v_n``; the residual is
    taken on the pre-relu field. ``v_init_fn(src_n)`` (normalized
    velocities, ``(B, n_ph)``) adds damping toward that prior."""
    cf, vm = scales.conversion_factor, scales.v_mean

    def loss_fn(sta_n, src_n, t_obs_n):
        grads, raw = eikonal_gradient(model, sta_n, src_n, cf, vm)
        data = (torch.relu(raw) - t_obs_n).abs().mean()
        grad_norm = torch.sqrt((grads ** 2).sum(-1) + 1e-12)
        v_n = model.velocity(src_n)
        pde = (grad_norm - 1.0 / (v_n + 1e-3)).abs().mean()
        bound = torch.relu(model.time_norm(sta_n, sta_n, cf, vm)).abs().mean()
        sign = torch.relu(-raw).mean()
        total = w_data * data + w_pde * pde + w_bound * bound + w_sign * sign
        if v_init_fn is not None:
            v0 = v_init_fn(src_n)
            total = total + w_vdamp * ((v_n - v0).abs() / v0.abs()).mean()
        return total, {"data": data, "pde": pde, "bound": bound, "sign": sign}

    return loss_fn


def train_pinn(generator, model: TravelTimesPN, scales: ScaleParams, sample_fn,
               n_steps: int = 2000, batch: int = 4096, lr=1e-3, v_init_fn=None,
               log_every: int = 0, keep_weights: bool = False, device=None):
    """Adam after clipping the gradients to global norm 1, over batches of
    ``sample_fn(generator, batch) -> (sta_n, src_n, t_obs_n)``. ``lr`` is a
    number or a schedule ``count -> lr`` (``train.optim.cosine_decay_schedule``),
    evaluated at the count of steps taken before this one, as optax does.
    ``generator`` (a ``torch.Generator`` on the device) first gives ``model``
    flax-default weights (``models.init.init_pinn``) unless
    ``keep_weights``. Runs on ``device`` (default ``cuda``). Returns
    ``(model, history)``: ``history`` maps ``total`` and each of
    :data:`PINN_PARTS` to its ``(n_steps,)`` tensor on the device."""
    from genie_tpu_torch.models.init import init_pinn
    from genie_tpu_torch.train.optim import clip_by_global_norm_

    dev = resolve_device(device)
    model = model.to(dev)
    if not keep_weights:
        if generator is None:
            raise ValueError("train_pinn needs a generator for the initial weights "
                             "(or keep_weights=True)")
        init_pinn(model, generator)
    loss_fn = make_pinn_loss(model, scales.to(dev), v_init_fn=v_init_fn)
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=lr(0) if callable(lr) else lr)
    hist = torch.zeros((n_steps, 1 + len(PINN_PARTS)), device=dev)
    for i in range(n_steps):
        if callable(lr):
            opt.param_groups[0]["lr"] = lr(i)
        sta_n, src_n, t_obs_n = sample_fn(generator, batch)
        opt.zero_grad(set_to_none=True)
        total, parts = loss_fn(sta_n, src_n, t_obs_n)
        total.backward(inputs=params)
        clip_by_global_norm_(params, 1.0)
        opt.step()
        hist[i] = torch.stack([total.detach()] + [parts[k].detach() for k in PINN_PARTS])
        if log_every and i % log_every == 0:
            print(f"pinn step {i}: loss {float(total.detach()):.5f}")
    return model, dict(zip(("total",) + PINN_PARTS, hist.unbind(1)))


def importance_sample_volume(rng, Tp, Ts, origin, h, sta_cart_j, n,
                             mix=(0.3, 0.2, 0.2, 0.3), t_floor: float = 2.0,
                             near_sigma: float = 25e3):
    """Importance-sampled (src_cart, t_ps) training tuples from one station's
    FMM volume, the reference's sampling mixture for the PINN: uniform, 1/t,
    1/t² (both emphasizing the steep near-field), and a near-station
    Gaussian ball. A numpy copy of the JAX package's sampler: the same
    ``np.random.Generator`` gives the same draws.

    Returns ``(src_cart (n,3) f32, t (n,2) f32)``.
    """
    shape = np.asarray(Tp.shape)
    N = int(Tp.size)
    flat_tp = np.asarray(Tp, np.float32).reshape(-1)
    n_u = int(mix[0] * n)
    n_1 = int(mix[1] * n)
    n_2 = int(mix[2] * n)
    n_b = n - n_u - n_1 - n_2

    idx = [rng.integers(0, N, n_u)]
    w = 1.0 / np.maximum(flat_tp, t_floor)
    for power, count in ((1, n_1), (2, n_2)):
        cdf = np.cumsum(w if power == 1 else w * w)
        cdf /= cdf[-1]
        idx.append(np.searchsorted(cdf, rng.random(count)))
    # near-station Gaussian in index space (clipped to the volume)
    ctr = (np.asarray(sta_cart_j) - np.asarray(origin)) / h
    ijk = np.clip(np.round(ctr + rng.normal(0, near_sigma / h, (n_b, 3))),
                  0, shape - 1).astype(np.int64)
    idx.append(np.ravel_multi_index(
        (ijk[:, 0], ijk[:, 1], ijk[:, 2]), tuple(shape)))
    idx = np.concatenate(idx)
    iii = np.stack(np.unravel_index(idx, tuple(shape)), axis=1)
    src = (np.asarray(origin) + iii * h).astype(np.float32)
    t = np.stack((flat_tp[idx], np.asarray(Ts, np.float32).reshape(-1)[idx]),
                 axis=1)
    return src, t


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
