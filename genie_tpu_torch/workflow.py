"""High-level workflow: a project's files → FMM travel-time tables → the
PINN → the domain context → training → one day of continuous processing,
picks file in, catalog hdf5 out.

Port of ``genie_tpu/workflow.py``: ``build_velocity_volume``,
``fmm_grid_box`` and ``build_fmm_tables`` (:28-163, numpy/scipy copies over
the port's own FMM loader), ``rasterize_surface`` (:166-183), ``make_trv``
(:186-200), ``domain_from_project`` (:203-227), ``train`` (:230-295) and
``process_day`` (:298-309); and the steps of ``scripts/nc_pinn.py`` that
turn FMM tables into a PINN artifact (:63-191): :func:`pinn_sample_bank`,
:func:`pinn_velocity_prior`, :func:`pinn_error_stats`,
:func:`pinn_velocity_r2`, around ``models.travel_time_pinn.train_pinn``
and ``io.save_pinn``; and the objective of ``scripts/nc_optimize_data.py``
(:func:`optimize_data_objective`, :func:`synthetic_pick_statistics`).
``train`` has no wandb hook.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from genie_tpu_torch.config import Config
from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.train.trainer import DomainContext, TrainState


def build_velocity_volume(cfg: Config, proj: Projection, lo, shape, h,
                          vel_model=None, surface_lla=None,
                          air_velocity: float = 343.0):
    """(Vp, Vs) volumes on the FMM grid, for the reference's three
    velocity-model types plus topography air-masking:

    ``vel_model`` is None (1-D profile from ``cfg.velocity``) or a dict:
      * ``{"type": "1d", "depths", "vp", "vs"}``: depth profile;
      * ``{"type": "3d", "points_lla" (n,3), "vp" (n,), "vs" (n,)}``:
        scattered 3-D model, nearest-neighbor assigned;
      * ``{"type": "profiles", "profiles": [{"coor" (lat, lon),
        "radius_km", "depths", "vp", "vs"}, ...]}``: regional 1-D profiles,
        each grid cell taking the profile whose (radius-normalized)
        horizontal distance is smallest.

    ``surface_lla``: (n, 3) lat/lon/elevation(m) points; grid cells above the
    (nearest-neighbor) surface get acoustic ``air_velocity``.
    """
    from scipy.spatial import cKDTree

    shape = tuple(int(s) for s in shape)
    zs = lo[2] + np.arange(shape[2]) * h

    if vel_model is None or vel_model.get("type", "1d") == "1d":
        vm = vel_model or {}
        depths = np.asarray(vm.get("depths", cfg.velocity.depths), float)
        vp_p = np.asarray(vm.get("vp", cfg.velocity.vp), float)
        vs_p = np.asarray(vm.get("vs", cfg.velocity.vs), float)
        order = np.argsort(depths)
        vp = np.interp(zs, depths[order], vp_p[order]).astype(np.float32)
        vs = np.interp(zs, depths[order], vs_p[order]).astype(np.float32)
        vol_p = np.broadcast_to(vp[None, None, :], shape).copy()
        vol_s = np.broadcast_to(vs[None, None, :], shape).copy()
    else:
        ax = [lo[i] + np.arange(shape[i]) * h for i in range(3)]
        xx = np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)
        if vel_model["type"] == "3d":
            pts = np.asarray(proj.to_cart_np(
                np.asarray(vel_model["points_lla"], np.float64)))
            j = cKDTree(pts).query(xx)[1]
            vol_p = np.asarray(vel_model["vp"], np.float32)[j].reshape(shape)
            vol_s = np.asarray(vel_model["vs"], np.float32)[j].reshape(shape)
        elif vel_model["type"] == "profiles":
            best = np.full(len(xx), np.inf)
            vol_p = np.zeros(len(xx), np.float32)
            vol_s = np.zeros(len(xx), np.float32)
            for prof in vel_model["profiles"]:
                la, lon = prof["coor"]
                c = np.asarray(proj.to_cart_np(
                    np.array([[la, lon, 0.0]], np.float64)))[0]
                d = (np.linalg.norm(xx[:, :2] - c[None, :2], axis=1)
                     / (float(prof["radius_km"]) * 1e3))
                sel = d < best
                best[sel] = d[sel]
                order = np.argsort(np.asarray(prof["depths"], float))
                dd = np.asarray(prof["depths"], float)[order]
                vol_p[sel] = np.interp(xx[sel, 2], dd,
                                       np.asarray(prof["vp"], float)[order])
                vol_s[sel] = np.interp(xx[sel, 2], dd,
                                       np.asarray(prof["vs"], float)[order])
            vol_p = vol_p.reshape(shape)
            vol_s = vol_s.reshape(shape)
        else:
            raise ValueError(f"unknown vel_model type {vel_model['type']!r}")

    if surface_lla is not None:
        surf = np.asarray(surface_lla, np.float64)
        surf_cart = np.asarray(proj.to_cart_np(
            np.concatenate((surf[:, :2], np.zeros((len(surf), 1))), axis=1)))
        ax01 = [lo[i] + np.arange(shape[i]) * h for i in range(2)]
        gx, gy = np.meshgrid(*ax01, indexing="ij")
        grid_xy = np.stack((gx.ravel(), gy.ravel()), axis=-1)
        j = cKDTree(surf_cart[:, :2]).query(grid_xy)[1]
        elev = surf[j, 2].reshape(shape[0], shape[1])
        air = zs[None, None, :] > elev[:, :, None]
        vol_p = np.where(air, np.float32(air_velocity), vol_p)
        vol_s = np.where(air, np.float32(air_velocity), vol_s)
    return vol_p, vol_s


def fmm_grid_box(cfg: Config, proj: Projection):
    """(lo, shape, h): Cartesian box covering the padded region."""
    h = cfg.travel_time.dx
    corners = []
    for la in cfg.region.lat_range_extend:
        for lo_ in cfg.region.lon_range_extend:
            for dz in cfg.region.depth_range:
                corners.append([la, lo_, dz])
    cc = np.asarray(proj.to_cart_np(np.asarray(corners)), np.float64)
    lo = cc.min(axis=0) - 2 * h
    hi = cc.max(axis=0) + 2 * h
    shape = tuple(int(np.ceil((hi[i] - lo[i]) / h)) + 1 for i in range(3))
    return lo, shape, h


def build_fmm_tables(cfg: Config, proj: Projection, sta_lla, out_dir,
                     station_indices=None, verbose=True, vel_model=None,
                     surface_lla=None):
    """Per-station FMM travel-time volumes over the padded region, saved as
    ``{out_dir}/travel_time_grid_station_{j}.npz`` (``Tp``, ``Ts``,
    ``origin``, ``h``, ``shape``). Shard it over jobs or processes by
    ``station_indices``; a station whose file exists is skipped, so a shard
    may be re-run, and each file is written under a dot-name and renamed
    into place, so a killed shard leaves no truncated file. ``vel_model`` /
    ``surface_lla`` select 3-D or multi-profile velocities and topography
    masking (see :func:`build_velocity_volume`). Host code (numpy and the
    C++ solver of ``native.fmm``); returns (shape, lo, h)."""
    from genie_tpu_torch.native.fmm import fast_march

    sta_cart = np.asarray(proj.to_cart_np(sta_lla), np.float32)
    lo, shape, h = fmm_grid_box(cfg, proj)
    vol_p, vol_s = build_velocity_volume(cfg, proj, lo, shape, h,
                                         vel_model=vel_model,
                                         surface_lla=surface_lla)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idxs = range(len(sta_cart)) if station_indices is None else station_indices
    for j in idxs:
        out_path = out_dir / f"travel_time_grid_station_{j}.npz"
        if out_path.exists():
            continue
        t0 = time.time()
        Tp = fast_march(vol_p, h, sta_cart[j][None], origin=lo)
        Ts = fast_march(vol_s, h, sta_cart[j][None], origin=lo)
        # keeps the .npz suffix, or np.savez would append another one
        tmp_path = out_path.with_name(
            f".tmp_{out_path.stem}.{os.getpid()}.npz")
        np.savez_compressed(tmp_path, Tp=Tp, Ts=Ts, origin=lo, h=h, shape=shape)
        os.replace(tmp_path, out_path)
        if verbose:
            print(f"station {j}: fmm {time.time() - t0:.1f}s grid {shape}")
    return shape, lo, h


def rasterize_surface(proj, surface_lla, lo_xy, hi_xy, n: int = 64):
    """Rasterize scattered (lat, lon, elev m) topography points onto an
    (n, n) projected-coordinate grid: the synth generator's depth-clamp
    input (``DomainContext.surface``). Returns (elev (n, n), lo (2,), h (2,))."""
    from scipy.spatial import cKDTree

    surf = np.asarray(surface_lla, np.float64)
    pts = np.asarray(proj.to_cart_np(
        np.concatenate((surf[:, :2], np.zeros((len(surf), 1))), axis=1)))
    lo_xy = np.asarray(lo_xy, np.float64)[:2]
    hi_xy = np.asarray(hi_xy, np.float64)[:2]
    h = (hi_xy - lo_xy) / (n - 1)
    ax = [lo_xy[i] + np.arange(n) * h[i] for i in range(2)]
    gx, gy = np.meshgrid(*ax, indexing="ij")
    j = cKDTree(pts[:, :2]).query(
        np.stack((gx.ravel(), gy.ravel()), axis=-1))[1]
    elev = surf[j, 2].reshape(n, n).astype(np.float32)
    return elev, lo_xy.astype(np.float32), h.astype(np.float32)


def make_trv(cfg: Config, proj: Projection, pinn_path=None, device=None):
    """Travel-time callable: the PINN of ``pinn_path`` if that file exists
    (on ``device``, default ``cuda``), else homogeneous travel times at the
    mean of the 1-D velocity profile."""
    if pinn_path is not None and Path(pinn_path).exists():
        from genie_tpu_torch.params import load_pinn

        return load_pinn(pinn_path, projection=proj, device=device)
    vp = float(np.mean(cfg.velocity.vp))
    vs = float(np.mean(cfg.velocity.vs))
    return HomogeneousTravelTime(proj, vp, vs)


def domain_from_project(root, cfg: Config, trv=None, device=None):
    """Load the project files of :func:`setup.project.init_project` and
    assemble the :class:`DomainContext` on ``device`` (default ``cuda``):
    grid tables from ``trv`` (default :func:`make_trv` without a PINN, the
    homogeneous fallback) and, with ``cfg.travel_time.use_topography``, the
    rasterized ``{region}_surface.npz``. Returns (ctx, projection, trv)."""
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.train.trainer import build_domain_context
    from genie_tpu_torch.utils import compute_travel_times_chunked

    dev = resolve_device(device)
    pj = load_project(root, cfg.region.name)
    proj = pj["projection"]
    trv = trv if trv is not None else make_trv(cfg, proj, device=dev)
    sta_lla = np.asarray(pj["sta_lla"], np.float32)
    sta_cart = np.asarray(proj.to_cart_np(sta_lla), np.float32)
    grids_lla = np.asarray(pj["grids_lla"], np.float32)
    grids_cart = np.stack([np.asarray(proj.to_cart_np(g), np.float32)
                           for g in grids_lla])
    sta_t = torch.as_tensor(sta_cart, device=dev)
    trv_grids = torch.stack([
        compute_travel_times_chunked(trv.from_cart, sta_t, torch.as_tensor(g, device=dev))
        for g in grids_cart])
    surface = None
    if cfg.travel_time.use_topography:
        surf_path = Path(root) / f"{cfg.region.name}_surface.npz"
        if surf_path.exists():
            surf_lla = np.load(surf_path)["lla"]
            lo, shape, h = fmm_grid_box(cfg, proj)
            hi = [lo[i] + (shape[i] - 1) * h for i in range(2)]
            surface = rasterize_surface(proj, surf_lla, lo[:2], hi)
    ctx = build_domain_context(cfg, sta_lla, sta_cart, grids_lla, grids_cart,
                               trv_grids, dev, surface=surface)
    return ctx, proj, trv


# -- scripts/nc_pinn.py: FMM tables → PINN artifact ----------------------------

class PinnBank(NamedTuple):
    """The samples of ``scripts/nc_pinn.py`` (:63-104). ``sta``, ``src``,
    ``t``: the training bank, normalized (positions ``(x − center)/L``,
    times ``/t_scale``); ``val``: ``(sta, src, t)`` of unseen nodes of the
    training stations, ``cross_val``: of the held-out stations, both in
    metres and seconds; ``origin``, ``extent`` (metres): the FMM box."""

    scales: object   # models.travel_time_pinn.ScaleParams, CPU tensors
    sta: np.ndarray
    src: np.ndarray
    t: np.ndarray
    val: tuple
    cross_val: tuple
    origin: np.ndarray
    extent: np.ndarray


def pinn_sample_bank(cfg: Config, sta_cart, tables, rng, per_sta: int = 30000,
                     holdout_every: int = 20) -> PinnBank:
    """Importance-sample every FMM table (``tables[j]`` is the ``.npz`` of
    the station at ``sta_cart[j]``) in order from ``rng``, as
    ``nc_pinn.py`` does: every ``holdout_every``-th station (from the first)
    is held out with 4096 samples; the others give ``per_sta`` training
    samples and 2048 unseen ones. The scales: the centre and
    largest side of the first table's box, the largest S time of all tables
    and the mean profile velocities."""
    from genie_tpu_torch.models.travel_time_pinn import (importance_sample_volume,
                                                         scales_from_domain)

    sta_cart = np.asarray(sta_cart, np.float32)
    z0 = np.load(tables[0])
    origin, h = z0["origin"], float(z0["h"])
    extent = np.asarray(z0["Tp"].shape) * h
    center = origin + extent / 2
    L = float(extent.max())
    v_mean = [float(np.mean(cfg.velocity.vp)), float(np.mean(cfg.velocity.vs))]
    train, val, held = ([], [], []), ([], [], []), ([], [], [])
    t_max = 0.0
    for j, f in enumerate(tables):
        z = np.load(f)
        t_max = max(t_max, float(z["Ts"].max()))
        is_held = j % holdout_every == 0
        n = 4096 if is_held else per_sta + 2048
        src, t = importance_sample_volume(rng, z["Tp"], z["Ts"], z["origin"],
                                          float(z["h"]), sta_cart[j], n)
        sta = np.broadcast_to(sta_cart[j], (n, 3))
        if is_held:
            for acc, a in zip(held, (sta, src, t)):
                acc.append(a)
        else:
            for acc, a in zip(train, (sta, src, t)):
                acc.append(a[:per_sta])
            for acc, a in zip(val, (sta, src, t)):
                acc.append(a[per_sta:])
    scales = scales_from_domain(center, L, t_max, v_mean)
    tau = float(scales.t_scale)

    def cat(parts):
        return tuple(np.concatenate(p) for p in parts)

    sta, src, t = cat(train)
    return PinnBank(scales=scales,
                    sta=((sta - center) / L).astype(np.float32),
                    src=((src - center) / L).astype(np.float32),
                    t=(t / tau).astype(np.float32), val=cat(val), cross_val=cat(held),
                    origin=np.asarray(origin), extent=extent)


def pinn_bank_sampler(bank: PinnBank, device=None):
    """``sample_fn(generator, n)`` for ``train_pinn``: ``n`` rows of the
    bank, uniform with replacement, drawn on ``device`` (default ``cuda``),
    where the bank is copied once."""
    dev = resolve_device(device)
    sta, src, t = (torch.as_tensor(a, device=dev) for a in (bank.sta, bank.src, bank.t))

    def sample_fn(generator, n):
        i = torch.randint(0, t.shape[0], (n,), generator=generator, device=dev)
        return sta[i], src[i], t[i]

    return sample_fn


def pinn_velocity_prior(cfg: Config, scales):
    """``v_init_fn`` of ``nc_pinn.py``: the 1-D profile of ``cfg.velocity``
    at each normalized source's depth, in normalized units (``v·τ/L``)."""
    from genie_tpu_torch.models.travel_time_pinn import interp

    L, tau = float(scales.x_scale), float(scales.t_scale)
    zc = float(scales.center[2])
    prof = [torch.as_tensor(np.asarray(v, np.float32))
            for v in (cfg.velocity.depths, cfg.velocity.vp, cfg.velocity.vs)]

    def v_init_fn(src_n):
        depths, vp, vs = (p.to(src_n.device) for p in prof)
        z = src_n[:, 2] * L + zc
        return torch.stack((interp(z, depths, vp), interp(z, depths, vs)), dim=1) * tau / L

    return v_init_fn


@torch.no_grad()
def pinn_error_stats(trv, sta_cart, src_cart, t_true) -> dict:
    """Median, 90th and 99th percentile of |Δt| (s) between ``trv`` (a
    ``TravelTimePN``) at row-paired stations and sources and ``t_true``,
    evaluated in chunks of 2^20 rows."""
    chunk = 1 << 20
    dev = trv.scales.center.device
    sta = torch.as_tensor(np.ascontiguousarray(sta_cart, np.float32), device=dev)
    src = torch.as_tensor(np.ascontiguousarray(src_cart, np.float32), device=dev)
    pred = torch.cat([trv.pairwise_from_cart(sta[i:i + chunk], src[i:i + chunk])
                      for i in range(0, len(src), chunk)]).cpu().numpy()
    err = np.abs(pred - np.asarray(t_true))
    return {"median_s": float(np.median(err)), "p90_s": float(np.percentile(err, 90)),
            "p99_s": float(np.percentile(err, 99))}


def pinn_velocity_r2(model, cfg: Config, bank: PinnBank, rng):
    """``nc_pinn.py``'s velocity-recovery R² (Vp, Vs) against the 1-D
    profile, at 20,000 normalized positions drawn from ``rng``: horizontal
    over the unit box, depth inside the FMM volume (the velocity head is
    unconstrained outside it)."""
    n = 20000
    from genie_tpu_torch.models.travel_time_pinn import velocity_r2

    scales = bank.scales
    L = float(scales.x_scale)
    center = bank.origin + bank.extent / 2
    src = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    zn = ((bank.origin[2] - center[2]) / L,
          (bank.origin[2] + bank.extent[2] - center[2]) / L)
    src[:, 2] = rng.uniform(zn[0], zn[1], n).astype(np.float32)
    z = src[:, 2] * L + center[2]
    v_true = np.stack((np.interp(z, cfg.velocity.depths, cfg.velocity.vp),
                       np.interp(z, cfg.velocity.depths, cfg.velocity.vs)), axis=1)
    dev = next(model.parameters()).device
    return velocity_r2(model, scales.to(dev), src, v_true)


# -- scripts/nc_optimize_data.py: the generator's Bayesian optimisation --------

def synthetic_pick_statistics(cfg: Config, ctx: DomainContext, trv_from_cart, generator):
    """``bayes_opt.pick_statistics`` of the kept picks of one
    ``synthesize_timeline`` at ``cfg.synth``, drawn from ``generator`` on the
    context's device (the body of ``nc_optimize_data.py``'s objective,
    :66-77); the statistics are taken on the host."""
    from genie_tpu_torch.synth.generator import synthesize_timeline
    from genie_tpu_torch.train.bayes_opt import pick_statistics

    lo_z = float(ctx.offset_cart[2])
    depth_rng = (lo_z, lo_z + float(ctx.scale_cart[2]))
    with torch.no_grad():
        tl = synthesize_timeline(generator, cfg.synth, ctx.sta_cart, trv_from_cart,
                                 ctx.scale_cart, ctx.offset_cart, depth_rng,
                                 n_sta_real=ctx.sta_cart.shape[0])
    m = tl.pick_mask.cpu().numpy()
    return pick_statistics(tl.pick_t.cpu().numpy()[m], tl.pick_sta.cpu().numpy()[m],
                           ctx.sta_cart.cpu().numpy())


def optimize_data_objective(cfg: Config, ctx: DomainContext, trv_from_cart, targets,
                            generator):
    """The objective of ``scripts/nc_optimize_data.py`` (:62-79) for
    ``bayes_opt.gp_minimize`` over ``bayes_opt.PARAM_SPACE``: write the
    vector into ``cfg.synth`` (``apply_params``), synthesize one timeline
    from ``generator`` and return the relative residual of its pick
    statistics against ``targets`` (a list of ``pick_statistics``). The
    loop and its callback stay with the caller, as in the script."""
    from genie_tpu_torch.train.bayes_opt import apply_params, stats_residual

    def objective(x):
        apply_params(cfg.synth, x)
        return stats_residual(synthetic_pick_statistics(cfg, ctx, trv_from_cart,
                                                        generator), targets)

    return objective


def restart_from(path, state: TrainState) -> TrainState:
    """Resume from a checkpoint pickle: a flax pickle such as
    ``projects/NC_EHZ/run6/params.pkl`` (what ``scripts/nc_train.py
    --restart`` reads) or one :func:`train` wrote. Loads the weights, the
    Adam moments and count, and the step."""
    from genie_tpu_torch.io import load_checkpoint

    step = load_checkpoint(path, state.model, state.optimizer)
    return TrainState(state.model, state.optimizer, step)


def train(cfg: Config, ctx: DomainContext, trv, out_dir, n_steps=None,
          log_every: int = 20, seed: int = 0, restart=False,
          profile_at: int | None = None, mesh=None):
    """Training loop on the context's device: a ``Detector`` with
    ``cfg.model``'s options (``use_absolute_pos``,
    ``use_updated_model_definition``, ``normalize_readin``), flax-default
    initial weights, one synthetic batch and one Adam step per iteration, the
    reference's per-step text log ``{region}_output_ver_1.txt`` (the line
    format of the JAX ``workflow.train``), and a checkpoint ``ckpt.pkl`` every
    ``checkpoint_every`` steps and at the end.

    ``restart``: ``True`` resumes from ``out_dir/ckpt.pkl``, a path resumes
    from that pickle (:func:`restart_from`). The batch of step i comes from
    a generator seeded by (seed, i), so a resumed run draws what an
    uninterrupted one would. ``profile_at``: run that step under
    ``torch.profiler`` and write its Chrome trace to ``out_dir/profile``.

    ``mesh`` (:class:`~genie_tpu_torch.parallel.mesh.Mesh`, with ``ctx`` on
    its device): data-parallel training, every rank calling ``train`` with
    the same arguments. The weights start from rank 0's, rank r draws its
    ``n_batch / size`` windows of step i from a generator seeded by (seed,
    i, r), and the gradients are averaged over the ranks
    (``trainer.make_train_step``); rank 0 alone logs, checkpoints and writes
    the trace.

    Returns ``(model, state, history)``; ``history`` holds, per step, the
    metrics as floats and numpy arrays and the step's stage seconds."""
    from genie_tpu_torch.io import save_checkpoint
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.train.trainer import (init_train_state, make_train_step,
                                               step_seed)

    lead = mesh is None or mesh.rank == 0

    dev = ctx.sta_cart.device
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = Detector(scale_rel=cfg.model.scale_rel, kernel_sig_t=cfg.model.kernel_sig_t,
                     use_phase_types=cfg.model.use_phase_types,
                     use_absolute_pos=cfg.model.use_absolute_pos,
                     use_updated_model_definition=cfg.model.use_updated_model_definition,
                     normalize_readin=cfg.model.normalize_readin).to(dev)
    gen = torch.Generator(device=dev)
    state = init_train_state(model, cfg, gen.manual_seed(seed))
    if restart is True:
        state = restart_from(out_dir / "ckpt.pkl", state)
    elif restart:
        state = restart_from(restart, state)
    if mesh is not None:
        from genie_tpu_torch.parallel.mesh import replicate

        replicate(model, mesh)
    step_fn = make_train_step(cfg, ctx, trv.from_cart, mesh=mesh)
    log_path = out_dir / f"{cfg.region.name}_output_ver_1.txt"
    n_steps = n_steps if n_steps is not None else cfg.train.n_steps
    history = []
    t0 = time.time()
    start = state.step
    for i in range(start, n_steps):
        gen.manual_seed(step_seed(seed, i, None if mesh is None else mesh.rank))
        if profile_at is not None and i == profile_at and lead:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                state, metrics = step_fn(state, gen)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            (out_dir / "profile").mkdir(exist_ok=True)
            prof.export_chrome_trace(str(out_dir / "profile" / f"step_{i}.json"))
        else:
            state, metrics = step_fn(state, gen)
        history.append((metrics, dict(step_fn.stage_seconds)))
        if lead and (i % log_every == 0 or i == n_steps - 1):
            trgts = metrics["trgts"].cpu().numpy().round(2)
            preds = metrics["preds"].cpu().numpy().round(2)
            line = (f"step {i} loss {float(metrics['loss']):.5f} "
                    f"grid {float(metrics['loss_grid']):.5f} "
                    f"query {float(metrics['loss_query']):.5f} "
                    f"p {float(metrics['loss_p']):.5f} "
                    f"s {float(metrics['loss_s']):.5f} "
                    f"trgts {trgts} preds {preds} "
                    f"({(time.time() - t0) / max(i - start + 1, 1):.2f}s/step)")
            print(line)
            with open(log_path, "a") as f:
                f.write(line + "\n")
        if lead and ((i + 1) % cfg.train.checkpoint_every == 0 or i == n_steps - 1):
            save_checkpoint(out_dir / "ckpt.pkl", model, state.optimizer, step=i + 1,
                            cfg=cfg)
    history = [({k: (float(v) if v.dim() == 0 else v.cpu().numpy())
                 for k, v in m.items()}, s) for m, s in history]
    return model, state, history


def process_day(cfg: Config, ctx: DomainContext, trv, model, pick_file,
                out_file, t_start=0.0, t_end=86400.0, mag_model=None,
                device=None):
    """One day of continuous processing → catalog hdf5. ``model`` is a
    :class:`Detector` with its weights; ``trv`` has ``from_cart``. With
    ``mag_model`` (``params.load_magnitude_model``) the events get
    magnitudes from the pick file's amplitudes, as ``process`` does when
    given ``pick_amp``."""
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.io import load_picks, save_catalog

    t, sta, phase, amp = load_picks(pick_file)
    pipe = InferencePipeline(model, cfg, ctx, trv.from_cart, mag_model=mag_model,
                             device=device)
    events = pipe.process(t.astype(np.float32), sta, phase.astype(np.float32),
                          t_start, t_end, pick_amp=amp)
    save_catalog(out_file, events, pick_t=t, pick_sta=sta)
    return events
