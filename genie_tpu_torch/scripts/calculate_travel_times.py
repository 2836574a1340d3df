"""The travel-time engine, the twin of ``scripts/calculate_travel_times.py``
(the reference's ``calculate_travel_times_3D_build_data.py``, FMM tables
sharded over jobs, and ``..._train_model.py``, the PINN fit):

    # build FMM tables (host code; optionally sharded: --job i --n-jobs N)
    python -m genie_tpu_torch.scripts.calculate_travel_times <root> build \\
        [--job 0 --n-jobs 1]
    # train the physics-informed surrogate on the tables, on the card
    python -m genie_tpu_torch.scripts.calculate_travel_times <root> train \\
        [--steps 20000] [--batch 4096]

``train`` samples (station, node, P/S time) tuples uniformly from the
stacked FMM volumes on the card and writes
``Grids/travel_time_neural_network_physics_informed_p_s_ver_1.pkl`` in the
``{"params", "scales"}`` layout that both packages' ``make_trv`` read (plus
``"metrics"``: steps, batch, seconds and the mean loss of the first and
last 50 steps).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from genie_tpu_torch.scripts import PINN_FILE, add_device_argument


def fit_pinn(cfg, sta_cart, Tp, Ts, origin, h, n_steps: int, batch: int,
             log_every: int = 500, device=None):
    """Train ``TravelTimesPN`` from flax-default weights on FMM volumes:
    ``sta_cart`` (n_tab, 3) the tables' stations, ``Tp``/``Ts`` (n_tab, nx,
    ny, nz) their P and S times, ``origin``/``h`` the box. Every batch is
    ``batch`` uniform draws of (table, cell) from the volumes, stacked on
    ``device`` (default ``cuda``). Scales from the box (centre, largest
    side), the largest S time and the mean profile velocities; Adam at 1e-3
    after clipping to global norm 1; draws from a ``torch.Generator``
    seeded 0. Returns (model, scales, history), as ``train_pinn``."""
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.models.travel_time_pinn import (TravelTimesPN,
                                                         scales_from_domain, train_pinn)

    dev = resolve_device(device)
    Tp = torch.as_tensor(np.asarray(Tp, np.float32), device=dev)
    Ts = torch.as_tensor(np.asarray(Ts, np.float32), device=dev)
    extent = np.asarray(Tp.shape[1:]) * h
    center = np.asarray(origin) + extent / 2
    L = float(extent.max())
    t_max = float(Ts.max())
    v_mean = [float(np.mean(cfg.velocity.vp)), float(np.mean(cfg.velocity.vs))]
    scales = scales_from_domain(center, L, t_max, v_mean)
    sta_n = torch.as_tensor(((np.asarray(sta_cart, np.float32) - center) / L)
                            .astype(np.float32), device=dev)
    origin_t = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    center_t = torch.as_tensor(center.astype(np.float32), device=dev)
    t_scale = float(scales.t_scale)

    def sample_fn(generator, n):
        # uniform (table, cell) draws, as the JAX command's sample_fn
        si = torch.randint(0, Tp.shape[0], (n,), generator=generator, device=dev)
        ijk = torch.stack([torch.randint(0, s, (n,), generator=generator, device=dev)
                           for s in Tp.shape[1:]], dim=1)
        tp = Tp[si, ijk[:, 0], ijk[:, 1], ijk[:, 2]]
        ts = Ts[si, ijk[:, 0], ijk[:, 1], ijk[:, 2]]
        src = (origin_t + ijk * h - center_t) / L
        return sta_n[si], src, torch.stack((tp, ts), dim=1) / t_scale

    gen = torch.Generator(device=dev).manual_seed(0)
    model, history = train_pinn(gen, TravelTimesPN(), scales, sample_fn, n_steps=n_steps,
                                batch=batch, log_every=log_every, device=dev)
    return model, scales, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("mode", choices=["build", "train"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--job", type=int, default=0)
    ap.add_argument("--n-jobs", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=4096)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.workflow import build_fmm_tables

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    pj = load_project(args.root, cfg.region.name)
    proj = pj["projection"]
    sta_lla = np.asarray(pj["sta_lla"], float)
    tt_dir = Path(args.root) / "TravelTimeData"

    if args.mode == "build":
        idxs = [j for j in range(len(sta_lla)) if j % args.n_jobs == args.job]
        build_fmm_tables(cfg, proj, sta_lla, tt_dir, station_indices=idxs)
        return

    from genie_tpu_torch.io import save_pinn

    files = sorted(tt_dir.glob("travel_time_grid_station_*.npz"))
    if not files:
        raise SystemExit("no FMM tables; run 'build' first")
    vols = [np.load(f) for f in files]
    sta_idx = [int(f.stem.split("_")[-1]) for f in files]
    sta_cart = np.asarray(proj.to_cart_np(sta_lla), np.float32)
    t0 = time.time()
    model, scales, history = fit_pinn(
        cfg, sta_cart[sta_idx], np.stack([v["Tp"] for v in vols]),
        np.stack([v["Ts"] for v in vols]), vols[0]["origin"], float(vols[0]["h"]),
        args.steps, args.batch, device=dev)
    loss = history["total"].cpu().numpy()
    metrics = {"n_steps": args.steps, "batch": args.batch,
               "seconds": time.time() - t0,
               "loss_first": float(loss[:50].mean()), "loss_last": float(loss[-50:].mean())}
    out = save_pinn(Path(args.root) / PINN_FILE, model, scales, metrics)
    print(f"pinn loss {metrics['loss_first']:.5f} (first 50 steps) -> "
          f"{metrics['loss_last']:.5f} (last 50)")
    print(f"saved PINN to {out}")


if __name__ == "__main__":
    main()
