"""Calibration, the twin of ``scripts/calibrate.py`` (the reference's
``apply_calibration_routines.py`` + ``calibrate_and_apply_magnitude_scale.py``):
match a produced catalog to a reference catalog, print the detection and
residual statistics and, with ``--fit-corrections``, fit travel-time
corrections on the card.

    python -m genie_tpu_torch.scripts.calibrate <root> <catalog.hdf5> \\
        <reference.npz> [--fit-corrections] [--device cpu]
      where reference.npz has srcs_ref (n, 4: x, y, z cart + t) [+ mags_ref]

As the JAX command does, the fit takes homogeneous travel times at the
mean profile velocities (``make_trv`` without the PINN) and the first
source grid, and writes
``Grids/{region}_calibrated_travel_time_corrections_ver_1.npz``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from genie_tpu_torch.scripts import add_device_argument


def correction_observations(events, pick_t, pick_sta, srcs_det, srcs_ref, n_sta: int):
    """The fit's data (host code): the events matched to the reference
    (bipartite matching at the default σ), each matched event's picks as
    arrivals after its reference origin time. Returns (reference positions
    (n_matched, 3) f32, obs (n_matched, n_sta, 2), mask, like obs)."""
    from genie_tpu_torch.infer.assign import maximize_bipartite_assignment

    ia, ib = maximize_bipartite_assignment(srcs_det, srcs_ref)
    obs = np.zeros((len(ia), n_sta, 2), np.float32)
    msk = np.zeros_like(obs)
    for row, i in enumerate(ia):
        ev = events[i]
        for p, ph in zip(ev.picks, ev.pick_phases):
            obs[row, pick_sta[p], ph] = pick_t[p] - srcs_ref[ib[row], 3]
            msk[row, pick_sta[p], ph] = 1.0
    return np.asarray(srcs_ref[ib, :3], np.float32), obs, msk


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("catalog")
    ap.add_argument("reference")
    ap.add_argument("--config", default=None)
    ap.add_argument("--fit-corrections", action="store_true")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.calibration.corrections import (fit_corrections,
                                                         matched_catalog_stats)
    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.io import load_catalog
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.workflow import domain_from_project, make_trv

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    events = load_catalog(args.catalog)
    ref = np.load(args.reference)
    srcs_det = np.array([[*ev.pos_cart, ev.time] for ev in events]).reshape(-1, 4)
    srcs_ref = ref["srcs_ref"]
    stats = matched_catalog_stats(srcs_det, srcs_ref, mags_ref=ref.get("mags_ref"))
    for k, v in stats.items():
        print(f"{k}: {v}")

    if args.fit_corrections and stats["n_matched"] > 0:
        import h5py

        pj = load_project(args.root, cfg.region.name)
        ctx, proj, trv = domain_from_project(
            args.root, cfg, trv=make_trv(cfg, pj["projection"], device=dev), device=dev)
        with h5py.File(args.catalog, "r") as f:
            pick_t = np.asarray(f["pick_t"])
            pick_sta = np.asarray(f["pick_sta"])
        src, obs, msk = correction_observations(events, pick_t, pick_sta, srcs_det,
                                                srcs_ref, ctx.sta_cart.shape[0])
        coefs, loss = fit_corrections(trv.from_cart, ctx.sta_cart, ctx.grids_cart[0],
                                      src, obs, msk, device=dev)
        out = (Path(args.root) / "Grids" /
               f"{cfg.region.name}_calibrated_travel_time_corrections_ver_1.npz")
        np.savez(out, coefs=coefs.cpu().numpy(), grid=ctx.grids_cart[0].cpu().numpy())
        print(f"corrections fit (loss {loss:.4f}) → {out}")


if __name__ == "__main__":
    main()
