"""Catalog assembly and magnitude application.

Copied from ``genie_tpu/calibration/magnitude_scale.py``: merge daily
catalogs, CSV export, the fit of the magnitude → association-distance model
and its evaluation. :func:`apply_magnitudes` runs the port's
:class:`~genie_tpu_torch.models.magnitude.MagnitudeModel`: the observations
of every event go to the device in one call, and each event's median is
taken on the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def merge_daily_catalogs(paths, out_hdf5=None):
    """Concatenate day catalogs (``io.save_catalog`` format) into one list,
    optionally saving them again as one project hdf5."""
    from genie_tpu_torch.io import load_catalog, save_catalog

    events = []
    for p in sorted(paths):
        events.extend(load_catalog(p))
    if out_hdf5 is not None:
        save_catalog(out_hdf5, events)
    return events


def write_csv_catalog(path, events, projection=None):
    """CSV catalog export (lat, lon, depth_m, time_s, mag, n_picks)."""
    lines = ["lat,lon,depth_m,time_s,mag,n_picks"]
    for ev in events:
        if projection is not None:
            lla = np.asarray(projection.to_lla_np(ev.pos_cart[None]))[0]
        else:
            lla = ev.pos_cart
        mag = ev.mag if ev.mag is not None else float("nan")
        lines.append(f"{lla[0]:.5f},{lla[1]:.5f},{lla[2]:.1f},"
                     f"{ev.time:.3f},{mag:.2f},{len(ev.picks)}")
    Path(path).write_text("\n".join(lines) + "\n")


@torch.no_grad()
def apply_magnitudes(events, model, sta_cart, grid_cart, pick_sta, pick_amp):
    """Give each event the median inverted magnitude over its picks with
    positive amplitude. ``model`` is a :class:`MagnitudeModel` with its
    weights; the inversion runs on its device."""
    rows, src, phase, owner = [], [], [], []
    for i, ev in enumerate(events):
        ok = pick_amp[ev.picks] > 0
        if not ok.any():
            continue
        rows.append(ev.picks[ok])
        phase.append(np.asarray(ev.pick_phases)[ok])
        src.append(np.repeat(np.asarray(ev.pos_cart, np.float32)[None], ok.sum(), 0))
        owner.append(i)
    if not rows:
        return events
    dev = model.bias.device
    picks = np.concatenate(rows)
    log_amp = np.log10(np.maximum(pick_amp[picks], 1e-12)).astype(np.float32)
    mags = model(torch.as_tensor(np.concatenate(src), device=dev),
                 torch.as_tensor(sta_cart, dtype=torch.float32, device=dev),
                 torch.as_tensor(grid_cart, dtype=torch.float32, device=dev),
                 torch.as_tensor(pick_sta[picks], device=dev),
                 torch.as_tensor(np.concatenate(phase).astype(np.int64), device=dev),
                 log_amp=torch.as_tensor(log_amp, device=dev)).cpu().numpy()
    bounds = np.cumsum([0] + [len(r) for r in rows])
    for j, i in enumerate(owner):
        events[i].mag = float(np.median(mags[bounds[j]:bounds[j + 1]]))
    return events


def _softplus_dist(m, a, b, c, d0):
    return a * np.log1p(np.exp(np.clip(b * (np.asarray(m) - c), -50, 50))) + d0


def fit_magnitude_distance_params(mags, dists, n_grid: int = 30,
                                  quantile: float = 0.95):
    """Fit the monotone magnitude → max-association-distance relation: a
    binned ``quantile`` fit with enforced monotonicity, then a Softplus
    least-squares fit. Returns a picklable params dict for
    :func:`eval_magnitude_distance`."""
    mags = np.asarray(mags)
    dists = np.asarray(dists)
    bins = np.linspace(mags.min(), mags.max() + 1e-6, n_grid)
    centers, qv = [], []
    for lo, hi in zip(bins[:-1], bins[1:]):
        sel = (mags >= lo) & (mags < hi)
        if sel.sum() >= 3:
            centers.append(0.5 * (lo + hi))
            qv.append(np.quantile(dists[sel], quantile))
    centers = np.asarray(centers)
    qv = np.maximum.accumulate(np.asarray(qv))  # enforce monotone

    # parametric: d(m) = a * softplus(b * (m - c)) + d0
    from scipy.optimize import curve_fit

    try:
        p0 = (np.ptp(qv) if len(qv) else 1e5, 1.0, float(np.median(centers)), qv.min())
        popt, _ = curve_fit(_softplus_dist, centers, qv, p0=p0, maxfev=20000)
        return {"kind": "softplus", "popt": np.asarray(popt, np.float64),
                "centers": centers, "q": qv}
    except (RuntimeError, ValueError, TypeError):
        return {"kind": "interp", "centers": centers, "q": qv}


def eval_magnitude_distance(params, m):
    """Evaluate the fitted magnitude → max-association-distance curve."""
    if params.get("kind") == "softplus":
        return _softplus_dist(m, *params["popt"])
    return np.interp(np.asarray(m), params["centers"], params["q"])


def fit_magnitude_distance_model(mags, dists, n_grid: int = 30):
    """Callable wrapper around :func:`fit_magnitude_distance_params`."""
    params = fit_magnitude_distance_params(mags, dists, n_grid=n_grid)
    return lambda m: eval_magnitude_distance(params, m)
