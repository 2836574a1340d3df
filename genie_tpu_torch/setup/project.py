"""Project setup from files: the reference's ``make_initial_files.py`` +
``assemble_network_data.py`` workflow as library functions.

Port of ``genie_tpu/setup/project.py`` (:31-253). For a named project
directory it builds:
  * ``{name}_stations.npz`` (locs lat/lon/elev, names, projection
    rbest/mn), from ``stations.txt`` (name lat lon elev) or arrays;
  * ``{name}_region.npz`` (lat/lon/depth ranges, padding), the 1-D
    velocity model and the directory tree;
  * k-means-packed spatial source grids ``Grids/..._templates_ver_1.npz``,
    Lloyd iterations on the device from a ``torch.Generator`` seeded from
    ``seed`` (the JAX package draws from a JAX key, so the nodes differ from
    its nodes but not in distribution);
  * conversion of ``picks.txt`` → per-day ``Picks/`` npz and of a
    HypoDD-format ``catalog.txt`` → ``Catalog/`` hdf5 (``h5py`` is
    imported inside the catalog writer, so this runs where h5py is).

The FDSN station download (obspy, network) is not ported: pass station
arrays or a stations.txt.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from genie_tpu_torch.config import Config
from genie_tpu_torch.device import resolve_device
from genie_tpu_torch.geometry import Projection, fit_projection
from genie_tpu_torch.graphs.build import kmeans_packing
from genie_tpu_torch.io import project_dirs, save_picks


def read_stations_txt(path):
    """Parse ``stations.txt``: name lat lon elev(m) per line."""
    names, rows = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 4:
            continue
        names.append(parts[0])
        rows.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(rows), np.asarray(names)


def init_project(root, cfg: Config, sta_lla=None, sta_names=None,
                 stations_txt=None, n_steps_grids: int = 800, seed: int = 0,
                 device=None):
    """Create the project tree, projection, stations.npz, region.npz, the
    velocity model and ``cfg.graph.n_grids`` spatial grids of
    ``cfg.graph.n_spatial_nodes`` nodes (depth-weighted k-means, Lloyd
    iterations on ``device``, default ``cuda``). Stations come from
    ``sta_lla`` arrays or a ``stations_txt`` file. Returns (dirs,
    projection, grids_lla (n_grids, n_nodes, 3) float32)."""
    dirs = project_dirs(root, cfg.region.name)
    if sta_lla is None:
        if stations_txt is None:
            raise ValueError("provide sta_lla arrays or a stations_txt path "
                             "(the FDSN download is not ported)")
        sta_lla, sta_names = read_stations_txt(stations_txt)

    rbest, mn = fit_projection(cfg.region.center,
                               spherical=cfg.region.use_spherical)
    proj = Projection(rbest, mn, spherical=cfg.region.use_spherical)

    np.savez(
        dirs["root"] / f"{cfg.region.name}_stations.npz",
        locs=sta_lla, stas=np.asarray(sta_names if sta_names is not None
                                      else [f"S{i}" for i in range(len(sta_lla))]),
        rbest=rbest, mn=mn,
    )
    scale, offset = cfg.region.scale_offset(extend=True)
    np.savez(
        dirs["root"] / f"{cfg.region.name}_region.npz",
        lat_range=cfg.region.lat_range, lon_range=cfg.region.lon_range,
        depth_range=cfg.region.depth_range,
        degree_padding=cfg.region.degree_padding,
        scale_x_extend=np.asarray(scale), offset_x_extend=np.asarray(offset),
    )
    np.savez(
        dirs["root"] / "1d_velocity_model.npz",
        Depths=np.asarray(cfg.velocity.depths),
        Vp=np.asarray(cfg.velocity.vp), Vs=np.asarray(cfg.velocity.vs),
    )

    # spatial grids: depth-up-weighted k-means packing
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    weight = np.array([1.0, 1.0, 2.5])
    grids = np.stack([
        kmeans_packing(gen, np.asarray(scale), np.asarray(offset),
                       cfg.graph.n_spatial_nodes, proj.to_cart, weight=weight,
                       n_steps=n_steps_grids).cpu().numpy()
        for _ in range(cfg.graph.n_grids)])
    np.savez(dirs["grids"] / f"{cfg.region.name}_seismic_network_templates_ver_1.npz",
             x_grids=grids)
    return dirs, proj, grids


def convert_picks_txt(path, dirs, cfg: Config, sta_names, day_length: float = 86400.0):
    """picks.txt rows: (origin-day string or day index, time-of-day s,
    station name, phase, [amp]) → per-day ``Picks/`` npz files."""
    by_day: dict[str, list] = {}
    name_to_idx = {n: i for i, n in enumerate(np.asarray(sta_names))}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 4:
            continue
        day, t, name, phase = parts[0], float(parts[1]), parts[2], parts[3]
        amp = float(parts[4]) if len(parts) > 4 else 0.0
        if name not in name_to_idx:
            continue
        by_day.setdefault(day, []).append(
            (t, name_to_idx[name], amp, 0.0 if phase.upper().startswith("P") else 1.0))
    for day, rows in by_day.items():
        rows = np.asarray(rows)
        # canonical unpadded int components: the names
        # convert_hypodd_catalog looks up for amplitude matching
        y, m, d = (int(p) for p in (day.split("-") + ["1", "1"])[:3])
        out = dirs["picks"] / str(y) / f"{cfg.region.name}_{y}_{m}_{d}_ver_1.npz"
        save_picks(out, rows[:, 0], rows[:, 1].astype(int), rows[:, 3], rows[:, 2])
    return sorted(by_day)


def load_project(root, name: str):
    """Load stations/region/grids written by :func:`init_project` (or by the
    JAX package's)."""
    root = Path(root)
    st = np.load(root / f"{name}_stations.npz", allow_pickle=True)
    rg = np.load(root / f"{name}_region.npz")
    gr = np.load(root / "Grids" / f"{name}_seismic_network_templates_ver_1.npz")
    proj = Projection(st["rbest"], st["mn"])
    return {
        "sta_lla": st["locs"], "sta_names": st["stas"], "projection": proj,
        "region": {k: rg[k] for k in rg.files},
        "grids_lla": gr["x_grids"],
    }


def parse_hypodd_catalog(path, sta_names):
    """Parse a HypoDD-format ``catalog.txt``.

    Source lines start with ``#``:
        # yr mo dy hr mn sec lat lon depth_km mag eh_km ez_km [rms id]
    followed by pick lines:
        sta_name  travel_time_s  prob  P|S

    Returns a list of dicts per source: ``{"date": (y, m, d), "tod": s,
    "lla": (lat, lon, depth_m), "mag": m, "sigma_m": mean(eh, ez) in metres,
    "picks": (n, 4) array of (time_of_day_s, sta_idx, prob, phase)}``.
    Picks whose station is not in ``sta_names`` raise.
    """
    from datetime import datetime, timedelta

    name_to_idx = {str(n): i for i, n in enumerate(np.asarray(sta_names))}
    events, cur = [], None
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "#":
            if len(parts) < 13:
                import warnings
                warnings.warn(f"skipping malformed source line: {line!r}")
                cur = {"picks": [], "tod": 0.0}  # discard bucket for its picks
                continue
            yr, mo, dy, hr, mi = (int(p) for p in parts[1:6])
            t = datetime(yr, mo, dy, hr, mi) + timedelta(seconds=float(parts[6]))
            tod = (t - datetime(t.year, t.month, t.day)).total_seconds()
            cur = {"date": (t.year, t.month, t.day), "tod": tod,
                   "lla": (float(parts[7]), float(parts[8]),
                           -1000.0 * float(parts[9])),
                   "mag": float(parts[10]),
                   "sigma_m": 500.0 * (float(parts[11]) + float(parts[12])),
                   "picks": []}
            events.append(cur)
        else:
            if cur is None:
                raise ValueError("pick line before any source line")
            name, tt, prob, phase = parts[0], float(parts[1]), float(parts[2]), parts[3]
            if name not in name_to_idx:
                raise ValueError(f"pick station {name!r} not in stations file")
            if phase not in ("P", "S"):
                raise ValueError(f"phase must be P or S, got {phase!r}")
            cur["picks"].append((cur["tod"] + tt, name_to_idx[name], prob,
                                 0.0 if phase == "P" else 1.0))
    for ev in events:
        ev["picks"] = (np.asarray(ev["picks"], np.float64).reshape(-1, 4)
                       if ev["picks"] else np.zeros((0, 4)))
    return events


def convert_hypodd_catalog(path, dirs, cfg: Config, sta_names, projection,
                           amp_match_tol: float = 1.0):
    """HypoDD ``catalog.txt`` → per-day ``Catalog/`` hdf5 files.

    Events are grouped by calendar day; each day file stores the event
    hypocentres (Cartesian, via ``projection``), origin times-of-day,
    magnitudes, location uncertainty, and per-event pick lists indexing the
    day's concatenated pick arrays. If a converted ``Picks/`` npz exists for
    the day, pick amplitudes are matched within ``amp_match_tol`` seconds at
    the same station.

    Returns the sorted list of day keys written.
    """
    from genie_tpu_torch.infer.pipeline import CatalogEvent
    from genie_tpu_torch.io import load_picks, save_catalog

    events = parse_hypodd_catalog(path, sta_names)
    by_day: dict[tuple, list] = {}
    for ev in events:
        by_day.setdefault(ev["date"], []).append(ev)

    days = []
    for (y, m, d), evs in sorted(by_day.items()):
        # day pick arrays = concatenation of the events' picks
        pick_rows = np.concatenate([ev["picks"] for ev in evs], axis=0)
        offs = np.cumsum([0] + [len(ev["picks"]) for ev in evs])
        amps = np.zeros(len(pick_rows))
        pick_file = (dirs["picks"] / str(y) /
                     f"{cfg.region.name}_{y}_{m}_{d}_ver_1.npz")
        if pick_file.exists() and len(pick_rows):
            pt, ps, _, pa = load_picks(pick_file)
            for i, (t, s, _, _) in enumerate(pick_rows):
                same = np.where(ps == int(s))[0]
                if len(same):
                    j = same[np.argmin(np.abs(pt[same] - t))]
                    if abs(pt[j] - t) <= amp_match_tol:
                        amps[i] = pa[j]
        cat_events = []
        for k, ev in enumerate(evs):
            pos = np.asarray(projection.to_cart_np(
                np.asarray(ev["lla"], np.float64)[None]))[0]
            cat_events.append(CatalogEvent(
                pos_cart=pos.astype(np.float32), time=float(ev["tod"]),
                picks=np.arange(offs[k], offs[k + 1]),
                pick_phases=ev["picks"][:, 3].astype(np.int64),
                mag=ev["mag"]))
        out = (dirs["catalog"] / str(y) /
               f"{cfg.region.name}_results_continuous_days_{y}_{m}_{d}_ver_1.hdf5")
        save_catalog(out, cat_events, pick_t=pick_rows[:, 0],
                     pick_sta=pick_rows[:, 1].astype(np.int64),
                     extra={"sigma_m": np.asarray([ev["sigma_m"] for ev in evs]),
                            "amp": amps})
        days.append(f"{y}-{m}-{d}")
    return days
