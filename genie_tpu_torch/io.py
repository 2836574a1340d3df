"""File IO: project layout, pick files, day catalogs, HypoDD export, training
checkpoints.

Copied from ``genie_tpu/io.py`` (the filesystem contract of a GENIE
project):

  * pick files ``Picks/{year}/{proj}_{y}_{m}_{d}_ver_{n}.npz`` with field
    ``P`` = rows (time, station_idx, amplitude, phase);
  * day catalogs (hdf5: ``srcs``, ``mags``, ``scores`` and one group per
    event with its pick indices, phases and covariance);
  * the HypoDD ph2dt phase-format text export.

``h5py`` is imported only inside :func:`save_catalog` and
:func:`load_catalog`, so importing this module does not need it.

Training checkpoints (:func:`save_checkpoint` / :func:`load_checkpoint`) are
plain pickles of numpy arrays in flax layout, the format
``scripts/nc_train.py`` writes (``projects/NC_EHZ/run6/params.pkl``), not
the JAX package's orbax directories: orbax is not available where the port
runs. The JAX package reads their weights with ``pickle`` +
``Detector.apply``, and the port reads both its own and ``nc_train.py``'s.

The calibration artifacts (:func:`save_corrections`,
:func:`save_magnitude_model`) are written in the layouts of
``scripts/nc_calibrate.py`` and ``scripts/nc_magnitude.py --save``, which
``scripts/nc_process.py --corrections/--mag-model`` and the port's
``params.load_corrections``/``load_magnitude_model`` read.
"""

from __future__ import annotations

import json
import os
import pickle
import zipfile
from pathlib import Path

import numpy as np


# -- project layout ---------------------------------------------------------

def project_dirs(root, name: str):
    """Create the project directory tree."""
    root = Path(root)
    dirs = {
        "root": root,
        "picks": root / "Picks",
        "catalog": root / "Catalog",
        "grids": root / "Grids",
        "models": root / "GNN_TrainedModels",
        "plots": root / "Plots",
        "calibration": root / "Calibration",
        "travel_times": root / "TravelTimeData",
        "dd_data": root / "DoubleDifferenceData",
        "dd_models": root / "DoubleDifferenceModels",
    }
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    return dirs


# -- picks ------------------------------------------------------------------

def load_picks(path, spr_picks: float = 100.0):
    """Read a pick npz. Field ``P`` rows: (arrival_index_or_time,
    station_idx, [amp…], phase). Integer-like times past one day are sample
    indices at ``spr_picks`` Hz. Returns (times_s, sta_idx, phase,
    amplitudes)."""
    z = np.load(path, allow_pickle=True)
    P = z["P"]
    t = P[:, 0].astype(np.float64)
    if (spr_picks is not None and spr_picks > 0
            and np.abs(t - np.round(t)).max() < 1e-9 and t.max() > 86400):
        t = t / spr_picks
    sta = P[:, 1].astype(np.int64)
    phase = P[:, -1].astype(np.float64) if P.shape[1] >= 3 else np.zeros(len(t))
    amp = P[:, 2].astype(np.float64) if P.shape[1] >= 4 else np.zeros(len(t))
    return t, sta, phase, amp


def save_picks(path, times, sta_idx, phase, amp=None):
    amp = np.zeros(len(times)) if amp is None else amp
    P = np.stack((times, sta_idx, amp, phase), axis=1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, P=P)


def discover_subnetworks(picks_root, n_sta: int, max_days: int = 500):
    """Scan per-day pick files for the station subsets observed in the data.
    Returns (n_days, n_sta) bool masks."""
    masks = []
    files = sorted(Path(picks_root).rglob("*.npz"))[:max_days]
    for f in files:
        try:
            _, sta, _, _ = load_picks(f)
        except (OSError, EOFError, KeyError, ValueError, IndexError,
                zipfile.BadZipFile):   # an unreadable day is skipped
            continue
        m = np.zeros(n_sta, bool)
        m[np.unique(sta[(sta >= 0) & (sta < n_sta)]).astype(int)] = True
        if m.sum() >= 4:
            masks.append(m)
    return np.stack(masks) if masks else np.zeros((0, n_sta), bool)


# -- catalogs ---------------------------------------------------------------

def save_catalog(path, events, pick_t=None, pick_sta=None, extra=None):
    """Write a day catalog hdf5: ``srcs`` (Cartesian + time), ``mags``,
    ``scores`` and per-event pick indices, phases and covariance."""
    import h5py

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        srcs = np.array([[*ev.pos_cart, ev.time] for ev in events]).reshape(-1, 4)
        f.create_dataset("srcs", data=srcs)
        mags = np.array([ev.mag if ev.mag is not None else np.nan for ev in events])
        f.create_dataset("mags", data=mags)
        scores = np.array([ev.score if ev.score is not None else np.nan
                           for ev in events])
        f.create_dataset("scores", data=scores)
        grp = f.create_group("events")
        for i, ev in enumerate(events):
            g = grp.create_group(str(i))
            g.create_dataset("picks", data=np.asarray(ev.picks, np.int64))
            g.create_dataset("phases", data=np.asarray(ev.pick_phases, np.int64))
            if ev.cov is not None:
                g.create_dataset("cov", data=ev.cov)
        if pick_t is not None:
            f.create_dataset("pick_t", data=np.asarray(pick_t))
            f.create_dataset("pick_sta", data=np.asarray(pick_sta))
        if extra:
            for k, v in extra.items():
                f.attrs[k] = v


def load_catalog(path):
    """Read a day catalog hdf5 into the port's ``CatalogEvent`` list."""
    import h5py

    from genie_tpu_torch.infer.pipeline import CatalogEvent

    events = []
    with h5py.File(path, "r") as f:
        srcs = np.asarray(f["srcs"])
        mags = np.asarray(f["mags"]) if "mags" in f else np.full(len(srcs), np.nan)
        scores = (np.asarray(f["scores"]) if "scores" in f
                  else np.full(len(srcs), np.nan))
        for i in range(len(srcs)):
            g = f["events"][str(i)]
            events.append(CatalogEvent(
                pos_cart=srcs[i, :3], time=float(srcs[i, 3]),
                picks=np.asarray(g["picks"]), pick_phases=np.asarray(g["phases"]),
                cov=np.asarray(g["cov"]) if "cov" in g else None,
                mag=None if np.isnan(mags[i]) else float(mags[i]),
                score=None if np.isnan(scores[i]) else float(scores[i]),
            ))
    return events


def export_hypodd_phase(path, events, pick_t, pick_sta, sta_names, projection=None):
    """HypoDD ph2dt phase-format text export: an event line, then one line
    per pick (station, time, weight, phase)."""
    lines = []
    for i, ev in enumerate(events):
        if projection is not None:
            lla = np.asarray(projection.to_lla_np(ev.pos_cart[None]))[0]
            lat, lon, dep_km = lla[0], lla[1], -lla[2] / 1e3
        else:
            lat, lon, dep_km = 0.0, 0.0, -ev.pos_cart[2] / 1e3
        lines.append(f"# 2000 01 01 00 00 {ev.time:9.3f} {lat:9.4f} {lon:10.4f} "
                     f"{dep_km:7.2f} 0.0 0.0 0.0 0.0 {i + 1}")
        for p, ph in zip(ev.picks, ev.pick_phases):
            name = sta_names[pick_sta[p]] if sta_names is not None else str(pick_sta[p])
            lines.append(f"{name:<8s} {pick_t[p] - ev.time:8.3f} 1.0 {'P' if ph == 0 else 'S'}")
    Path(path).write_text("\n".join(lines) + "\n")


# -- training checkpoints -----------------------------------------------------

def save_checkpoint(path, model, optimizer=None, step: int = 0, cfg=None):
    """Atomically (temp file + ``os.replace``) pickle ``{"params": {"params":
    weights}, "opt_state": {"count", "mu", "nu"}, "step", "config"}``, every
    tree in flax layout (``params.to_flax``); ``mu``/``nu`` are
    ``{"params": tree}`` like the weights, as optax keeps them."""
    from genie_tpu_torch.params import to_flax
    from genie_tpu_torch.train.trainer import adam_state

    blob = {"params": {"params": to_flax(model)}, "step": int(step),
            "config": None if cfg is None else cfg.to_dict()}
    if optimizer is not None:
        st = adam_state(optimizer, model)
        blob["opt_state"] = {"count": np.int32(st["count"]),
                             "mu": {"params": to_flax(st["mu"])},
                             "nu": {"params": to_flax(st["nu"])}}
    return _write_pickle_atomic(path, blob)


def _write_pickle_atomic(path, blob) -> Path:
    """Pickle ``blob`` to a temporary name beside ``path`` and rename it
    into place, so a reader never sees a half-written file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".tmp_{os.getpid()}_{path.name}")
    tmp.write_bytes(pickle.dumps(blob))
    os.replace(tmp, path)
    return path


def load_checkpoint(path, model, optimizer=None) -> int:
    """Load a checkpoint pickle (this module's or ``nc_train.py``'s) into
    ``model`` and, when given, its Adam ``optimizer`` (the pickle must then
    hold an Adam state). Returns the checkpoint's step."""
    from genie_tpu_torch.params import _adam_state, _load_pickle, _weight_tree, load_into
    from genie_tpu_torch.train.trainer import set_adam_state

    blob = _load_pickle(path)
    load_into(model, _weight_tree(blob))
    if optimizer is not None:
        set_adam_state(optimizer, model, _adam_state(blob, path))
    return int(np.asarray(blob.get("step", 0)))


# -- travel-time artifact ------------------------------------------------------

def save_pinn(path, model, scales, metrics: dict):
    """The PINN artifact of ``scripts/nc_pinn.py`` (``Grids/pinn_nc.pkl``),
    written atomically: ``{"params": {"params": weights in flax layout},
    "scales": {center, x_scale, t_scale, v_mean} as float32 arrays,
    "metrics"}``. The JAX ``workflow.make_trv`` and ``params.load_pinn``
    read it."""
    from genie_tpu_torch.params import to_flax

    blob = {"params": {"params": to_flax(model)},
            "scales": {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                                     else v, np.float32)
                       for k, v in scales._asdict().items()},
            "metrics": metrics}
    return _write_pickle_atomic(path, blob)


# -- calibration artifacts ------------------------------------------------------

def save_corrections(path, grid_cart, coefs, stats: dict):
    """Travel-time corrections ``.npz``: ``grid_cart`` (n_grid, 3),
    ``coefs`` (n_grid, n_sta, 2) and ``stats``, a JSON string."""
    def arr(a):
        return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)

    np.savez_compressed(path, grid_cart=arr(grid_cart), coefs=arr(coefs),
                        stats=json.dumps(stats))
    return Path(path)


def save_magnitude_model(path, model, grid_cart, dist_model, vald=None):
    """Magnitude-model pickle: ``params`` (the flax variables ``{"params":
    weights}``), ``grid_cart``, ``k``, ``n_sta``, ``vald`` (the holdout
    summary) and ``dist_model`` (``fit_magnitude_distance_params``)."""
    from genie_tpu_torch.params import to_flax

    blob = {"params": {"params": to_flax(model)},
            "grid_cart": np.asarray(grid_cart, np.float32), "k": int(model.k),
            "n_sta": int(model.n_sta), "vald": vald, "dist_model": dist_model}
    Path(path).write_bytes(pickle.dumps(blob))
    return Path(path)
