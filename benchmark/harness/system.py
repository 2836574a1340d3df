"""The system under test: the program's ``InferencePipeline`` for a cell.

Everything here that computes comes from the program (``genie_tpu_torch``);
the benchmark hands it the raw inputs (stations, grid nodes, query nodes,
the artifact files, or weights of its own making) and wraps the pipeline's
stage methods in ``record_function`` ranges named after the stages. The
wrappers also keep what each stage returned, for the check after the
window; they copy nothing on the device and add no synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

STAGES = ("sweep", "candidates", "refine", "associate", "locate", "magnitudes")


def program_config(spec: dict):
    """The program's ``Config`` with the configuration file's values."""
    from genie_tpu_torch.config import Config

    cfg = Config()
    for group in ("region", "graph", "model", "train", "process"):
        sect = getattr(cfg, group)
        for k, v in spec[group].items():
            if not hasattr(sect, k):
                raise KeyError(f"{group}.{k} is not a setting of the program")
            setattr(sect, k, tuple(v) if isinstance(v, list) else v)
    return cfg


def ranged(fn, name):
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


class Record:
    """What one request's stages returned."""

    def __init__(self, chunk: int):
        self.chunk = chunk
        self.sweep = None          # (times, series)
        self.candidates = None     # (srcs, vals) clustered
        self.refine = None         # (srcs_in, vals_in, srcs_out, vals_out)
        self.associate = []        # [(srcs, weights [(arv_p, arv_s)], events)]
        self.located = None        # the located events, before magnitudes
        self.events = None         # the request's final catalog
        self.stage_seconds = {}
        self.launches = 0
        self.t_start = self.t_done = 0.0
        self.error = None


class Capture:
    def __init__(self):
        self.records: list[Record] = []
        self.current: Record | None = None

    def begin(self, chunk: int) -> Record:
        self.current = Record(chunk)
        self.records.append(self.current)
        return self.current


def _event_copy(ev):
    return (np.array(ev.pos_cart, copy=True), float(ev.time), np.array(ev.picks),
            np.array(ev.pick_phases))


def instrument(pipe, cap: Capture):
    """Wrap the pipeline's stage methods (instance attributes, which
    ``process`` looks up first) in ranges and keep their outputs."""
    sweep, cands, clus = pipe.detection_sweep, pipe.extract_candidates, pipe.cluster_candidates
    refine, assoc, window = pipe.refine_sources, pipe.associate_per_source, pipe._assoc_window
    locate, mags = pipe.locate, pipe.assign_magnitudes

    def detection_sweep(*a, **k):
        with record_function("sweep"):
            out = sweep(*a, **k)
        if cap.current is not None:
            cap.current.sweep = out
        return out

    def cluster_candidates(*a, **k):
        with record_function("candidates"):
            out = clus(*a, **k)
        if cap.current is not None:
            cap.current.candidates = (out[0].copy(), out[1].copy())
        return out

    def refine_sources(pick_t, pick_sta, pick_phase, srcs, vals, *a, **k):
        with record_function("refine"):
            out = refine(pick_t, pick_sta, pick_phase, srcs, vals, *a, **k)
        if cap.current is not None:
            cap.current.refine = (srcs.copy(), vals.copy(), out[0].copy(), out[1].copy())
        return out

    def assoc_window(*a, **k):
        out = window(*a, **k)
        if cap.current is not None:
            cap.current.associate[-1][1].append(out)
        return out

    def associate_per_source(pick_t, pick_sta, pick_phase, srcs, *a, **k):
        if cap.current is not None:
            cap.current.associate.append((srcs.copy(), [], None))
        with record_function("associate"):
            events = assoc(pick_t, pick_sta, pick_phase, srcs, *a, **k)
        if cap.current is not None:
            s, w, _ = cap.current.associate[-1]
            cap.current.associate[-1] = (s, w, [_event_copy(ev) for ev in events])
        return events

    def assign_magnitudes(events, *a, **k):
        if cap.current is not None:
            cap.current.located = [_event_copy(ev) for ev in events]
        with record_function("magnitudes"):
            return mags(events, *a, **k)

    pipe.detection_sweep = detection_sweep
    pipe.extract_candidates = ranged(cands, "candidates")
    pipe.cluster_candidates = cluster_candidates
    pipe.refine_sources = refine_sources
    pipe._assoc_window = assoc_window
    pipe.associate_per_source = associate_per_source
    pipe.locate = ranged(locate, "locate")
    pipe.assign_magnitudes = assign_magnitudes
    return pipe


def build_system(spec: dict, inputs, dev, weights_sd=None):
    """The program's pipeline for the configuration ``spec`` on ``dev``:
    grid tables from the PINN shifted by the corrections (as
    ``scripts/nc_process.py --corrections`` builds them), the corrected
    PINN as the pipeline's travel time, the magnitude model where the
    configuration has one, and the detector with the file's weights or with
    ``weights_sd``."""
    from genie_tpu_torch.calibration.corrections import (TravelTimeCorrection,
                                                         interp_weighted)
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.params import (load_flax_params, load_into,
                                        load_magnitude_model, load_pinn)
    from genie_tpu_torch.train.trainer import build_domain_context
    from genie_tpu_torch.utils import compute_travel_times_chunked

    cfg = program_config(spec)
    n_sta = inputs.sta_cart.shape[0]
    pinn = load_pinn(inputs.root / spec["pinn"], device=dev)
    z = np.load(inputs.root / spec["corrections"])
    trv = TravelTimeCorrection(pinn.from_cart, z["grid_cart"], z["coefs"][:, :n_sta]).to(dev)
    sta = torch.as_tensor(inputs.sta_cart, device=dev)
    with torch.no_grad():
        grids = torch.as_tensor(inputs.grids_cart, device=dev)
        trv_grids = torch.stack([compute_travel_times_chunked(pinn.from_cart, sta, g)
                                 for g in grids])
        trv_grids = trv_grids + torch.stack([interp_weighted(trv.grid_cart, trv.coefs, g)
                                             for g in grids])
    ctx = build_domain_context(cfg, inputs.sta_lla, inputs.sta_cart, inputs.grids_lla,
                               inputs.grids_cart, trv_grids, dev)
    mag = None
    if spec.get("magnitudes"):
        mag = load_magnitude_model(inputs.root / spec["magnitudes"], device=dev)
        mag["model"].bias = torch.nn.Parameter(mag["model"].bias[:, :n_sta],
                                               requires_grad=False)
    m = cfg.model
    model = Detector(scale_rel=m.scale_rel, kernel_sig_t=m.kernel_sig_t,
                     use_phase_types=m.use_phase_types, use_absolute_pos=m.use_absolute_pos,
                     use_updated_model_definition=m.use_updated_model_definition,
                     normalize_readin=m.normalize_readin)
    if weights_sd is None:
        load_into(model, load_flax_params(inputs.root / spec["weights"]))
    else:
        model.load_state_dict({k: v.cpu() for k, v in weights_sd.items()})
    pipe = InferencePipeline(model, cfg, ctx, ranged(trv.from_cart, "trv"),
                             x_query_grid=inputs.x_query, mag_model=mag, device=dev)
    return pipe


def launches() -> int:
    from genie_tpu_torch.ops.fused_round import fused_round

    return int(fused_round.launches)


def well_formed(events, with_mag: bool) -> bool:
    """Every event located at finite coordinates, with picks, and with a
    finite magnitude where the configuration has a magnitude model."""
    for ev in events:
        if not (np.isfinite(ev.pos_cart).all() and np.isfinite(ev.time)
                and len(ev.picks) and len(ev.picks) == len(ev.pick_phases)):
            return False
        if with_mag and (ev.mag is None or not np.isfinite(ev.mag)):
            return False
    return True


def event_tuple(ev):
    return (*_event_copy(ev), None if ev.mag is None else float(ev.mag))

