"""High-level workflow: the travel-time callable of a project and one day of
continuous processing, picks file in, catalog hdf5 out.

Port of ``genie_tpu/workflow.py`` ``make_trv`` (:186-200) and
``process_day`` (:298-309). The FMM tables, the velocity volumes and the
training loop (``train``) are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.train.trainer import DomainContext


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
