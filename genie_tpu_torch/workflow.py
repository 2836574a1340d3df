"""High-level workflow: the travel-time callable of a project, the training
loop, and one day of continuous processing, picks file in, catalog hdf5
out.

Port of ``genie_tpu/workflow.py`` ``make_trv`` (:186-200), ``train``
(:230-295) and ``process_day`` (:298-309). The FMM tables and the velocity
volumes are not ported yet; ``train`` has no wandb hook.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.train.trainer import DomainContext, TrainState


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
          profile_at: int | None = None):
    """Training loop on the context's device: flax-default initial
    weights, one synthetic batch and one Adam step per iteration, the
    reference's per-step text log ``{region}_output_ver_1.txt`` (the line
    format of the JAX ``workflow.train``), and a checkpoint ``ckpt.pkl`` every
    ``checkpoint_every`` steps and at the end.

    ``restart``: ``True`` resumes from ``out_dir/ckpt.pkl``, a path resumes
    from that pickle (:func:`restart_from`). The batch of step i comes from
    a generator seeded by (seed, i), so a resumed run draws what an
    uninterrupted one would. ``profile_at``: run that step under
    ``torch.profiler`` and write its Chrome trace to ``out_dir/profile``.

    Returns ``(model, state, history)``; ``history`` holds, per step, the
    metrics as floats and numpy arrays and the step's stage seconds."""
    from genie_tpu_torch.io import save_checkpoint
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.train.trainer import (init_train_state, make_train_step,
                                               step_seed)

    if cfg.model.normalize_readin:
        raise NotImplementedError("normalize_readin is not ported yet")
    dev = ctx.sta_cart.device
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = Detector(scale_rel=cfg.model.scale_rel, kernel_sig_t=cfg.model.kernel_sig_t,
                     use_phase_types=cfg.model.use_phase_types,
                     use_absolute_pos=cfg.model.use_absolute_pos,
                     use_updated_model_definition=cfg.model.use_updated_model_definition
                     ).to(dev)
    gen = torch.Generator(device=dev)
    state = init_train_state(model, cfg, gen.manual_seed(seed))
    if restart is True:
        state = restart_from(out_dir / "ckpt.pkl", state)
    elif restart:
        state = restart_from(restart, state)
    step_fn = make_train_step(cfg, ctx, trv.from_cart)
    log_path = out_dir / f"{cfg.region.name}_output_ver_1.txt"
    n_steps = n_steps if n_steps is not None else cfg.train.n_steps
    history = []
    t0 = time.time()
    start = state.step
    for i in range(start, n_steps):
        gen.manual_seed(step_seed(seed, i))
        if profile_at is not None and i == profile_at:
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
        if i % log_every == 0 or i == n_steps - 1:
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
        if (i + 1) % cfg.train.checkpoint_every == 0 or i == n_steps - 1:
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
