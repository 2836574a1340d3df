"""End-to-end quality evaluation on synthetic data, the twin of
``scripts/eval_synthetic.py``.

Trains the Detector from flax-default weights on a synthetic domain, then
runs the full inference pipeline on a fresh synthetic pick timeline and
scores detections against the planted events with the bipartite matcher
(association F1, epicentre and origin-time residuals), the framework's
equivalent of the reference's BSSA matched-catalog evaluation.

    python -m genie_tpu_torch.scripts.eval_synthetic [--steps 500] \\
        [--n-sta 32] [--json] [--save-params params.pkl] [--device cpu] \\
        [--train-seed 0] [--timeline-seed 1234]

The random streams are ``torch.Generator``s on the device, seeded 0 for
training and 1234 for the evaluation timeline (the JAX script's
``PRNGKey`` seeds; the draws differ). ``--train-seed`` and
``--timeline-seed``, which the JAX script lacks, draw other batches and
another timeline, to read the spread of the scores over seeds.
``--save-params`` writes the JAX script's layout, ``{"params": flax
tree}`` as a pickle of numpy arrays.
"""

from __future__ import annotations

import argparse
import copy
import json
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from genie_tpu_torch.scripts import add_device_argument


def build(n_sta: int, n_src: int, n_batch: int, thresh: float, device):
    """The synthetic evaluation domain of ``scripts/eval_synthetic.py``
    (``build``): its config, ``n_sta`` stations and two grids of ``n_src``
    nodes drawn from ``np.random.default_rng(0)`` around the default region's
    centre, homogeneous travel times. Returns (cfg, ctx on ``device``,
    travel times)."""
    from genie_tpu_torch.config import Config
    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
    from genie_tpu_torch.train.trainer import build_domain_context

    cfg = Config()
    cfg.graph.max_sta = n_sta
    cfg.graph.n_spatial_nodes = n_src
    cfg.graph.n_grids = 2
    cfg.graph.max_picks = 256
    cfg.train.n_batch = n_batch
    cfg.train.n_spc_query = 1000
    cfg.train.n_src_query = 64
    cfg.synth.max_events = 64
    cfg.synth.n_false_max = 1024
    cfg.synth.T = 3600.0
    cfg.synth.max_rate_events = 30.0
    cfg.synth.min_sta_arrival = 4
    cfg.synth.min_pick_arrival = 6
    cfg.synth.dist_range = (15e3, 200e3)
    cfg.process.thresh = thresh
    cfg.process.thresh_assoc = thresh
    cfg.process.min_required_picks = 5
    cfg.process.min_required_sta = 3

    rng = np.random.default_rng(0)
    proj = Projection.from_center(cfg.region.center)
    n_grids = 2
    sta_cart = rng.uniform(-80e3, 80e3, (n_sta, 3)).astype(np.float32)
    sta_cart[:, 2] = rng.uniform(-1e3, 1e3, n_sta)
    sta_lla = np.asarray(proj.to_lla_np(sta_cart), np.float32)
    grids_cart = rng.uniform(-100e3, 100e3, (n_grids, n_src, 3)).astype(np.float32)
    grids_cart[:, :, 2] = rng.uniform(-35e3, 0, (n_grids, n_src))
    grids_lla = np.stack([np.asarray(proj.to_lla_np(g), np.float32) for g in grids_cart])
    tt = HomogeneousTravelTime(proj)
    sta = torch.as_tensor(sta_cart, device=device)
    trv_grids = torch.stack([tt.from_cart(sta, torch.as_tensor(g, device=device))
                             for g in grids_cart])
    ctx = build_domain_context(cfg, sta_lla, sta_cart, grids_lla, grids_cart, trv_grids,
                               device)
    return cfg, ctx, tt


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def detectable_events(tl, cfg):
    """(E,) bool: the timeline's events with at least
    ``cfg.synth.min_pick_arrival`` picks on at least
    ``cfg.synth.min_sta_arrival`` distinct stations (the ground truth of the
    JAX script). ``tl`` is a ``Timeline`` of tensors or arrays."""
    pm = _np(tl.pick_mask)
    ev_mask = _np(tl.ev_mask)
    pe = _np(tl.pick_event)[pm]
    sta = _np(tl.pick_sta)[pm]
    own = pe >= 0
    n_picks = np.bincount(pe[own], minlength=len(ev_mask))
    pairs = np.unique(np.stack((pe[own], sta[own]), axis=1), axis=0)
    n_sta = np.bincount(pairs[:, 0], minlength=len(ev_mask))
    return (ev_mask & (n_picks >= cfg.synth.min_pick_arrival)
            & (n_sta >= cfg.synth.min_sta_arrival))


def score(events, true_srcs) -> dict:
    """Match ``events`` (``CatalogEvent``s) to ``true_srcs`` (n, 4: x, y, z,
    t) with ``matched_catalog_stats`` (σ_x 25 km, σ_t 10 s): the counts,
    precision, recall and F1 of the JAX script's JSON, rounded as it rounds
    them. ``median_epi_err_m`` and ``median_t_err_s`` keep the JAX script's
    names but hold the *mean* matched residuals (``residual_xy_mean``,
    ``residual_t_mean``), as there; None without a match."""
    from genie_tpu_torch.calibration.corrections import matched_catalog_stats

    det_srcs = np.array([[*ev.pos_cart, ev.time] for ev in events]).reshape(-1, 4)
    stats = matched_catalog_stats(det_srcs, np.asarray(true_srcs).reshape(-1, 4),
                                  sig_x=25e3, sig_t=10.0)
    prec = stats["n_matched"] / max(stats["n_detected"], 1)
    rec = stats["detection_rate"]
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"n_true": len(true_srcs), "n_detected": stats["n_detected"],
            "n_matched": stats["n_matched"], "precision": round(prec, 3),
            "recall": round(rec, 3), "f1": round(f1, 3),
            "median_epi_err_m": stats.get("residual_xy_mean"),
            "median_t_err_s": stats.get("residual_t_mean")}


def eval_timeline(cfg, ctx, tt, device, timeline_seed: int = 1234,
                  eval_T: float = 1800.0):
    """The evaluation timeline of :func:`evaluate`: ``eval_T`` seconds drawn
    on ``device`` from a generator seeded ``timeline_seed``. Returns the
    picks (times, stations, phases as float32) and the (n, 4) detectable
    true sources (x, y, z, t)."""
    from genie_tpu_torch.synth.generator import synthesize_timeline

    syn = copy.deepcopy(cfg.synth)
    syn.T = eval_T
    lo, sc = ctx.offset_cart, ctx.scale_cart
    with torch.no_grad():
        tl = synthesize_timeline(
            torch.Generator(device=torch.device(device)).manual_seed(timeline_seed), syn,
            ctx.sta_cart, tt.from_cart, sc, lo, (lo[2], lo[2] + sc[2]),
            n_sta_real=ctx.sta_cart.shape[0])
    pm = _np(tl.pick_mask)
    picks = (_np(tl.pick_t)[pm], _np(tl.pick_sta)[pm],
             _np(tl.pick_phase)[pm].astype(np.float32))
    det = detectable_events(tl, cfg)
    true_srcs = np.concatenate((_np(tl.ev_pos_cart)[det], _np(tl.ev_time)[det][:, None]),
                               axis=1)
    return picks, true_srcs


def evaluate(cfg, ctx, tt, steps: int, device, train_seed: int = 0,
             timeline_seed: int = 1234, budget_s: float | None = None,
             eval_T: float = 1800.0):
    """Train ``Detector(src_chunk=16)`` from ``init_train_state`` for
    ``steps`` steps (or until ``budget_s`` seconds of training have passed),
    synthesize an ``eval_T``-second timeline and run
    ``InferencePipeline.process`` over it, then score the catalog.

    Returns ``(out, info)``: ``out`` is the JAX script's JSON dict (``steps``
    is the number of steps taken); ``info`` holds every step's loss
    (``losses``), the fused-round launches of training and of processing
    (``launches_train``, ``launches_process``, each count set to 0 just
    before its path), the trained ``model``, the ``events``, the timeline's
    ``picks`` (times, stations, phases) and its detectable ``true_srcs``."""
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.ops.fused_round import fused_round
    from genie_tpu_torch.train.trainer import init_train_state, make_train_step

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(train_seed)
    state = init_train_state(Detector(src_chunk=16).to(dev), cfg, gen)
    step_fn = make_train_step(cfg, ctx, tt.from_cart)

    losses = []
    fused_round.launches = 0
    t0 = time.time()
    for i in range(steps):
        state, metrics = step_fn(state, gen)
        losses.append(float(metrics["loss"]))
        over = budget_s is not None and time.time() - t0 >= budget_s
        if i % 50 == 0 or i == steps - 1 or over:
            print(f"step {i} loss {losses[-1]:.5f} "
                  f"trgts {_np(metrics['trgts']).round(1)} "
                  f"preds {_np(metrics['preds']).round(1)} "
                  f"({(time.time() - t0) / max(i, 1):.2f}s/step)", flush=True)
        if over:
            break
    train_time = time.time() - t0
    launches_train = fused_round.launches

    (pick_t, pick_sta, pick_ph), true_srcs = eval_timeline(cfg, ctx, tt, dev,
                                                           timeline_seed, eval_T)

    t1 = time.time()
    pipe = InferencePipeline(state.model, cfg, ctx, tt.from_cart, device=dev)
    fused_round.launches = 0
    events = pipe.process(pick_t, pick_sta, pick_ph, 0.0, eval_T)
    launches_process = fused_round.launches
    infer_time = time.time() - t1

    n = len(losses)
    out = {"steps": n, "train_s_per_step": train_time / max(n, 1),
           "infer_time_s": infer_time, **score(events, true_srcs)}
    info = {"losses": losses, "launches_train": launches_train,
            "launches_process": launches_process, "model": state.model,
            "events": events, "picks": (pick_t, pick_sta, pick_ph),
            "true_srcs": true_srcs}
    return out, info


def save_params(model, path):
    """Write ``model``'s weights as the JAX script's ``--save-params`` does:
    ``{"params": flax tree}`` pickled as numpy arrays."""
    from genie_tpu_torch.params import to_flax

    Path(path).write_bytes(pickle.dumps({"params": to_flax(model)}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--n-sta", type=int, default=32)
    ap.add_argument("--n-src", type=int, default=200)
    ap.add_argument("--n-batch", type=int, default=8)
    ap.add_argument("--thresh", type=float, default=0.3)
    ap.add_argument("--eval-T", type=float, default=1800.0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--save-params", default=None)
    ap.add_argument("--train-seed", type=int, default=0)
    ap.add_argument("--timeline-seed", type=int, default=1234)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg, ctx, tt = build(args.n_sta, args.n_src, args.n_batch, args.thresh, dev)
    out, info = evaluate(cfg, ctx, tt, args.steps, dev, train_seed=args.train_seed,
                         timeline_seed=args.timeline_seed, eval_T=args.eval_T)
    if args.save_params:
        save_params(info["model"], args.save_params)
    print(json.dumps(out) if args.json else out, flush=True)
    return out, info


if __name__ == "__main__":
    main()
