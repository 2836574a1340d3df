"""Detection + association quickstart, the twin of
``examples/quickstart_detection.py`` (the reference's
``Examples/tutorial_run_genie.ipynb``), self-contained on synthetic data.

Walk-through:
  1. build a small domain (16 stations, two 120-node source grids,
     homogeneous travel times),
  2. train the Detector on synthetic pick timelines generated on the card,
  3. run the continuous-window inference pipeline on a fresh timeline,
  4. score detections against the planted events with the bipartite matcher.

The default 300 steps leave the model undertrained (expect partial
recall): they show the mechanics.

    python -m genie_tpu_torch.examples.quickstart_detection --steps 300 \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from genie_tpu_torch.scripts import add_device_argument
from genie_tpu_torch.scripts.eval_synthetic import build


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--thresh", type=float, default=0.2)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.calibration.corrections import matched_catalog_stats
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.synth.generator import synthesize_timeline
    from genie_tpu_torch.train.trainer import init_train_state, make_train_step

    dev = resolve_device(args.device)
    # 1. domain
    cfg, ctx, tt = build(16, 120, 4, args.thresh, dev)
    print(f"domain: {ctx.sta_cart.shape[0]} stations, "
          f"{ctx.grids_cart.shape[0]}x{ctx.grids_cart.shape[1]} source grids")

    # 2. train
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Detector(src_chunk=16).to(dev)
    state = init_train_state(model, cfg, gen)
    step_fn = make_train_step(cfg, ctx, tt.from_cart)
    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step_fn(state, gen)
        if i % 100 == 0:
            print(f"  step {i} loss {float(metrics['loss']):.5f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s")

    # 3. synthesize a fresh 30-minute pick timeline and process it
    cfg.synth.T = 1800.0
    lo, sc = ctx.offset_cart, ctx.scale_cart
    with torch.no_grad():
        tl = synthesize_timeline(torch.Generator(device=dev).manual_seed(99), cfg.synth,
                                 ctx.sta_cart, tt.from_cart, sc, lo,
                                 (lo[2], lo[2] + sc[2]), n_sta_real=ctx.sta_cart.shape[0])
    pm = tl.pick_mask.cpu().numpy()
    pick_t = tl.pick_t.cpu().numpy()[pm]
    pick_sta = tl.pick_sta.cpu().numpy()[pm]
    pick_ph = tl.pick_phase.cpu().numpy()[pm].astype(np.float32)
    ev_mask = tl.ev_mask.cpu().numpy()
    print(f"timeline: {pm.sum()} picks, {int(ev_mask.sum())} events")

    pipe = InferencePipeline(state.model, cfg, ctx, tt.from_cart, device=dev)
    events = pipe.process(pick_t, pick_sta, pick_ph, 0.0, cfg.synth.T)
    print(f"pipeline detected {len(events)} events")
    for ev in events[:10]:
        print(f"  t={ev.time:7.1f}s pos=({ev.pos_cart[0]/1e3:+6.1f}, "
              f"{ev.pos_cart[1]/1e3:+6.1f}, {ev.pos_cart[2]/1e3:+6.1f}) km "
              f"score {ev.score:.2f} picks {len(ev.picks)}")

    # 4. score against the planted events
    true_srcs = np.concatenate((tl.ev_pos_cart.cpu().numpy()[ev_mask],
                                tl.ev_time.cpu().numpy()[ev_mask][:, None]), 1)
    det = np.array([[*ev.pos_cart, ev.time] for ev in events]).reshape(-1, 4)
    stats = matched_catalog_stats(det, true_srcs, sig_x=25e3, sig_t=10.0)
    print(f"matched {stats['n_matched']}/{len(true_srcs)} planted events "
          f"(detection rate {stats['detection_rate']:.2f})")
    return events, stats


if __name__ == "__main__":
    main()
