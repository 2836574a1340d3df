"""GraphDD relocation quickstart, the twin of
``examples/quickstart_relocation.py`` (the relocation half of the
reference's ``Examples/tutorial_run_genie_relocation.ipynb``), on a
synthetic earthquake cluster.

Walk-through:
  1. plant a tight cluster of events, synthesize exact arrival times, and
     perturb the initial locations (4 km position noise),
  2. build relocation graphs (node-typed source kNN + observed stations),
  3. train the double-difference GNN through the differentiable travel-time
     model,
  4. relocate and report the median location-error improvement, which must
     fall under 0.8 of the initial.

    python -m genie_tpu_torch.examples.quickstart_relocation [--steps 1200] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from genie_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1200)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
    from genie_tpu_torch.relocation.graphdd import (GNNLocation, make_relocation_graphs,
                                                    relocate, train_graphdd)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    proj = Projection.from_center((40.0, -124.0))
    tt = HomogeneousTravelTime(proj)

    # 1. synthetic cluster: 24 events, 14 stations, exact picks, noisy inits
    n_ev, n_sta = 24, 14
    sta = rng.uniform(-60e3, 60e3, (n_sta, 3)).astype(np.float32)
    sta[:, 2] = 0.0
    true_pos = (np.array([5e3, -8e3, -10e3]) +
                rng.normal(0, 2e3, (n_ev, 3))).astype(np.float32)
    true_t = rng.uniform(0, 1000, n_ev).astype(np.float32)
    trv = tt.from_cart(torch.as_tensor(sta), torch.as_tensor(true_pos)).numpy()
    obs = true_t[:, None, None] + trv                       # (ev, sta, phase)
    mask = (rng.random((n_ev, n_sta, 2)) < 0.85).astype(np.float32)
    init_pos = (true_pos + rng.normal(0, 4e3, (n_ev, 3))).astype(np.float32)

    # 2. relocation graphs (the seed the JAX example's PRNGKey(0) draws)
    graphs = make_relocation_graphs(31327077, init_pos, true_t, obs, mask, sta,
                                    n_graphs=3, graph_size=24, k_src=6, k_sta=5,
                                    max_pair_dist=20e3, device=dev)

    # 3. train the DD model
    model, loss = train_graphdd(torch.Generator(device=dev).manual_seed(1),
                                GNNLocation(n_rounds=3), tt.from_cart, sta, graphs,
                                n_steps=args.steps, lr=3e-3, device=dev)
    print(f"trained {args.steps} DD steps, final loss {loss:.4f}")

    # 4. relocate and score
    g = graphs[0]
    new_pos, new_t, sta_corr = relocate(model, tt.from_cart, sta, g)
    src_pos = g.src_pos.cpu().numpy()
    new_pos = new_pos.cpu().numpy()
    rows = np.array([np.argmin(np.linalg.norm(init_pos - p, axis=1)) for p in src_pos])
    err_before = np.linalg.norm(src_pos - true_pos[rows], axis=1)
    err_after = np.linalg.norm(new_pos - true_pos[rows], axis=1)
    print(f"median location error: {np.median(err_before)/1e3:.1f} km -> "
          f"{np.median(err_after)/1e3:.1f} km "
          f"(station corrections max |c| {sta_corr.abs().max():.2f} s)")
    if not np.median(err_after) < 0.8 * np.median(err_before):
        raise SystemExit("relocation did not cut the median error under 0.8x")
    return err_before, err_after


if __name__ == "__main__":
    main()
