"""GraphDD relocation, the twin of ``scripts/relocate.py`` (the reference's
``Relocation/`` stack: build_initial_files → build_subsets_of_paired_sources
→ train_double_difference_model) end to end on a produced catalog:
relocation graphs over the catalog's events and picks, the double-difference
GNN trained on the card, the first graph's sources relocated into
``DoubleDifferenceModels/relocated_ver_1.npz`` (``src_pos``, ``src_time``,
``sta_corr``).

    python -m genie_tpu_torch.scripts.relocate <root> <catalog.hdf5> \\
        [--steps N] [--graphs 20] [--graph-size 32] [--sta-budget K] \\
        [--dtcc dt.cc] [--device cpu]

As the JAX command does, it takes homogeneous travel times at the mean
profile velocities (``make_trv`` without the PINN).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from genie_tpu_torch.scripts import add_device_argument

# The integer the JAX command's ``PRNGKey(0)`` draws to seed
# ``make_relocation_graphs``' numpy generator
# (``jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)``): with it both
# commands sample the same graphs.
GRAPH_SEED = 31327077


def catalog_observations(events, pick_t, pick_sta, n_sta: int):
    """Host code: the events' positions and times and their picks as
    ``(n_ev, n_sta, 2)`` absolute arrivals with a mask."""
    S = len(events)
    src_pos = np.array([ev.pos_cart for ev in events], np.float32).reshape(S, 3)
    src_time = np.array([ev.time for ev in events], np.float32)
    obs = np.zeros((S, n_sta, 2), np.float32)
    msk = np.zeros_like(obs)
    for i, ev in enumerate(events):
        for p, ph in zip(ev.picks, ev.pick_phases):
            obs[i, pick_sta[p], ph] = pick_t[p]
            msk[i, pick_sta[p], ph] = 1.0
    return src_pos, src_time, obs, msk


def build_graphs(ctx, src_pos, src_time, obs, msk, n_graphs: int, graph_size: int,
                 sta_budget=None, dtcc=None):
    """``n_graphs`` relocation graphs of ``min(graph_size, n_ev)`` sources
    on the context's device, with the dt.cc observations of ``dtcc``
    (``relocation.graphdd.load_dtcc``) attached when given."""
    from genie_tpu_torch.relocation.graphdd import attach_dtcc, make_relocation_graphs

    graphs = make_relocation_graphs(
        GRAPH_SEED, src_pos, src_time, obs, msk, ctx.sta_cart, n_graphs=n_graphs,
        graph_size=min(graph_size, len(src_pos)), sta_budget=sta_budget,
        device=ctx.sta_cart.device)
    if dtcc is not None:
        graphs = [attach_dtcc(g, dtcc) for g in graphs]
    return graphs


def run_relocate(ctx, trv, graphs, n_steps: int):
    """Train ``GNNLocation()`` from flax-default weights (a generator seeded
    1) for ``n_steps`` over ``graphs`` and relocate the first graph on the
    context's device: returns (src_pos (S, 3), src_time (S,), sta_corr
    (n_sta_g, 2), the last step's loss)."""
    import torch

    from genie_tpu_torch.relocation.graphdd import GNNLocation, relocate, train_graphdd

    dev = ctx.sta_cart.device
    model, loss = train_graphdd(torch.Generator(device=dev).manual_seed(1), GNNLocation(),
                                trv.from_cart, ctx.sta_cart, graphs, n_steps=n_steps,
                                device=dev)
    new_pos, new_t, sta_corr = relocate(model, trv.from_cart, ctx.sta_cart, graphs[0])
    return new_pos, new_t, sta_corr, loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("catalog")
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--graphs", type=int, default=20)
    ap.add_argument("--graph-size", type=int, default=32)
    ap.add_argument("--sta-budget", type=int, default=None,
                    help="cap the per-graph observed-station subset")
    ap.add_argument("--dtcc", default=None,
                    help="HypoDD dt.cc file of cross-correlation "
                         "differential times (adds the 0.8-weight loss)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.io import load_catalog
    from genie_tpu_torch.relocation.graphdd import load_dtcc
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.workflow import domain_from_project, make_trv

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    pj = load_project(args.root, cfg.region.name)
    ctx, proj, trv = domain_from_project(
        args.root, cfg, trv=make_trv(cfg, pj["projection"], device=dev), device=dev)
    events = load_catalog(args.catalog)
    import h5py

    with h5py.File(args.catalog, "r") as f:
        pick_t = np.asarray(f["pick_t"])
        pick_sta = np.asarray(f["pick_sta"])

    obs = catalog_observations(events, pick_t, pick_sta, ctx.sta_cart.shape[0])
    dtcc = load_dtcc(args.dtcc, pj["sta_names"]) if args.dtcc else None
    graphs = build_graphs(ctx, *obs, n_graphs=args.graphs, graph_size=args.graph_size,
                          sta_budget=args.sta_budget, dtcc=dtcc)
    if dtcc is not None:
        n_att = sum(int(g.dt_mask.sum()) for g in graphs)
        print(f"dt.cc: {len(dtcc['src_a'])} observations, "
              f"{n_att} attached across {len(graphs)} graphs")
    new_pos, new_t, sta_corr, loss = run_relocate(ctx, trv, graphs, args.steps)
    print(f"graphdd trained, final loss {loss:.4f}")

    out = Path(args.root) / "DoubleDifferenceModels" / "relocated_ver_1.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, src_pos=new_pos.cpu().numpy(), src_time=new_t.cpu().numpy(),
             sta_corr=sta_corr.cpu().numpy())
    print(f"relocated sources → {out}")


if __name__ == "__main__":
    main()
