"""Project initialization, the twin of ``scripts/init_project.py`` (the
reference's ``make_initial_files.py`` + ``assemble_network_data.py``):
stations, region, velocity model and the k-means source grids (Lloyd
iterations on the card), then optional pick and catalog conversion.

    python -m genie_tpu_torch.scripts.init_project <project_root> \\
        --config cfg.yaml [--stations stations.txt] [--picks picks.txt] \\
        [--catalog catalog.txt] [--device cpu]
"""

from __future__ import annotations

import argparse

from genie_tpu_torch.scripts import add_device_argument


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("--config", default=None)
    ap.add_argument("--stations", default=None, help="stations.txt path")
    ap.add_argument("--picks", default=None, help="picks.txt to convert")
    ap.add_argument("--catalog", default=None,
                    help="HypoDD-format catalog.txt to convert")
    ap.add_argument("--grid-steps", type=int, default=800)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.setup.project import (convert_hypodd_catalog,
                                               convert_picks_txt, init_project)

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    dirs, proj, grids = init_project(args.root, cfg, stations_txt=args.stations,
                                     n_steps_grids=args.grid_steps, device=dev)
    print(f"project '{cfg.region.name}' initialized at {dirs['root']}")
    print(f"grids: {grids.shape}")
    if args.picks or args.catalog:
        st = np.load(dirs["root"] / f"{cfg.region.name}_stations.npz",
                     allow_pickle=True)
    if args.picks:
        days = convert_picks_txt(args.picks, dirs, cfg, st["stas"])
        print(f"converted picks for {len(days)} days")
    if args.catalog:
        days = convert_hypodd_catalog(args.catalog, dirs, cfg, st["stas"], proj)
        print(f"converted catalog for {len(days)} days")


if __name__ == "__main__":
    main()
