"""Detector training, the twin of ``scripts/train_model.py`` (the
reference's ``train_GENIE_model.py``): the project's domain with its PINN
where ``Grids/`` has one (else homogeneous travel times), then
``workflow.train`` into ``GNN_TrainedModels/`` (the log
``{region}_output_ver_1.txt`` and the checkpoint ``ckpt.pkl``; ``--restart``
resumes that checkpoint).

    python -m genie_tpu_torch.scripts.train_model <project_root> \\
        [--config cfg.yaml] [--steps N] [--restart] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from genie_tpu_torch.scripts import add_device_argument, project_trv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--restart", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.workflow import domain_from_project, train

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    pj = load_project(args.root, cfg.region.name)
    trv = project_trv(cfg, args.root, pj["projection"], dev)
    ctx, proj, trv = domain_from_project(args.root, cfg, trv=trv, device=dev)
    train(cfg, ctx, trv, Path(args.root) / "GNN_TrainedModels",
          n_steps=args.steps, seed=args.seed, restart=args.restart)


if __name__ == "__main__":
    main()
