"""Continuous-day inference, the twin of
``scripts/process_continuous_days.py`` (the reference's
``process_continuous_days.py``): one process per day file, job-arrayable.
The project's domain with its PINN where ``Grids/`` has one (else
homogeneous travel times), the detector of
``GNN_TrainedModels/ckpt.pkl``, then ``workflow.process_day``: the pick
file through the pipeline on the card into an HDF5 catalog (h5py).
``--trace-spans`` also writes the pipeline's spans and counts
(``genie_tpu_torch.tracing``) as Chrome-trace JSON beside the catalog.

    python -m genie_tpu_torch.scripts.process_continuous_days <root> \\
        <pick_file.npz> [--out f.hdf5] [--t-start 0] [--t-end 86400] \\
        [--trace-spans] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from genie_tpu_torch.scripts import CHECKPOINT_FILE, add_device_argument, project_trv


def load_inputs(root, cfg, device):
    """The project's domain, travel times and detector: ``(ctx, trv,
    model)`` on ``device``. The detector takes the four ``cfg.model``
    options the JAX command passes and the weights of the checkpoint."""
    from genie_tpu_torch.io import load_checkpoint
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.setup.project import load_project
    from genie_tpu_torch.workflow import domain_from_project

    pj = load_project(root, cfg.region.name)
    trv = project_trv(cfg, root, pj["projection"], device)
    ctx, proj, trv = domain_from_project(root, cfg, trv=trv, device=device)
    model = Detector(scale_rel=cfg.model.scale_rel,
                     kernel_sig_t=cfg.model.kernel_sig_t,
                     use_phase_types=cfg.model.use_phase_types,
                     use_absolute_pos=cfg.model.use_absolute_pos)
    load_checkpoint(Path(root) / CHECKPOINT_FILE, model)
    return ctx, trv, model.to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("pick_file")
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--t-start", type=float, default=0.0)
    ap.add_argument("--t-end", type=float, default=86400.0)
    ap.add_argument("--trace-spans", action="store_true",
                    help="also write the pipeline's spans and counts as Chrome-trace "
                         "JSON on the unix clock, <catalog stem>_spans.json beside the "
                         "catalog (opens beside a torch.profiler trace of the run)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from genie_tpu_torch import tracing
    from genie_tpu_torch.config import load_config
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.workflow import process_day

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    ctx, trv, model = load_inputs(args.root, cfg, dev)
    out = args.out or (Path(args.root) / "Catalog" /
                       (Path(args.pick_file).stem + "_catalog.hdf5"))
    if args.trace_spans:
        tracing.reset()
        tracing.enable()
    events = process_day(cfg, ctx, trv, model, args.pick_file, out,
                         args.t_start, args.t_end, device=dev)
    print(f"{len(events)} events → {out}")
    if args.trace_spans:
        spans = Path(out).with_name(Path(out).stem + "_spans.json")
        n = tracing.write_chrome_trace(spans)
        tracing.record_with_profiler()
        print(f"{n} spans → {spans}")


if __name__ == "__main__":
    main()
