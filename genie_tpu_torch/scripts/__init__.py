"""The project workflow's commands, the port's twins of the repo's
``scripts/`` (README, "Workflow (mirrors the reference)"):

    python -m genie_tpu_torch.scripts.init_project <root> --config cfg.yaml \\
        --stations stations.txt [--picks picks.txt] [--catalog catalog.txt]
    python -m genie_tpu_torch.scripts.calculate_travel_times <root> build \\
        [--job i --n-jobs N]
    python -m genie_tpu_torch.scripts.calculate_travel_times <root> train \\
        [--steps 20000]
    python -m genie_tpu_torch.scripts.train_model <root> [--steps N] [--restart]
    python -m genie_tpu_torch.scripts.process_continuous_days <root> <picks.npz>
    python -m genie_tpu_torch.scripts.calibrate <root> <catalog.hdf5> <ref.npz>
    python -m genie_tpu_torch.scripts.relocate <root> <catalog.hdf5>

Each module keeps its JAX twin's name, flags and defaults, and adds
``--device`` (default: the card; ``--device cpu`` runs on the CPU, and
without a card every command raises unless given it). ``main(argv=None)``
reads and writes the project's files; the device work is a function of
arrays or tensors that returns them, which the GPU smoke calls in-process:
``calculate_travel_times.fit_pinn``, ``workflow.process_picks`` for
``process_continuous_days``, ``calibration.corrections.fit_corrections``
for ``calibrate`` (on ``calibrate.correction_observations``),
``relocate.build_graphs`` and ``relocate.run_relocate``.
``init_project`` and ``train_model`` call the library functions that write
the project's files themselves (``setup.project.init_project``,
``workflow.train``), as their JAX twins do.

The stages hand over through the project directory as the JAX commands'
do, with one difference: the detector checkpoint is the pickle
``GNN_TrainedModels/ckpt.pkl`` (``io.save_checkpoint``), not orbax's
``GNN_TrainedModels/ckpt/step_*``. HDF5 catalogs need h5py, imported inside
the functions that read or write them.
"""

from __future__ import annotations

from pathlib import Path

PINN_FILE = Path("Grids") / "travel_time_neural_network_physics_informed_p_s_ver_1.pkl"
CHECKPOINT_FILE = Path("GNN_TrainedModels") / "ckpt.pkl"


def add_device_argument(ap):
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on the CPU)")


def project_trv(cfg, root, proj, device):
    """The travel times of ``train_model`` and ``process_continuous_days``,
    as their JAX twins build them: the project's PINN where the file exists,
    else homogeneous times at the mean profile velocities
    (``workflow.make_trv``)."""
    from genie_tpu_torch.workflow import make_trv

    pinn = Path(root) / PINN_FILE
    return make_trv(cfg, proj, pinn_path=pinn if pinn.exists() else None, device=device)
