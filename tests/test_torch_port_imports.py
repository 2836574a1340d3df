"""The PyTorch port stands alone: no JAX, flax, optax or genie_tpu module,
nor the repo's JAX commands (``scripts/``, ``examples/``), is imported by
any genie_tpu_torch module, nothing needs h5py, obspy or wandb at import
(the card's machine has none of them) nor matplotlib (``viz`` imports it
inside its functions), entry points and commands do not silently run on
the CPU, every command's ``--help`` runs without a GPU, and
options the port does not carry raise (the detector and pipeline options
it now carries are taken)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
for absent in ("h5py", "obspy", "wandb"):
    sys.modules[absent] = None      # importing it now raises ImportError
import genie_tpu_torch
names = ["genie_tpu_torch"]
for m in pkgutil.walk_packages(genie_tpu_torch.__path__, "genie_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
from genie_tpu_torch.params import (load_flax_params, load_into, load_magnitude_model,
                                    load_pinn)
from genie_tpu_torch.models.detector import Detector
tree = load_flax_params("projects/NC_EHZ/run6/params.pkl")
load_into(Detector(), tree)
load_pinn("projects/NC_EHZ/Grids/pinn_nc.pkl", device="cpu")
load_magnitude_model("projects/NC_EHZ/run6/mag_model_nc.pkl", device="cpu")
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "genie_tpu",
                                    "scripts", "examples"))
print(json.dumps({"modules": names, "bad": bad,
                  "matplotlib": "matplotlib" in sys.modules}))
"""


def test_port_imports_no_jax_flax_optax_or_genie_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert not res["matplotlib"]       # genie_tpu_torch.viz imports it inside its functions
    for mod in ("genie_tpu_torch.infer.pipeline", "genie_tpu_torch.ops.fused_round",
                "genie_tpu_torch.models.layers", "genie_tpu_torch.params",
                "genie_tpu_torch.io", "genie_tpu_torch.workflow",
                "genie_tpu_torch.models.travel_time_pinn",
                "genie_tpu_torch.models.magnitude",
                "genie_tpu_torch.calibration.corrections",
                "genie_tpu_torch.calibration.magnitude_scale",
                "genie_tpu_torch.utils", "genie_tpu_torch.models.init",
                "genie_tpu_torch.synth.generator", "genie_tpu_torch.train.trainer",
                "genie_tpu_torch.relocation", "genie_tpu_torch.relocation.graphdd",
                "genie_tpu_torch.native.fmm", "genie_tpu_torch.setup",
                "genie_tpu_torch.setup.project", "genie_tpu_torch.train.optim",
                "genie_tpu_torch.graphs.subgraph", "genie_tpu_torch.ops.interp",
                "genie_tpu_torch.train.bayes_opt", "genie_tpu_torch.viz",
                "genie_tpu_torch.parallel", "genie_tpu_torch.parallel.mesh",
                "genie_tpu_torch.parallel.product_shard",
                "genie_tpu_torch.parallel.sharded_detector",
                "genie_tpu_torch.parallel.launch",
                "genie_tpu_torch.setup.fdsn", *COMMANDS):
        assert mod in res["modules"]


# the port's commands and example twins, with the least arguments each parses
COMMANDS = {
    "genie_tpu_torch.scripts.init_project": ["proj"],
    "genie_tpu_torch.scripts.calculate_travel_times": ["proj", "build"],
    "genie_tpu_torch.scripts.train_model": ["proj"],
    "genie_tpu_torch.scripts.process_continuous_days": ["proj", "picks.npz"],
    "genie_tpu_torch.scripts.calibrate": ["proj", "catalog.hdf5", "ref.npz"],
    "genie_tpu_torch.scripts.relocate": ["proj", "catalog.hdf5"],
    "genie_tpu_torch.scripts.eval_synthetic": [],
    "genie_tpu_torch.scripts.measure_scaling": [],
    "genie_tpu_torch.scripts.scaling_model": [],
    "genie_tpu_torch.examples.quickstart_detection": [],
    "genie_tpu_torch.examples.quickstart_relocation": [],
}


@pytest.mark.parametrize("module", sorted(COMMANDS))
def test_command_help_runs_without_a_gpu(module):
    """``python -m <command> --help`` in a process that sees no GPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:") and "--device" in out.stdout


@pytest.mark.parametrize("module", sorted(COMMANDS))
def test_command_without_device_raises_when_no_cuda(module, monkeypatch, tmp_path):
    """Without ``--device cpu`` a command raises ``resolve_device``'s error
    where there is no GPU, before it reads a file."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(module).main(COMMANDS[module])
    assert list(tmp_path.iterdir()) == []


def test_port_sources_do_not_name_jax():
    """Belt and braces over the runtime check: no import line of the port
    or of chip_smoke.py names a JAX-side package or the repo's JAX
    commands (``scripts``, ``examples``)."""
    files = sorted((ROOT / "genie_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "optax", "genie_tpu",
                                   "scripts", "examples"), (f, s)


def _tiny_ctx(cfg):
    from genie_tpu_torch.train.trainer import build_domain_context

    rng = np.random.default_rng(0)
    sta = rng.uniform(-60e3, 60e3, (6, 3)).astype(np.float32)
    grids = rng.uniform(-80e3, 80e3, (1, 12, 3)).astype(np.float32)
    trv = np.linalg.norm(grids[:, :, None] - sta[None, None], axis=-1)
    trv = np.stack((trv / 5500.0, trv / 3100.0), -1)
    return build_domain_context(cfg, sta, sta, grids, grids, trv, "cpu")


def _tiny_cfg():
    from genie_tpu_torch.config import Config

    cfg = Config()
    cfg.graph.k_sta_edges = 3
    cfg.graph.k_spc_edges = 4
    cfg.graph.k_time_edges = 3
    cfg.graph.k_spatial_attn = 3
    cfg.process.n_query_grid = 0
    return cfg


def test_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector

    cfg = _tiny_cfg()
    ctx = _tiny_ctx(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferencePipeline(Detector(), cfg, ctx, lambda s, x: None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("option", ["use_updated_model_definition", "use_absolute_pos",
                                    "use_subgraph",
                                    "sweep_half", "mag_model", "kmeans_query_grid",
                                    "assoc_mode"])
def test_unported_options_raise(option):
    """An unknown association mode raises. Every other option here is
    ported: magnitudes, the k-means query grid, the updated model
    definition, absolute positions, subgraph mode and the bf16 sweep; their
    cases check that the detector or the pipeline takes them (the options
    are held against the JAX package in tests/test_torch_port_options.py)."""
    from genie_tpu_torch.infer.pipeline import InferencePipeline
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.models.magnitude import MagnitudeModel

    cfg = _tiny_cfg()
    ctx = _tiny_ctx(cfg)
    kw = dict(device="cpu")
    if option == "use_updated_model_definition":
        model = Detector(**{option: True})
        assert model.data_agg.l1_t1_2.in_features == 2 * 30 + 4 + 4
        assert model.assoc_agg.l2_t2_2.in_features == 3 * 30 + 4 + 5
        return
    if option == "use_absolute_pos":
        model = Detector(**{option: True})
        assert model.data_agg.init_trns.in_features == 10 + 4
        assert model.assoc_agg.init_trns.in_features == 21 + 30 + 5
        return
    if option == "use_subgraph":
        cfg.graph.use_subgraph = True
        pipe = InferencePipeline(Detector(), cfg, ctx, lambda s, x: None, **kw)
        assert [tuple(m.shape) for m in pipe._pair_masks] == [(12, 6)]
        return
    if option == "sweep_half":
        pipe = InferencePipeline(Detector(), cfg, ctx, lambda s, x: None,
                                 sweep_half=True, **kw)
        a = pipe.model.data_agg.init_trns.weight
        b = pipe._model_half.data_agg.init_trns.weight
        assert b.dtype == torch.float32 and torch.equal(b, a.bfloat16().float())
        return
    if option == "mag_model":
        kw["mag_model"] = {"model": MagnitudeModel(n_sta=6, n_grid=2),
                           "grid_cart": np.zeros((2, 3), np.float32),
                           "dist_model": None}
        pipe = InferencePipeline(Detector(), cfg, ctx, lambda s, x: None, **kw)
        assert pipe.mag["model"].bias.shape == (2, 6, 2)
        return
    elif option == "kmeans_query_grid":
        cfg.process.n_query_grid = 100
        pipe = InferencePipeline(Detector(), cfg, ctx, lambda s, x: None, **kw)
        assert tuple(pipe.x_query.shape) == (100, 3)
        return
    elif option == "assoc_mode":
        cfg.process.assoc_mode = "spam"
    with pytest.raises(NotImplementedError):
        InferencePipeline(Detector(), cfg, ctx, lambda s, x: None, **kw)


def test_run6_config_in_code_matches_yaml():
    """chip_smoke.py sets the run6 inference settings in code; they must be
    exactly those of projects/NC_EHZ/run6/config.yaml."""
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = yaml.safe_load((ROOT / "projects/NC_EHZ/run6/config.yaml").read_text())
    got = chip_smoke.run6_config().to_dict()
    for sec in ("region", "velocity", "graph", "model", "process", "travel_time"):
        for k, v in want[sec].items():
            g = got[sec][k]
            assert (list(g) if isinstance(g, tuple) else g) == v, (sec, k)


def test_run6_train_config_in_code_matches_yaml():
    """chip_smoke.py's [train] phase sets run6's synth and train blocks in
    code; they must be exactly those of projects/NC_EHZ/run6/config.yaml."""
    import yaml

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = yaml.safe_load((ROOT / "projects/NC_EHZ/run6/config.yaml").read_text())
    got = chip_smoke.run6_train_config().to_dict()
    for sec in ("region", "velocity", "graph", "model", "synth", "train", "process"):
        for k, v in want[sec].items():
            g = got[sec][k]
            assert (list(g) if isinstance(g, tuple) else g) == v, (sec, k)


def test_run6_adam_state_loads_without_optax():
    """The optimizer state of run6's pickle survives the optax-free
    unpickler: count 20000 and the moments under the port's names."""
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.params import AdamState, _load_pickle, load_adam_state

    blob = _load_pickle(ROOT / "projects/NC_EHZ/run6/params.pkl")
    assert isinstance(blob["opt_state"][0], AdamState)
    st = load_adam_state(ROOT / "projects/NC_EHZ/run6/params.pkl")
    assert st["count"] == 20000
    names = {n for n, _ in Detector().named_parameters()}
    assert set(st["mu"]) == names and set(st["nu"]) == names
    assert all(bool((v >= 0).all()) for v in st["nu"].values())
    assert float(st["mu"]["data_agg.l1_t1_2.weight"].abs().max()) > 0


def test_flax_checkpoint_loads_without_optax():
    from genie_tpu_torch.models.detector import Detector
    from genie_tpu_torch.params import flatten_tree, load_flax_params, load_into

    tree = load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl")
    flat = flatten_tree(tree)
    assert sum(v.size for v in flat.values()) == 63226
    model = load_into(Detector(), tree)
    assert sum(p.numel() for p in model.parameters()) == 63226
    np.testing.assert_array_equal(
        model.data_agg.l1_t1_2.weight.detach().numpy(),
        flat["data_agg/l1_t1_2/kernel"].T)
    np.testing.assert_array_equal(
        model.arrivals.chunks.PReLU_3.a.detach().numpy(),
        flat["arrivals/chunks/PReLU_3/a"])
