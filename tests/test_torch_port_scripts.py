"""The port's commands (``genie_tpu_torch.scripts``) against the repo's JAX
commands (``scripts/``) on the same tiny projects, on the CPU. The JAX
scripts are not a package: each is loaded from its file and its ``main()``
runs under a patched ``sys.argv``; the port's run with ``--device cpu``.

* ``init_project``: project files, converted picks and the HDF5 catalog
  equal; grids by shape and bounds (the k-means draws differ);
* ``calculate_travel_times build``: the FMM tables equal;
* ``calculate_travel_times train``: a PINN the JAX command wrote loads in
  the port (without importing JAX) and predicts its times within 1e-5 s
  plus 1e-6 of the time (f32: 1e-5 s is 3 ulps of a 36 s time), and the
  JAX ``make_trv`` reads the port's PINN to the same tolerance;
* ``train_model``: the log lines have the JAX command's format and
  ``--restart`` resumes;
* ``process_continuous_days``: run6's weights on a 16-station project, the
  catalogs equal within 1 km and 0.2 s (the DE locator draws differ) with
  equal pick lists;
* ``calibrate``: the printed statistics and fit loss equal, the
  corrections within 1 % of the largest (mean |Δ| under 1e-3 s);

``relocate`` and the two example twins are in
tests/test_torch_port_scripts_relocate.py, the JAX ``train``'s log and
wandb calls in tests/test_torch_port_fdsn.py (each file's JAX compiles
take most of its time).
"""

import contextlib
import importlib
import importlib.util
import io
import re
import shutil
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genie_tpu import io as jio
from genie_tpu.geometry import Projection as JaxProjection
from genie_tpu.workflow import make_trv as jax_make_trv
from genie_tpu_torch import io as tio
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.workflow import make_trv

from tests.test_trainer import tiny_config, tiny_domain
from tests.test_workflow import small_cfg

ROOT = Path(__file__).resolve().parent.parent
RUN6 = ROOT / "projects/NC_EHZ/run6/params.pkl"
PINN = "Grids/travel_time_neural_network_physics_informed_p_s_ver_1.pkl"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_jax(name, *argv):
    """``scripts/<name>.py``'s ``main()`` on ``argv``; returns its stdout."""
    spec = importlib.util.spec_from_file_location(f"_jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old, sys.argv = sys.argv, [name, *map(str, argv)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue()


def run_port(name, *argv):
    """``genie_tpu_torch.scripts.<name>.main`` on ``argv`` and ``--device
    cpu``; returns its stdout."""
    mod = importlib.import_module(f"genie_tpu_torch.scripts.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main([*map(str, argv), "--device", "cpu"])
    return out.getvalue()


def write_config(path, cfg):
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return path


def _assert_npz_equal(a, b):
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# -- a project from its files: init, FMM build, PINN, training ------------------

@pytest.fixture(scope="module")
def setup_dirs(tmp_path_factory):
    """A small_cfg project (12 stations, 2 × 60 nodes, FMM at 5 km) set up
    by both commands from one stations.txt, picks.txt and catalog.txt."""
    tmp = tmp_path_factory.mktemp("scripts_setup")
    cfg = small_cfg()
    cfg.travel_time.dx = 5000.0
    cfg_path = write_config(tmp / "cfg.yaml", cfg)
    rng = np.random.default_rng(0)
    n = cfg.graph.max_sta
    sta = np.stack((rng.uniform(*cfg.region.lat_range, n),
                    rng.uniform(*cfg.region.lon_range, n),
                    rng.uniform(0, 1200, n)), axis=1)
    names = [f"ST{i:02d}" for i in range(n)]
    (tmp / "stations.txt").write_text("".join(
        f"{nm} {a:.5f} {b:.5f} {c:.1f}\n" for nm, (a, b, c) in zip(names, sta)))
    picks = [(f"2020-1-{2 + (i % 2)}", rng.uniform(0, 86400), names[i % n],
              "P" if i % 3 else "S", rng.uniform(1, 100)) for i in range(40)]
    (tmp / "picks.txt").write_text("".join(
        f"{d} {t:.3f} {s} {p} {a:.3f}\n" for d, t, s, p, a in picks))
    (tmp / "catalog.txt").write_text("\n".join([
        "# 2020 1 2 3 4 5.5 40.1 -124.2 7.5 2.1 0.4 0.8 0.1 1",
        f"{names[0]} 3.2 0.9 P", f"{names[1]} 5.9 0.8 S",
        "# 2020 1 3 0 0 1.0 40.0 -124.1 10.0 3.0 1.0 1.0 0.1 2",
        f"{names[2]} 4.0 0.95 P"]) + "\n")
    args = ("--config", cfg_path, "--stations", tmp / "stations.txt", "--picks",
            tmp / "picks.txt", "--catalog", tmp / "catalog.txt", "--grid-steps", 5)
    outs = {}
    for pkg, run in (("jax", run_jax), ("port", run_port)):
        outs[pkg] = run("init_project", tmp / pkg, *args)
        run("calculate_travel_times", tmp / pkg, "build", "--config", cfg_path,
            "--job", 1, "--n-jobs", 5)
    return dict(tmp=tmp, cfg=cfg, cfg_path=cfg_path, outs=outs, picks=picks)


def test_init_project_matches_jax(setup_dirs):
    tmp, cfg = setup_dirs["tmp"], setup_dirs["cfg"]
    j, t = tmp / "jax", tmp / "port"
    outs = setup_dirs["outs"]
    assert outs["port"].replace(str(t), str(j)) == outs["jax"]
    for f in ("TestProj_stations.npz", "TestProj_region.npz", "1d_velocity_model.npz"):
        _assert_npz_equal(t / f, j / f)
    for day in ("TestProj_2020_1_2_ver_1.npz", "TestProj_2020_1_3_ver_1.npz"):
        _assert_npz_equal(t / "Picks/2020" / day, j / "Picks/2020" / day)
    n_picks = sum(len(tio.load_picks(t / "Picks/2020" / d)[0])
                  for d in ("TestProj_2020_1_2_ver_1.npz", "TestProj_2020_1_3_ver_1.npz"))
    assert n_picks == len(setup_dirs["picks"])
    cats = sorted(p.relative_to(j) for p in j.rglob("*.hdf5"))
    assert cats == sorted(p.relative_to(t) for p in t.rglob("*.hdf5")) and len(cats) == 2
    for c in cats:
        assert len(tio.load_catalog(t / c)) > 0
        with h5py.File(j / c, "r") as fj, h5py.File(t / c, "r") as ft:
            names = []
            fj.visit(names.append)
            got = []
            ft.visit(got.append)
            assert sorted(got) == sorted(names)
            for k in names:
                if isinstance(fj[k], h5py.Dataset):
                    np.testing.assert_array_equal(ft[k][()], fj[k][()], err_msg=k)
            assert sorted(ft.attrs) == sorted(fj.attrs)
            for k in fj.attrs:
                np.testing.assert_array_equal(ft.attrs[k], fj.attrs[k], err_msg=k)
    name = "Grids/TestProj_seismic_network_templates_ver_1.npz"
    gj, gt = np.load(j / name)["x_grids"], np.load(t / name)["x_grids"]
    assert gt.shape == gj.shape == (2, 60, 3) and gt.dtype == gj.dtype
    (la0, la1), (lo0, lo1) = cfg.region.lat_range_extend, cfg.region.lon_range_extend
    assert la0 <= gt[..., 0].min() and gt[..., 0].max() <= la1
    assert lo0 <= gt[..., 1].min() and gt[..., 1].max() <= lo1
    assert cfg.region.depth_range[0] <= gt[..., 2].min()
    assert gt[..., 2].max() <= cfg.region.depth_range[1]


def test_fmm_build_matches_jax(setup_dirs):
    """``build --job 1 --n-jobs 5`` builds stations 1, 6 and 11 in both."""
    tmp = setup_dirs["tmp"]
    files = sorted(p.name for p in (tmp / "jax/TravelTimeData").glob("*.npz"))
    assert files == sorted(p.name for p in (tmp / "port/TravelTimeData").glob("*.npz"))
    assert {int(f.split("_")[-1][:-4]) for f in files} == {1, 6, 11}
    for f in files:
        _assert_npz_equal(tmp / "port/TravelTimeData" / f, tmp / "jax/TravelTimeData" / f)


@pytest.fixture(scope="module")
def pinns(setup_dirs):
    """Each package's ``train`` on the JAX tables (a few steps)."""
    tmp, cfg_path = setup_dirs["tmp"], setup_dirs["cfg_path"]
    shutil.copytree(tmp / "jax/TravelTimeData", tmp / "port/TravelTimeData",
                    dirs_exist_ok=True)
    out_j = run_jax("calculate_travel_times", tmp / "jax", "train", "--config", cfg_path,
                    "--steps", 3, "--batch", 64)
    out_t = run_port("calculate_travel_times", tmp / "port", "train", "--config",
                     cfg_path, "--steps", 60, "--batch", 64)
    return out_j, out_t


def _pinn_inputs():
    rng = np.random.default_rng(1)
    sta = rng.uniform(-80e3, 80e3, (7, 3)).astype(np.float32)
    src = rng.uniform(-80e3, 80e3, (5, 3)).astype(np.float32)
    src[:, 2] = rng.uniform(-30e3, 0, 5)
    return sta, src


def _both_pinn_times(cfg, path):
    sta, src = _pinn_inputs()
    jtrv = jax_make_trv(cfg, JaxProjection.from_center(cfg.region.center), pinn_path=path)
    ttrv = make_trv(Config.from_dict(cfg.to_dict()),
                    Projection.from_center(cfg.region.center), pinn_path=path,
                    device="cpu")
    want = np.asarray(jtrv.from_cart(jnp.asarray(sta), jnp.asarray(src)))
    got = ttrv.from_cart(torch.as_tensor(sta), torch.as_tensor(src)).numpy()
    return got, want


def test_port_reads_the_pinn_the_jax_command_wrote(setup_dirs, pinns):
    """The JAX pickle holds jax.Arrays: the port's unpickler maps them to
    numpy, in a process where importing JAX fails, and the port's PINN
    predicts the JAX PINN's times (f32 rounding: 1e-5 s + 1e-6 relative)."""
    import subprocess

    tmp, cfg = setup_dirs["tmp"], setup_dirs["cfg"]
    assert "saved PINN" in pinns[0]
    path = tmp / "jax" / PINN
    raw = path.read_bytes()
    assert b"jax._src.array" in raw
    code = ("import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
            "from genie_tpu_torch.params import load_pinn\n"
            f"load_pinn({str(path)!r}, device='cpu'); print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    got, want = _both_pinn_times(cfg, path)
    assert got.shape == want.shape == (5, 7, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_jax_reads_the_pinn_the_port_command_wrote(setup_dirs, pinns):
    tmp, cfg = setup_dirs["tmp"], setup_dirs["cfg"]
    m = re.search(r"pinn loss ([\d.]+) \(first 50 steps\) -> ([\d.]+)", pinns[1])
    assert m and float(m.group(2)) < float(m.group(1))    # 60 steps: the loss falls
    got, want = _both_pinn_times(cfg, tmp / "port" / PINN)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# the line of workflow.train's log, in both packages
LOG_LINE = re.compile(
    r"^step (\d+) loss [\d.]+ grid [\d.]+ query [\d.]+ p [\d.]+ s [\d.]+ "
    r"trgts \[[^\]]*\] preds \[[^\]]*\] \(\d+\.\d\ds/step\)$")


def test_train_model_logs_in_the_jax_format_and_restarts(setup_dirs):
    """The port's command trains 1 step on its project (with its PINN): the
    log line has the JAX ``workflow.train``'s format (held line against line
    in tests/test_torch_port_fdsn.py); ``--restart`` then resumes the
    checkpoint at step 1, logs step 1 alone and carries the Adam count."""
    from genie_tpu_torch.params import _load_pickle

    tmp, cfg_path = setup_dirs["tmp"], setup_dirs["cfg_path"]
    out = run_port("train_model", tmp / "port", "--config", cfg_path, "--steps", 1)
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    log = (tmp / "port/GNN_TrainedModels/TestProj_output_ver_1.txt").read_text()
    assert log.splitlines() == lines
    assert [LOG_LINE.match(ln).group(1) for ln in lines] == ["0"]
    ckpt = tmp / "port/GNN_TrainedModels/ckpt.pkl"
    assert int(_load_pickle(ckpt)["step"]) == 1
    out = run_port("train_model", tmp / "port", "--config", cfg_path, "--steps", 2,
                   "--restart")
    assert [LOG_LINE.match(ln).group(1) for ln in out.splitlines()
            if ln.startswith("step ")] == ["1"]
    blob = _load_pickle(ckpt)
    assert int(blob["step"]) == 2 and int(blob["opt_state"]["count"]) == 2


# -- serving and calibration on a run6-weight project ------------------

def process_cfg():
    cfg = tiny_config()
    cfg.region.name = "Tiny"
    cfg.process.n_rand_query = 1
    cfg.process.refine_chunk = 1
    cfg.process.n_query_grid = 0      # detection queries = grid 0 in both
    cfg.process.thresh = 0.05         # run6 weights on 16 synthetic stations
    cfg.process.thresh_assoc = 0.1
    cfg.process.min_required_picks = 5
    cfg.process.min_required_sta = 3
    return cfg


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A project of tests/test_trainer.py's tiny domain (16 stations, its
    two 50-node grids) with run6's weights as both packages' checkpoints
    (the port's ``ckpt.pkl``, JAX's orbax ``ckpt/``), two planted events on
    homogeneous times, and each package's ``process_continuous_days``."""
    import optax

    from genie_tpu.setup.project import init_project as jax_init_project
    from genie_tpu.train.trainer import TrainState
    from genie_tpu.workflow import domain_from_project as jax_domain_from_project
    from genie_tpu_torch.params import load_flax_params

    tmp = tmp_path_factory.mktemp("scripts_served")
    root = tmp / "proj"
    cfg = process_cfg()
    cfg_path = write_config(tmp / "cfg.yaml", cfg)
    base, _ = tiny_domain(cfg)
    jax_init_project(root, cfg, sta_lla=np.asarray(base.sta_lla), n_steps_grids=1)
    np.savez(root / "Grids/Tiny_seismic_network_templates_ver_1.npz",
             x_grids=np.asarray(base.grids_lla))
    ctx, proj, trv = jax_domain_from_project(root, cfg)

    shutil.copy(RUN6, (root / "GNN_TrainedModels").mkdir(exist_ok=True) or
                root / "GNN_TrainedModels/ckpt.pkl")
    params = {"params": jax.tree.map(jnp.asarray, load_flax_params(RUN6))}
    state = TrainState(params, optax.adam(cfg.train.lr).init(params), jnp.int32(20000))
    jio.save_checkpoint(root / "GNN_TrainedModels/ckpt", state, cfg=cfg)

    rng = np.random.default_rng(0)
    n_sta = ctx.sta_cart.shape[0]
    tt = np.asarray(ctx.trv_grids[0])
    planted = ((3, 40.0), (17, 120.0))
    t, s, p = [], [], []
    for node, t_ev in planted:
        for ph, sig in ((0, 0.1), (1, 0.15)):
            t.append(t_ev + tt[node, :, ph] + rng.normal(0, sig, n_sta))
            s.append(np.arange(n_sta))
            p.append(np.full(n_sta, ph))
    t.append(rng.uniform(0, 180, 30))
    s.append(rng.integers(0, n_sta, 30))
    p.append(rng.integers(0, 2, 30))
    t, s, p = map(np.concatenate, (t, s, p))
    o = np.argsort(t)
    pick_file = root / "Picks/2020/Tiny_2020_1_2_ver_1.npz"
    jio.save_picks(pick_file, t[o], s[o], p[o].astype(np.float64), np.ones(len(o)))
    args = (pick_file, "--config", cfg_path, "--t-end", 180.0)
    out_j = run_jax("process_continuous_days", root, *args, "--out", tmp / "jax.hdf5")
    out_t = run_port("process_continuous_days", root, *args)
    ref = np.array([[*np.asarray(ctx.grids_cart[0][node]), t_ev] for node, t_ev in planted]
                   + [[0.0, 0.0, -5e3, 150.0]])      # one reference event missed
    np.savez(tmp / "ref.npz", srcs_ref=ref, mags_ref=np.array([2.5, 3.5, 1.5]))
    return dict(tmp=tmp, root=root, cfg=cfg, cfg_path=cfg_path, out_j=out_j, out_t=out_t,
                planted=planted, ctx=ctx)


def test_process_continuous_days_matches_jax(served):
    root, tmp = served["root"], served["tmp"]
    port_out = root / "Catalog/Tiny_2020_1_2_ver_1_catalog.hdf5"
    assert f"→ {port_out}" in served["out_t"]
    je = sorted(jio.load_catalog(tmp / "jax.hdf5"), key=lambda e: e.time)
    te = sorted(tio.load_catalog(port_out), key=lambda e: e.time)
    assert len(te) == len(je) >= len(served["planted"])
    for a, b in zip(je, te):
        assert set(b.picks.tolist()) == set(a.picks.tolist())
        np.testing.assert_array_equal(np.sort(b.picks), np.sort(a.picks))
        assert np.linalg.norm(b.pos_cart - a.pos_cart) < 1e3      # 1 km
        assert abs(b.time - a.time) < 0.2                        # 0.2 s
    for node, t_ev in served["planted"]:
        assert min(abs(e.time - t_ev) for e in te) < 1.0


def test_calibrate_prints_the_jax_stats_and_fits_its_corrections(served):
    """Both commands on the JAX catalog: equal statistics lines; the
    corrections close to JAX's on the same grid."""
    tmp, root, cfg_path = served["tmp"], served["root"], served["cfg_path"]
    args = (root, tmp / "jax.hdf5", tmp / "ref.npz", "--config", cfg_path,
            "--fit-corrections")
    out_j = run_jax("calibrate", *args)
    fj = np.load(root / "Grids/Tiny_calibrated_travel_time_corrections_ver_1.npz")
    fj = {k: fj[k] for k in fj.files}
    out_t = run_port("calibrate", *args)
    ft = np.load(root / "Grids/Tiny_calibrated_travel_time_corrections_ver_1.npz")

    assert out_t == out_j          # the statistics and the printed fit loss
    assert "n_matched: 2" in out_t and "detection_rate: 0.6666666666666666" in out_t
    assert sorted(ft.files) == sorted(fj) == ["coefs", "grid"]
    np.testing.assert_array_equal(ft["grid"], fj["grid"])
    assert ft["coefs"].shape == fj["coefs"].shape == (50, 16, 2)
    # 1000 Adam steps on two events: the f32 differences of the base times
    # grow in the directions the data do not pin down
    scale = float(np.abs(fj["coefs"]).max())
    assert scale > 0.1
    np.testing.assert_allclose(ft["coefs"], fj["coefs"], rtol=0, atol=1e-2 * scale)
    assert float(np.abs(ft["coefs"] - fj["coefs"]).mean()) < 1e-3
