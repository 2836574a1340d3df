"""The port's FMM travel-time build against the JAX package: the solver
(the same C++ source, built by each package's own loader), the velocity
volumes, the FMM box and the per-station tables, all exactly equal; and the
port's loader builds only under ``genie_tpu_torch/_build``."""

import numpy as np
import pytest

from genie_tpu import workflow as jwf
from genie_tpu.config import Config as JConfig
from genie_tpu.geometry import Projection as JProjection
from genie_tpu.native import fmm as jfmm
from genie_tpu_torch import workflow as twf
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.native import fmm as tfmm

ROOT = tfmm._REPO


def _grid(case):
    """The three grids of tests/test_fmm.py: (vel, h, seeds, origin)."""
    if case == "homogeneous":
        n, h = 41, 500.0
        return (np.full((n, n, n), 5000.0, np.float32), h,
                np.array([[n // 2 * h] * 3]), None)
    if case == "two_layer":
        v = np.full((81, 5, 41), 2000.0, np.float32)
        v[:, :, :20] = 6000.0
        return v, 250.0, np.array([[0.0, 2 * 250.0, 30 * 250.0]]), None
    rng = np.random.default_rng(3)   # a rough 3-D medium, two sources
    v = rng.uniform(3000.0, 7000.0, (23, 19, 17)).astype(np.float32)
    return v, 700.0, rng.uniform(0, 12e3, (2, 3)), np.array([-500.0, 100.0, -2e3])


@pytest.mark.parametrize("case", ["homogeneous", "two_layer", "random_two_sources"])
def test_fast_march_equals_jax(case):
    vel, h, seeds, origin = _grid(case)
    want = jfmm.fast_march(vel, h, seeds, origin=origin)
    got = tfmm.fast_march(vel, h, seeds, origin=origin)
    assert got.dtype == np.float32 and got.shape == vel.shape
    np.testing.assert_array_equal(got, want)


def test_travel_time_volume_equals_jax():
    args = (np.array([-10000.0, 0.0]), np.array([6000.0, 4000.0]), (21, 21, 21), 500.0,
            np.array([5000.0, 5000.0, -5000.0]))
    origin = np.array([0.0, 0.0, -10000.0])
    want = jfmm.travel_time_volume(*args, origin=origin)
    got = tfmm.travel_time_volume(*args, origin=origin)
    np.testing.assert_array_equal(got, want)
    assert got[10, 10, 10] < 1e-3


def test_library_builds_only_under_the_port_build_dir(tmp_path, monkeypatch):
    """The port never writes the tracked ``native/libfmm.so`` (the JAX
    loader's file): a fresh build lands in its own build directory, named
    by the hash of the source and flags, and leaves that file as it was."""
    jfmm._load()     # the JAX loader may refresh its own library first
    tracked = ROOT / "native" / "libfmm.so"
    before = (tracked.read_bytes(), tracked.stat().st_mtime_ns)
    assert tfmm.library_path().parent == ROOT / "genie_tpu_torch" / "_build"
    assert tfmm.library_path().name.startswith("libfmm-")

    monkeypatch.setattr(tfmm, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tfmm, "_lib", None)
    vel, h, seeds, origin = _grid("homogeneous")
    got = tfmm.fast_march(vel, h, seeds, origin=origin)
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert built == [tfmm.library_path().name]          # no temporary left behind
    np.testing.assert_array_equal(got, jfmm.fast_march(vel, h, seeds, origin=origin))
    assert (tracked.read_bytes(), tracked.stat().st_mtime_ns) == before


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tfmm, "SRC", bad)
    monkeypatch.setattr(tfmm, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tfmm.build()
    assert list((tmp_path / "_build").iterdir()) == []


def _cfgs():
    out = []
    for cls in (JConfig, Config):
        cfg = cls()
        cfg.region.lat_range = (39.95, 40.05)
        cfg.region.lon_range = (-124.05, -123.95)
        cfg.region.degree_padding = 0.02
        cfg.region.depth_range = (-9e3, 1e3)
        cfg.travel_time.dx = 1000.0
        out.append(cfg)
    return out


_VEL_MODELS = {
    "default": (None, None),
    "1d": ({"type": "1d", "depths": [0.0, -20e3, -5e3], "vp": [4000.0, 7000.0, 5500.0],
            "vs": [2300.0, 4000.0, 3100.0]}, None),
    "3d": ({"type": "3d", "points_lla": np.array([[40.0, -124.05, -10e3],
                                                  [40.0, -123.95, -10e3],
                                                  [40.05, -124.0, -2e3]]),
            "vp": np.array([5000.0, 7000.0, 6000.0]),
            "vs": np.array([3000.0, 4000.0, 3500.0])}, None),
    "profiles": ({"type": "profiles", "profiles": [
        {"coor": (40.0, -124.08), "radius_km": 10.0, "depths": [-20e3, 0.0],
         "vp": [6000.0, 5000.0], "vs": [3500.0, 2900.0]},
        {"coor": (40.0, -123.92), "radius_km": 7.0, "depths": [0.0, -20e3],
         "vp": [8000.0, 6500.0], "vs": [4500.0, 3700.0]}]}, None),
    "topography": (None, np.array([[40.0, -124.0, -2000.0], [40.03, -123.97, 500.0],
                                   [39.97, -124.04, -300.0]])),
}


@pytest.mark.parametrize("kind", list(_VEL_MODELS))
def test_build_velocity_volume_equals_jax(kind):
    vm, surf = _VEL_MODELS[kind]
    jcfg, tcfg = _cfgs()
    jproj = JProjection.from_center((40.0, -124.0))
    tproj = Projection.from_center((40.0, -124.0))
    lo = np.array([-10e3, -10e3, -20e3])
    shape, h = (11, 12, 13), 2000.0
    want = jwf.build_velocity_volume(jcfg, jproj, lo, shape, h, vel_model=vm,
                                     surface_lla=surf)
    got = twf.build_velocity_volume(tcfg, tproj, lo, shape, h, vel_model=vm,
                                    surface_lla=surf)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == shape
        np.testing.assert_array_equal(g, w)
    if kind == "topography":
        assert (got[0] == 343.0).any() and (got[0] > 1000.0).any()


def test_fmm_grid_box_equals_jax():
    jcfg, tcfg = _cfgs()
    for c in (jcfg, tcfg):
        c.region.lat_range, c.region.lon_range = (35.8055, 39.775097), (-123.70883, -120.338257)
        c.region.depth_range, c.region.degree_padding = (-40000.0, 2000.0), 0.25
        c.travel_time.dx = 1500.0
    want = jwf.fmm_grid_box(jcfg, JProjection.from_center(jcfg.region.center))
    got = twf.fmm_grid_box(tcfg, Projection.from_center(tcfg.region.center))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == ((239, 336, 34), 1500.0)


def test_build_fmm_tables_equals_jax(tmp_path):
    """Both packages' tables of a small box, station by station, sharded
    and re-run: the same arrays, and a re-run rewrites nothing."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    sta_lla = np.stack((rng.uniform(39.96, 40.04, 3), rng.uniform(-124.04, -123.96, 3),
                        rng.uniform(0.0, 800.0, 3)), axis=1)
    surf = _VEL_MODELS["topography"][1]
    want = jwf.build_fmm_tables(jcfg, JProjection.from_center(jcfg.region.center),
                                sta_lla, tmp_path / "jax", verbose=False, surface_lla=surf)
    tproj = Projection.from_center(tcfg.region.center)
    for shard in ([2, 0], [1]):
        got = twf.build_fmm_tables(tcfg, tproj, sta_lla, tmp_path / "port",
                                   station_indices=shard, verbose=False, surface_lla=surf)
    np.testing.assert_array_equal(got[1], want[1])
    assert tuple(got[0]) == tuple(want[0]) and got[2] == want[2]
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == [f"travel_time_grid_station_{j}.npz" for j in range(3)]
    for j in range(3):
        zj = np.load(tmp_path / "jax" / f"travel_time_grid_station_{j}.npz")
        zt = np.load(tmp_path / "port" / f"travel_time_grid_station_{j}.npz")
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k])
    stamp = {p: p.stat().st_mtime_ns for p in (tmp_path / "port").iterdir()}
    twf.build_fmm_tables(tcfg, tproj, sta_lla, tmp_path / "port", verbose=False,
                         surface_lla=surf)
    assert {p: p.stat().st_mtime_ns for p in (tmp_path / "port").iterdir()} == stamp
