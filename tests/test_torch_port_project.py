"""The port's project setup against the JAX package: stations.txt, the
project files, ``load_project`` of a JAX-written project, picks and HypoDD
catalog conversion, the k-means packing family (the Lloyd steps on JAX's
own draws, and the statistics of the port's draws), ``rotation_matrix``,
``rasterize_surface``, ``domain_from_project``; and a project run end to
end in the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tpu import geometry as jgeo
from genie_tpu.graphs import build as jb
from genie_tpu.setup import project as jproj
from genie_tpu.workflow import domain_from_project as jdomain_from_project
from genie_tpu.workflow import rasterize_surface as jrasterize
from genie_tpu_torch import geometry as tgeo
from genie_tpu_torch.config import Config
from genie_tpu_torch.graphs import build as tb
from genie_tpu_torch.setup import project as tproj
from genie_tpu_torch.workflow import domain_from_project, rasterize_surface
from tests.test_workflow import small_cfg


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Small CPU ops: two intra-op threads run them near their fastest, and
    with several test workers on the machine more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = small_cfg()
    return jcfg, Config.from_dict(jcfg.to_dict())


def _stations(cfg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack((rng.uniform(*cfg.region.lat_range, n),
                     rng.uniform(*cfg.region.lon_range, n),
                     rng.uniform(0, 1200, n)), axis=1)


def _assert_npz_equal(a, b):
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_read_stations_txt_and_project_files_equal_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    sta = _stations(tcfg)
    (tmp_path / "stations.txt").write_text(
        "".join(f"ST{i:02d} {a:.5f} {b:.5f} {c:.1f}\n" for i, (a, b, c) in enumerate(sta))
        + "short line\n")
    got = tproj.read_stations_txt(tmp_path / "stations.txt")
    want = jproj.read_stations_txt(tmp_path / "stations.txt")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

    jproj.init_project(tmp_path / "jax", jcfg, stations_txt=tmp_path / "stations.txt",
                       n_steps_grids=5)
    _, proj, grids = tproj.init_project(tmp_path / "port", tcfg,
                                        stations_txt=tmp_path / "stations.txt",
                                        n_steps_grids=5, device="cpu")
    for f in ("TestProj_stations.npz", "TestProj_region.npz", "1d_velocity_model.npz"):
        _assert_npz_equal(tmp_path / "port" / f, tmp_path / "jax" / f)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert grids.shape == (2, 60, 3) and grids.dtype == np.float32
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "Grids" /
                "TestProj_seismic_network_templates_ver_1.npz")["x_grids"], grids)
    with pytest.raises(ValueError, match="stations_txt"):
        tproj.init_project(tmp_path / "none", tcfg, device="cpu")


def test_load_project_of_a_jax_project(tmp_path):
    jcfg, _ = _cfgs()
    jproj.init_project(tmp_path, jcfg, sta_lla=_stations(jcfg), n_steps_grids=5)
    want = jproj.load_project(tmp_path, "TestProj")
    got = tproj.load_project(tmp_path, "TestProj")
    assert sorted(got) == sorted(want)
    for k in ("sta_lla", "sta_names", "grids_lla"):
        np.testing.assert_array_equal(got[k], want[k])
    assert sorted(got["region"]) == sorted(want["region"])
    for k in want["region"]:
        np.testing.assert_array_equal(got["region"][k], want["region"][k])
    np.testing.assert_array_equal(got["projection"].rbest,
                                  np.asarray(want["projection"].rbest, np.float64))
    np.testing.assert_array_equal(got["projection"].mn,
                                  np.asarray(want["projection"].mn, np.float64))


def test_convert_picks_txt_equals_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    names = np.array(["AAA", "BBB", "CCC"])
    (tmp_path / "picks.txt").write_text("\n".join([
        "2020-1-2 100.5 AAA P 3.5", "2020-1-2 101.25 BBB S", "2020-1-3 5.0 CCC p 1.0",
        "2020-1-3 6.0 ZZZ P", "bad"]))
    from genie_tpu.io import project_dirs as jdirs
    from genie_tpu_torch.io import project_dirs as tdirs

    dj, dt = jdirs(tmp_path / "jax", "TestProj"), tdirs(tmp_path / "port", "TestProj")
    want = jproj.convert_picks_txt(tmp_path / "picks.txt", dj, jcfg, names)
    got = tproj.convert_picks_txt(tmp_path / "picks.txt", dt, tcfg, names)
    assert got == want == ["2020-1-2", "2020-1-3"]
    for d in ("TestProj_2020_1_2_ver_1.npz", "TestProj_2020_1_3_ver_1.npz"):
        _assert_npz_equal(dt["picks"] / "2020" / d, dj["picks"] / "2020" / d)


def test_hypodd_catalog_conversion(tmp_path):
    """Twin of tests/test_utils_io.py::test_hypodd_catalog_conversion."""
    import h5py

    from genie_tpu_torch.io import load_catalog, project_dirs, save_picks

    cfg = Config()
    cfg.region.name = "T"
    sta_names = np.array(["AAA", "BBB", "CCC"])
    dirs = project_dirs(tmp_path, "T")
    catalog = "\n".join([
        "# 2020 1 2 3 4 5.5 40.1 -124.2 7.5 2.1 0.4 0.8 0.1 1",
        "AAA 3.2 0.9 P",
        "BBB 5.9 0.8 S",
        "# 2020 1 2 10 0 0.0 40.3 -124.0 4.0 1.5 0.2 0.2 0.1 2",
        "CCC 2.0 0.7 P",
        "# 2020 1 3 0 0 1.0 40.0 -124.1 10.0 3.0 1.0 1.0 0.1 3",
        "AAA 4.0 0.95 P",
    ])
    (tmp_path / "catalog.txt").write_text(catalog)

    evs = tproj.parse_hypodd_catalog(tmp_path / "catalog.txt", sta_names)
    want = jproj.parse_hypodd_catalog(tmp_path / "catalog.txt", sta_names)
    assert len(evs) == len(want) == 3
    for a, b in zip(evs, want):
        assert {k: v for k, v in a.items() if k != "picks"} == {
            k: v for k, v in b.items() if k != "picks"}
        np.testing.assert_array_equal(a["picks"], b["picks"])
    assert evs[0]["date"] == (2020, 1, 2)
    tod0 = 3 * 3600 + 4 * 60 + 5.5
    assert abs(evs[0]["tod"] - tod0) < 1e-6
    assert evs[0]["lla"] == (40.1, -124.2, -7500.0)
    assert abs(evs[0]["sigma_m"] - 600.0) < 1e-6
    assert evs[0]["picks"].shape == (2, 4)

    save_picks(dirs["picks"] / "2020" / "T_2020_1_2_ver_1.npz",
               np.array([tod0 + 3.4]), np.array([0]), np.array([0.0]),
               amp=np.array([123.0]))
    proj = tgeo.Projection.from_center((40.0, -124.0))
    days = tproj.convert_hypodd_catalog(tmp_path / "catalog.txt", dirs, cfg, sta_names, proj)
    assert days == ["2020-1-2", "2020-1-3"]
    f1 = dirs["catalog"] / "2020" / "T_results_continuous_days_2020_1_2_ver_1.hdf5"
    cat = load_catalog(f1)
    assert len(cat) == 2
    assert cat[0].mag == 2.1
    assert list(cat[0].picks) == [0, 1]
    assert list(cat[0].pick_phases) == [0, 1]
    assert list(cat[1].picks) == [2]
    with h5py.File(f1, "r") as f:
        assert abs(f.attrs["amp"][0] - 123.0) < 1e-9
        assert f.attrs["amp"][1] == 0.0
    (tmp_path / "bad.txt").write_text(
        "# 2020 1 2 0 0 0.0 40 -124 5 1 0.1 0.1 0.1 9\nZZZ 1.0 0.5 P")
    with pytest.raises(ValueError):
        tproj.parse_hypodd_catalog(tmp_path / "bad.txt", sta_names)


# -- the k-means packing family ----------------------------------------------
# JAX's draws, transcribed from genie_tpu/graphs/build.py (the key splits and
# the samplers of each variant), fed to the port's Lloyd steps.

def _jax_fit_sources_draws(key, ref, scale, offset, n_clusters, to_cart, blur, frac,
                           n_batch, n_steps):
    ref = jnp.asarray(ref, jnp.float32)

    def sampler(k2, n):
        k_a, k_b, k_c, _ = jax.random.split(k2, 4)
        n_ref = int(frac * n)
        idx = jax.random.randint(k_a, (n_ref,), 0, ref.shape[0])
        pts_ref = ref[idx] + blur * jax.random.normal(k_b, (n_ref, 3))
        pts_uni = jax.random.uniform(k_c, (n - n_ref, 3)) * jnp.asarray(
            scale, jnp.float32) + jnp.asarray(offset, jnp.float32)
        return jnp.concatenate((pts_ref, to_cart(pts_uni)), axis=0)

    k0, key = jax.random.split(key)
    return sampler(k0, n_clusters), jax.jit(jax.vmap(lambda k: sampler(k, n_batch)))(
        jax.random.split(key, n_steps))


def _jax_density_draws(key, density_sample, scale, offset, n_clusters, frac, n_batch,
                       n_steps):
    scale = jnp.asarray(scale, jnp.float32).reshape(1, -1)
    offset = jnp.asarray(offset, jnp.float32).reshape(1, -1)

    def mixture(k2, n, n_d):
        k_a, k_b, k_c = jax.random.split(k2, 3)
        xy = density_sample(k_a, n_d)
        z = jax.random.uniform(k_b, (n_d, 1)) * scale[:, 2:3] + offset[:, 2:3]
        dense = jnp.concatenate((xy, z), axis=1)
        uni = jax.random.uniform(k_c, (n, 3)) * scale + offset
        lo, hi = offset[0, :2], offset[0, :2] + scale[0, :2]
        ok = jnp.all((dense[:, :2] >= lo) & (dense[:, :2] <= hi), axis=1)
        return uni.at[:n_d].set(jnp.where(ok[:, None], dense, uni[:n_d]))

    k0, key = jax.random.split(key)
    return mixture(k0, n_clusters, int(frac * n_clusters)), jax.jit(jax.vmap(
        lambda k: mixture(k, n_batch, int(frac * n_batch))))(jax.random.split(key, n_steps))


def _jax_spherical_draws(key, scale, offset, n_clusters, n_batch, n_steps, izero=0.65):
    scale = jnp.asarray(scale, jnp.float32).reshape(1, -1)
    offset = jnp.asarray(offset, jnp.float32).reshape(1, -1)

    def nodes(k2, n):
        base = jnp.asarray(tb._fibonacci_lattice(n))
        ka, kb, kc, kd, _ = jax.random.split(k2, 5)
        ang = jax.random.uniform(ka, (3,)) * 2 * jnp.pi
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        rx = jnp.array([[1, 0, 0], [0, ca[0], -sa[0]], [0, sa[0], ca[0]]])
        ry = jnp.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
        rz = jnp.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
        lla = jgeo.ecef2lla(base @ (rx @ ry @ rz).T, a=1.0, e=0.0)
        z = jax.random.uniform(kb, (n,)) * scale[0, 2] + offset[0, 2]
        for kk, b in ((kc, 3.0), (kd, 12.0)):
            pick = jax.random.uniform(jax.random.fold_in(kk, 1), (n,)) < izero
            zb = (1.0 - jax.random.beta(kk, 1.0, b, (n,))) * scale[0, 2] + offset[0, 2]
            z = jnp.where(pick, zb, z)
        return jnp.concatenate((lla[:, :2], z[:, None]), axis=1)

    k0, key = jax.random.split(key)
    return nodes(k0, n_clusters), jax.jit(jax.vmap(lambda k: nodes(k, n_batch)))(
        jax.random.split(key, n_steps))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _assert_close_per_axis(got, want, rel):
    """|got − want| ≤ rel × the largest |want| of its coordinate axis."""
    err = np.abs(got - want).max(0)
    assert (err <= rel * np.abs(want).max(0)).all(), (err, np.abs(want).max(0))


def _cart_jt(lat0=0.0, lon0=0.0):
    """A to_cart pair (JAX, torch) of lat/lon/depth → metres from (lat0,
    lon0). Uncentred (tests/test_graphs.py's), the metres reach 1e7, where
    f32 squared distances cannot order the nodes, so the parity case
    centres them."""
    return (lambda x: jnp.stack(((x[..., 1] - lon0) * 90e3, (x[..., 0] - lat0) * 111e3,
                                 x[..., 2]), -1),
            lambda x: torch.stack(((x[..., 1] - lon0) * 90e3, (x[..., 0] - lat0) * 111e3,
                                   x[..., 2]), -1))


def test_kmeans_fit_sources_steps_on_jax_draws():
    proj_j = jgeo.Projection.from_center((40.0, -124.0))
    ref = (np.random.default_rng(1).normal(0, 5e3, (50, 3)).astype(np.float32)
           + np.array([20e3, -10e3, -8e3], np.float32))
    scale, offset = np.array([1.9, 2.0, 42e3]), np.array([39.3, -125.0, -40e3])
    key = jax.random.PRNGKey(0)
    want = np.asarray(jb.kmeans_packing_fit_sources(key, ref, scale, offset, 30,
                                                    proj_j.to_cart, n_batch=300,
                                                    n_steps=40))
    v0, xs = _jax_fit_sources_draws(key, ref, scale, offset, 30, proj_j.to_cart, 15e3,
                                    0.5, 300, 40)
    got = tb.kmeans_from_draws(_t(v0), _t(xs), lambda a: a, 1.0, 0.01).numpy()
    _assert_close_per_axis(got, want, 1e-5)


def test_kmeans_with_density_steps_on_jax_draws():
    rng = np.random.default_rng(0)
    ev = np.stack((np.full(50, 40.0), np.full(50, -123.0)), 1) + rng.normal(0, 0.03, (50, 2))
    scale, offset = np.array([2.0, 2.0, 30e3]), np.array([39.0, -124.0, -30e3])
    to_cart_j, to_cart_t = _cart_jt(40.0, -123.0)
    key = jax.random.PRNGKey(3)
    sampler = jb.gaussian_kde_sampler(ev, bandwidth=0.03)
    want = np.asarray(jb.kmeans_packing_with_density(key, sampler, scale, offset, 60,
                                                     to_cart_j, weight=[1.0, 1.0, 2.5],
                                                     n_steps=30, n_batch=200))
    v0, xs = _jax_density_draws(key, sampler, scale, offset, 60, 0.75, 200, 30)
    got = tb.kmeans_from_draws(_t(v0), _t(xs), to_cart_t, _t([1.0, 1.0, 2.5]),
                               0.01).numpy()
    _assert_close_per_axis(got, want, 1e-5)


def test_kmeans_spherical_steps_on_jax_draws():
    scale, offset = np.array([0.0, 0.0, 100e3]), np.array([0.0, 0.0, -100e3])

    def to_cart_j(x):
        return jgeo.lla2ecef(jnp.concatenate((x[..., :2], jnp.zeros_like(x[..., 2:])), -1)
                             ) / 6371e3 + jnp.concatenate(
            (jnp.zeros_like(x[..., :2]), x[..., 2:]), -1) / 100e3

    def to_cart_t(x):
        return tgeo.lla2ecef(torch.cat((x[..., :2], torch.zeros_like(x[..., 2:])), -1)
                             ) / 6371e3 + torch.cat(
            (torch.zeros_like(x[..., :2]), x[..., 2:]), -1) / 100e3

    key = jax.random.PRNGKey(1)
    want = np.asarray(jb.kmeans_packing_spherical(key, scale, offset, 80, to_cart_j,
                                                  n_steps=20, n_batch=300))
    v0, xs = _jax_spherical_draws(key, scale, offset, 80, 300, 20)
    got = tb.kmeans_from_draws(_t(v0), _t(xs), to_cart_t, _t([1.0, 1.0, 2.0]),
                               0.01).numpy()
    _assert_close_per_axis(got, want, 1e-5)


def test_kmeans_fit_sources_statistics():
    """Twin of tests/test_extras.py::test_kmeans_fit_sources."""
    proj = tgeo.Projection.from_center((40.0, -124.0))
    rng = np.random.default_rng(1)
    ref = rng.normal(0, 5e3, (50, 3)).astype(np.float32) + np.array(
        [20e3, -10e3, -8e3], np.float32)
    v = tb.kmeans_packing_fit_sources(
        torch.Generator().manual_seed(0), ref, np.array([1.9, 2.0, 42e3]),
        np.array([39.3, -125.0, -40e3]), 30, proj.to_cart, n_batch=300, n_steps=60).numpy()
    assert v.shape == (30, 3)
    d = np.linalg.norm(v - np.array([20e3, -10e3, -8e3]), axis=1)
    assert (d < 40e3).sum() >= 10


def test_fibonacci_sphere_equals_jax():
    """Twin of tests/test_extras.py::test_fibonacci_sphere, and the same points."""
    pts = tb.fibonacci_sphere_packing(200)
    np.testing.assert_array_equal(pts, jb.fibonacci_sphere_packing(200))
    r = np.linalg.norm(pts, axis=1)
    assert np.allclose(r, 6371e3, rtol=1e-6)
    assert pts[:, 2].min() < -6e6 and pts[:, 2].max() > 6e6


def test_kmeans_with_density_statistics():
    """Twin of tests/test_graphs.py::test_kmeans_packing_with_density."""
    ev = np.stack((np.full(50, 40.0), np.full(50, -123.0)), 1)
    ev += np.random.default_rng(0).normal(0, 0.03, ev.shape)
    _, to_cart = _cart_jt()
    v = tb.kmeans_packing_with_density(
        torch.Generator().manual_seed(0), tb.gaussian_kde_sampler(ev, bandwidth=0.03),
        np.array([2.0, 2.0, 30e3]), np.array([39.0, -124.0, -30e3]), 200, to_cart,
        frac=0.75, n_steps=120, n_batch=500).numpy()
    assert v.shape == (200, 3)
    d = np.hypot(v[:, 0] - 40.0, v[:, 1] + 123.0)
    assert (d < 0.2).mean() > 0.4
    assert (d > 0.5).sum() > 5
    assert np.all((v[:, 2] >= -31e3) & (v[:, 2] <= 1e3))


def test_kmeans_spherical_statistics():
    """Twin of tests/test_graphs.py::test_kmeans_packing_spherical."""
    def to_cart(x):
        return tgeo.lla2ecef(torch.cat((x[..., :2], torch.zeros_like(x[..., 2:])), -1)
                             ) / 6371e3 + torch.cat(
            (torch.zeros_like(x[..., :2]), x[..., 2:]), -1) / 100e3

    v = tb.kmeans_packing_spherical(torch.Generator().manual_seed(1),
                                    np.array([0.0, 0.0, 100e3]),
                                    np.array([0.0, 0.0, -100e3]), 300, to_cart,
                                    n_steps=60, n_batch=600).numpy()
    assert v.shape == (300, 3)
    assert np.all(np.abs(v[:, 0]) <= 90.5) and np.all(np.abs(v[:, 1]) <= 180.5)
    assert (v[:, 0] > 20).sum() > 30 and (v[:, 0] < -20).sum() > 30
    assert np.median(v[:, 2]) > -50e3
    assert np.all((v[:, 2] >= -101e3) & (v[:, 2] <= 1e3))


def test_spherical_depth_draws_follow_the_beta_mixture():
    """The port draws 1 − Beta(1, b) as U^(1/b): over many nodes the depth
    quantiles match JAX's beta draws."""
    scale, offset = np.array([0.0, 0.0, 100e3]), np.array([0.0, 0.0, -100e3])
    v0, _ = tb.kmeans_packing_spherical_draws(torch.Generator().manual_seed(0), scale,
                                              offset, 20000, n_batch=10, n_steps=1)
    w0, _ = _jax_spherical_draws(jax.random.PRNGKey(0), scale, offset, 20000, 10, 1)
    q = [0.1, 0.25, 0.5, 0.75, 0.9]
    np.testing.assert_allclose(np.quantile(v0[:, 2].numpy(), q),
                               np.quantile(np.asarray(w0)[:, 2], q), atol=1.5e3)


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (0.3, -1.2, 2.5), (3.1, 0.7, -0.4)])
def test_rotation_matrix_matches_jax(angles):
    want = np.asarray(jgeo.rotation_matrix(*angles))
    got = tgeo.rotation_matrix(*angles).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)


def test_projection_reference_aliases():
    p = tgeo.Projection.from_center((40.0, -124.0))
    x = torch.tensor([[40.1, -124.2, -5e3]])
    np.testing.assert_array_equal(p.ftrns1(x).numpy(), p.to_cart(x).numpy())
    np.testing.assert_array_equal(p.ftrns2(p.ftrns1(x)).numpy(), p.to_lla(p.to_cart(x)).numpy())


def test_rasterize_surface_equals_jax():
    lats, lons = np.linspace(39.9, 40.1, 8), np.linspace(-124.1, -123.9, 8)
    gl = np.stack(np.meshgrid(lats, lons, indexing="ij"), -1).reshape(-1, 2)
    surf = np.concatenate((gl, (-3000.0 + 2.0e-1 * (gl[:, 1] + 124.0) * 111e3)[:, None]), 1)
    want = jrasterize(jgeo.Projection.from_center((40.0, -124.0)), surf,
                      [-12e3, -12e3], [12e3, 12e3], n=16)
    got = rasterize_surface(tgeo.Projection.from_center((40.0, -124.0)), surf,
                            [-12e3, -12e3], [12e3, 12e3], n=16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_domain_from_project_of_a_jax_project(tmp_path):
    """A JAX-written project with homogeneous travel times and a surface
    file: the port's domain context carries JAX's grid tables."""
    jcfg, tcfg = _cfgs()
    for c in (jcfg, tcfg):
        c.travel_time.use_topography = True
        c.travel_time.dx = 5000.0
    jproj.init_project(tmp_path, jcfg, sta_lla=_stations(jcfg), n_steps_grids=5)
    surf = np.array([[40.0, -124.0, -200.0], [40.5, -123.5, 300.0]])
    np.savez(tmp_path / "TestProj_surface.npz", lla=surf)
    ctx_j, _, _ = jdomain_from_project(tmp_path, jcfg)
    ctx, proj, trv = domain_from_project(tmp_path, tcfg, device="cpu")
    assert ctx.trv_grids.shape == (2, 60, 12, 2)
    np.testing.assert_allclose(ctx.trv_grids.numpy(), np.asarray(ctx_j.trv_grids),
                               rtol=0, atol=1e-5)
    for k in ("sta_cart", "grids_cart", "grids_lla"):
        np.testing.assert_array_equal(getattr(ctx, k).numpy(), np.asarray(getattr(ctx_j, k)))
    for g, w in zip(ctx.surface, ctx_j.surface):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_full_project_workflow(tmp_path):
    """Twin of tests/test_workflow.py::test_full_project_workflow in the
    port alone, on the CPU: init → load → domain → train → process_day."""
    from genie_tpu_torch.io import load_catalog, save_picks
    from genie_tpu_torch.workflow import process_day, train

    _, cfg = _cfgs()
    n_sta = cfg.graph.max_sta
    sta_lla = _stations(cfg, n_sta)
    dirs, proj, grids = tproj.init_project(tmp_path, cfg, sta_lla=sta_lla,
                                           n_steps_grids=60, device="cpu")
    assert (tmp_path / "TestProj_stations.npz").exists()
    assert grids.shape == (2, 60, 3)
    assert grids[..., 0].min() > cfg.region.lat_range_extend[0] - 0.1
    assert grids[..., 0].max() < cfg.region.lat_range_extend[1] + 0.1

    pj = tproj.load_project(tmp_path, "TestProj")
    assert pj["sta_lla"].shape == (n_sta, 3)
    ctx, proj2, trv = domain_from_project(tmp_path, cfg, device="cpu")
    assert ctx.trv_grids.shape[:2] == (2, 60)
    assert torch.isfinite(ctx.trv_grids).all()

    model, state, _ = train(cfg, ctx, trv, tmp_path / "GNN_TrainedModels", n_steps=3,
                            log_every=1)
    assert (tmp_path / "GNN_TrainedModels" / "ckpt.pkl").exists()
    log_txt = (tmp_path / "GNN_TrainedModels" / "TestProj_output_ver_1.txt").read_text()
    trgt_vals = [float(x) for ln in log_txt.splitlines()
                 for x in ln.split("trgts [")[1].split("]")[0].split()]
    assert sum(trgt_vals) > 0.0, log_txt

    sta_cart = ctx.sta_cart.numpy()
    true_pos = sta_cart.mean(axis=0) + np.array([5e3, -5e3, -10e3], np.float32)
    with torch.no_grad():
        trv_ev = trv.from_cart(ctx.sta_cart, torch.as_tensor(true_pos[None])).numpy()[0]
    t_ev = 100.0
    save_picks(tmp_path / "picks_day.npz",
               np.concatenate((t_ev + trv_ev[:, 0], t_ev + trv_ev[:, 1])),
               np.concatenate((np.arange(n_sta), np.arange(n_sta))),
               np.concatenate((np.zeros(n_sta), np.ones(n_sta))))
    events = process_day(cfg, ctx, trv, model, tmp_path / "picks_day.npz",
                         tmp_path / "catalog_day.hdf5", t_start=60.0, t_end=200.0,
                         device="cpu")
    assert len(load_catalog(tmp_path / "catalog_day.hdf5")) == len(events)
