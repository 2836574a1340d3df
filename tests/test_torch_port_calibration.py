"""The port's travel-time PINN, corrections, magnitude model, segment
reductions, k-means query grid and catalog I/O against the JAX package, on
numpy-seeded inputs with the checked-in run6 artifacts
(``Grids/pinn_nc.pkl``, ``run6/corrections_nc.npz``,
``run6/mag_model_nc.pkl``).

Tolerances: PINN times 1e-3 s (f32 through a 50-wide sin MLP, times up to
~90 s), normalized times 1e-5, velocities rtol 1e-5, partials 1e-3 of the
largest; interpolated corrections 1e-5 s; magnitudes 1e-4. The k-means
draws differ between ``jax.random`` and ``torch.Generator``, so one Lloyd
step is compared on shared inputs and the packed grid by statistics."""

import pickle
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu import io as jax_io
from genie_tpu.calibration import corrections as jc
from genie_tpu.calibration.magnitude_scale import apply_magnitudes as jax_apply_mags
from genie_tpu.config import Config as JaxConfig
from genie_tpu.geometry import Projection as JaxProjection
from genie_tpu.infer.pipeline import CatalogEvent as JaxEvent
from genie_tpu.infer.pipeline import build_query_grid as jax_query_grid
from genie_tpu.models import travel_time_pinn as jpinn
from genie_tpu.models.magnitude import MagnitudeModel as JaxMagnitude
from genie_tpu.ops import segment as jseg
from genie_tpu.ops.knn import knn as jax_knn
from genie_tpu.workflow import make_trv as jax_make_trv
from genie_tpu_torch import io as tio
from genie_tpu_torch.calibration import corrections as tc
from genie_tpu_torch.calibration.magnitude_scale import apply_magnitudes
from genie_tpu_torch.graphs.build import kmeans_step
from genie_tpu_torch.infer.pipeline import CatalogEvent, build_query_grid
from genie_tpu_torch.models.magnitude import MagnitudeModel
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.models.travel_time_pinn import (TravelTimePN, load_reference_pinn,
                                                     velocity_r2)
from genie_tpu_torch.ops import segment as tseg
from genie_tpu_torch.params import (load_flax_params, load_into, load_magnitude_model,
                                    load_pinn, transplant)
from genie_tpu_torch.train.trainer import build_domain_context
from genie_tpu_torch.workflow import make_trv

from tests.test_trainer import tiny_config, tiny_domain

ROOT = Path(__file__).resolve().parent.parent
PINN = ROOT / "projects/NC_EHZ/Grids/pinn_nc.pkl"
CORR = ROOT / "projects/NC_EHZ/run6/corrections_nc.npz"
MAG = ROOT / "projects/NC_EHZ/run6/mag_model_nc.pkl"


def _points(rng, n, depth=(-40e3, 0.0), half=(150e3, 200e3)):
    p = np.stack((rng.uniform(-half[0], half[0], n), rng.uniform(-half[1], half[1], n),
                  rng.uniform(*depth, n)), axis=1)
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def pinns():
    cfg = JaxConfig()
    proj = JaxProjection.from_center(cfg.region.center)
    rng = np.random.default_rng(0)
    sta = _points(rng, 24, depth=(-1e3, 1e3))
    src = _points(rng, 40)
    return (jax_make_trv(cfg, proj, pinn_path=PINN), load_pinn(PINN, device="cpu"),
            sta, src)


def test_pinn_from_cart_matches_jax(pinns):
    jt, tt, sta, src = pinns
    want = np.asarray(jt.from_cart(jnp.asarray(sta), jnp.asarray(src)))
    with torch.no_grad():
        got = tt.from_cart(torch.from_numpy(sta), torch.from_numpy(src)).numpy()
        tt.max_pairs = 100          # several source chunks, (n_ev, pop, 3) batch
        try:
            batched = tt.from_cart(torch.from_numpy(sta),
                                   torch.from_numpy(src).reshape(4, 10, 3)).numpy()
        finally:
            del tt.max_pairs
    assert got.shape == (40, 24, 2) and want.max() > 10.0
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_allclose(batched.reshape(40, 24, 2), want, atol=1e-3, rtol=0)


def test_pinn_pairwise_matches_jax(pinns):
    jt, tt, sta, src = pinns
    want = np.asarray(jt.pairwise_from_cart(jnp.asarray(sta), jnp.asarray(src[:24])))
    with torch.no_grad():
        got = tt.pairwise_from_cart(torch.from_numpy(sta),
                                    torch.from_numpy(src[:24])).numpy()
    assert got.shape == (24, 2)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_pinn_time_norm_and_velocity_match_jax(pinns):
    jt, tt, sta, src = pinns
    sta_n = np.array(jt._norm(jnp.asarray(sta)))
    src_n = np.array(jt._norm(jnp.asarray(src[:24])))
    s = jt.scales
    want_t = np.asarray(jt.model.apply(jt.params, sta_n, src_n, s.conversion_factor,
                                       s.v_mean, method=jpinn.TravelTimesPN.time_norm))
    want_v = np.asarray(jt.model.apply(jt.params, src_n, None,
                                       method=jpinn.TravelTimesPN.velocity))
    ts = tt.scales
    with torch.no_grad():
        got_t = tt.model.time_norm(torch.from_numpy(sta_n), torch.from_numpy(src_n),
                                   ts.conversion_factor, ts.v_mean).numpy()
        got_v = tt.model.velocity(torch.from_numpy(src_n)).numpy()
    np.testing.assert_allclose(got_t, want_t, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=0)
    r2 = jpinn.velocity_r2(jt.model, jt.params, s, src_n, want_v * 6000.0)
    np.testing.assert_allclose(velocity_r2(tt.model, ts, src_n, want_v * 6000.0), r2,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("corrected", [False, True])
def test_pinn_partials_match_jax(pinns, corrected):
    """torch.func.jacfwd through the (corrected) PINN against jax.jacfwd, as
    the location covariance takes them, batched with vmap."""
    jt, tt, sta, src = pinns
    jfn, tfn = jt.from_cart, tt.from_cart
    if corrected:
        z = np.load(CORR)
        coefs = z["coefs"][:, :24]
        jfn = jc.TravelTimeCorrection(jt.from_cart, jnp.asarray(z["grid_cart"]),
                                      jnp.asarray(coefs)).from_cart
        tfn = tc.TravelTimeCorrection(tt.from_cart, z["grid_cart"], coefs).from_cart
    x = src[:5]
    want = np.asarray(jax.vmap(jax.jacfwd(
        lambda p: jfn(jnp.asarray(sta), p[None])[0]))(jnp.asarray(x)))
    got = torch.func.vmap(torch.func.jacfwd(
        lambda p: tfn(torch.from_numpy(sta), p[None])[0]))(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (5, 24, 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def _reference_state_dict(params):
    """A JAX TravelTimesPN tree under the reference torch module's names."""
    p = params["params"]
    sd = {}

    def dense(ref, leaf):
        sd[f"{ref}.weight"] = torch.from_numpy(np.asarray(leaf["kernel"]).T.copy())
        sd[f"{ref}.bias"] = torch.from_numpy(np.asarray(leaf["bias"]).copy())

    for b in (1, 2, 3):
        for i in (1, 2, 3):
            dense(f"fc{b}_{i}", p[f"fc{b}_{i}"])
    dense("fc3_4", p["fc3_4"])
    dense("merge.0", p["merge_1"])
    sd["merge.1.weight"] = torch.from_numpy(np.array(p["merge_act"]["a"]).reshape(1))
    dense("merge.2", p["merge_2"])
    for i in (1, 2, 3):
        dense(f"vmodel.fc1_{i}", p["vmodel"][f"fc1_{i}"])
    for j in range(2):
        dense(f"vmodel.fc1_4.{j}", p["vmodel"][f"fc1_4_{j}"])
    return sd


def test_load_reference_pinn_matches_jax(tmp_path, pinns):
    _, _, sta, src = pinns
    model = jpinn.TravelTimesPN(per_phase_base=True)
    scales = jpinn.scales_from_domain(np.zeros(3), 400e3, 120.0, [6000.0, 3500.0])
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 3)), jnp.zeros((1, 3)),
                        scales.conversion_factor, scales.v_mean, scales.t_scale,
                        method=jpinn.TravelTimesPN.init_all)
    path = tmp_path / "ref_pinn.h5"
    torch.save(_reference_state_dict(params), path)
    scale_params = np.array([400e3, 120.0, 7000.0, 3000.0, 1.0, 400e3 / 120.0])
    jm, jp, js = jpinn.load_reference_pinn(path, scale_params, [6000.0, 3500.0])
    tm, ts = load_reference_pinn(path, scale_params, [6000.0, 3500.0], device="cpu")
    # the weights arrive unchanged: normalized times and velocities agree to
    # f32 rounding; seconds (up to ~120 s) within the PINN tolerance
    sta_n, src_n = sta / 400e3, src[:24] / 400e3
    want_n = np.asarray(jm.apply(jp, sta_n, src_n, js.conversion_factor, js.v_mean,
                                 method=jpinn.TravelTimesPN.time_norm))
    want_v = np.asarray(jm.apply(jp, src_n, None, method=jpinn.TravelTimesPN.velocity))
    want = np.asarray(jpinn.TravelTimePN(jm, jp, js).from_cart(jnp.asarray(sta),
                                                                jnp.asarray(src)))
    with torch.no_grad():
        got_n = tm.time_norm(torch.from_numpy(sta_n), torch.from_numpy(src_n),
                             ts.conversion_factor, ts.v_mean).numpy()
        got_v = tm.velocity(torch.from_numpy(src_n)).numpy()
        got = TravelTimePN(tm, ts).from_cart(torch.from_numpy(sta),
                                             torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(got_n, want_n, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_make_trv_loads_the_pinn_or_falls_back(tmp_path, pinns):
    from genie_tpu_torch.config import Config
    from genie_tpu_torch.geometry import Projection
    cfg = Config()
    proj = Projection.from_center(cfg.region.center)
    assert isinstance(make_trv(cfg, proj, pinn_path=PINN, device="cpu"), TravelTimePN)
    assert isinstance(make_trv(cfg, proj, pinn_path=tmp_path / "none.pkl"),
                      HomogeneousTravelTime)


# -- interpolators and corrections -------------------------------------------

@pytest.fixture(scope="module")
def field():
    z = np.load(CORR)
    rng = np.random.default_rng(1)
    return (z["grid_cart"].astype(np.float32), z["coefs"][:, :24].astype(np.float32),
            _points(rng, 64), rng.normal(0, 5e3, (500, 3)).astype(np.float32))


@pytest.mark.parametrize("name", ["knn_mean", "weighted", "anisotropic", "scattered"])
def test_interpolators_match_jax(field, name):
    grid, coefs, src, kern = field
    jg, jco, js = map(jnp.asarray, (grid, coefs, src))
    tg, tco, ts = map(torch.from_numpy, (grid, coefs, src))
    if name == "knn_mean":
        want, got = jc.interp_knn_mean(jg, jco, js), tc.interp_knn_mean(tg, tco, ts)
    elif name == "weighted":
        want, got = jc.interp_weighted(jg, jco, js), tc.interp_weighted(tg, tco, ts)
    elif name == "anisotropic":
        want = jc.interp_anisotropic(jg, jco, js, jnp.asarray(kern))
        got = tc.interp_anisotropic(tg, tco, ts, torch.from_numpy(kern))
    else:
        want = jc.interp_scattered(jg, jco, js)
        got = tc.interp_scattered(tg, tco, ts)
    assert got.shape == (64, 24, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_rw_laplacian_matches_jax(field):
    grid, coefs, _, _ = field
    from genie_tpu.ops.knn import knn_graph
    nbr = np.asarray(knn_graph(jnp.asarray(grid) / 1000.0, 8)[0])
    want = jc.rw_laplacian_apply(jnp.asarray(coefs), jnp.asarray(nbr))
    got = tc.rw_laplacian_apply(torch.from_numpy(coefs), torch.from_numpy(nbr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("anisotropic", [False, True])
def test_travel_time_correction_matches_jax(field, anisotropic):
    """Homogeneous base (exact in both) plus the corrections; the source
    batch (n_ev, pop, 3) of the DE objective gives the same times."""
    grid, coefs, src, kern = field
    rng = np.random.default_rng(2)
    sta = _points(rng, 24, depth=(-1e3, 1e3))
    cfg = JaxConfig()
    from genie_tpu.models.travel_time import HomogeneousTravelTime as JaxHomog
    jbase = JaxHomog(JaxProjection.from_center(cfg.region.center))
    tbase = HomogeneousTravelTime(None)
    kw_j = dict(kernels=jnp.asarray(kern)) if anisotropic else {}
    kw_t = dict(kernels=kern) if anisotropic else {}
    jt = jc.TravelTimeCorrection(jbase.from_cart, jnp.asarray(grid), jnp.asarray(coefs),
                                 **kw_j)
    tt = tc.TravelTimeCorrection(tbase.from_cart, grid, coefs, **kw_t)
    want = np.asarray(jt.from_cart(jnp.asarray(sta), jnp.asarray(src)))
    got = tt.from_cart(torch.from_numpy(sta), torch.from_numpy(src)).numpy()
    batched = tt.from_cart(torch.from_numpy(sta),
                           torch.from_numpy(src).reshape(8, 8, 3)).numpy()
    assert batched.shape == (8, 8, 24, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(batched.reshape(64, 24, 2), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tt.pairwise_from_cart(torch.from_numpy(sta), torch.from_numpy(src), None).numpy(),
        np.asarray(jt.pairwise_from_cart(jnp.asarray(sta), jnp.asarray(src), None)),
        atol=1e-5, rtol=0)


def test_matched_catalog_stats_match_jax():
    rng = np.random.default_rng(5)
    ref = np.concatenate((_points(rng, 20), rng.uniform(0, 600, (20, 1))), 1)
    det = ref[:15] + rng.normal(0, [3e3, 3e3, 2e3, 1.0], (15, 4))
    mags = rng.uniform(1.0, 4.5, 20)
    want = jc.matched_catalog_stats(det, ref, mags_ref=mags)
    got = tc.matched_catalog_stats(det, ref, mags_ref=mags)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


# -- magnitudes ----------------------------------------------------------------

@pytest.fixture(scope="module")
def mags():
    blob = pickle.loads(MAG.read_bytes())
    jm = JaxMagnitude(n_sta=blob["n_sta"], n_grid=len(blob["grid_cart"]), k=blob["k"])
    tm = load_magnitude_model(MAG, device="cpu")
    rng = np.random.default_rng(3)
    sta = _points(rng, blob["n_sta"], depth=(-1e3, 1e3))
    n_obs = 300
    src = _points(rng, n_obs, depth=(-20e3, -2e3))
    sta_idx = rng.integers(0, blob["n_sta"], n_obs)
    phase = rng.integers(0, 2, n_obs)
    return blob, jm, tm, sta, src, sta_idx, phase


def test_magnitude_model_matches_jax(mags):
    blob, jm, tm, sta, src, sta_idx, phase = mags
    m = np.random.default_rng(4).uniform(1.0, 4.0, len(src)).astype(np.float32)
    ja = (jnp.asarray(src), jnp.asarray(sta), jnp.asarray(blob["grid_cart"]),
          jnp.asarray(sta_idx, jnp.int32), jnp.asarray(phase, jnp.int32))
    ta = (torch.from_numpy(src), torch.from_numpy(sta),
          torch.as_tensor(blob["grid_cart"]), torch.from_numpy(sta_idx),
          torch.from_numpy(phase))
    want_amp = np.asarray(jm.apply(blob["params"], *ja, mag=jnp.asarray(m)))
    with torch.no_grad():
        got_amp = tm["model"](*ta, mag=torch.from_numpy(m)).numpy()
        got_mag = tm["model"](*ta, log_amp=torch.from_numpy(want_amp)).numpy()
    want_mag = np.asarray(jm.apply(blob["params"], *ja, log_amp=jnp.asarray(want_amp)))
    assert got_amp.shape == (len(src),)
    np.testing.assert_allclose(got_amp, want_amp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_mag, want_mag, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_mag, m, atol=1e-3, rtol=0)   # inversion round trip
    assert tm["dist_model"]["kind"] == blob["dist_model"]["kind"]


def test_apply_magnitudes_matches_jax(mags):
    """One device call for every event in the port, one per event in JAX."""
    blob, jm, tm, sta, src, sta_idx, phase = mags
    rng = np.random.default_rng(6)
    n_pick = 400
    pick_sta = rng.integers(0, blob["n_sta"], n_pick)
    pick_amp = 10 ** rng.uniform(-1, 2, n_pick)
    pick_amp[rng.random(n_pick) < 0.2] = 0.0           # no amplitude
    evs_j, evs_t = [], []
    for e in range(6):
        picks = rng.choice(n_pick, 12, replace=False)
        phases = rng.integers(0, 2, 12)
        if e == 5:
            pick_amp[picks] = 0.0                      # an event with no amplitude
        for evs, cls in ((evs_j, JaxEvent), (evs_t, CatalogEvent)):
            evs.append(cls(pos_cart=src[e].astype(np.float64), time=10.0 * e,
                           picks=picks.copy(), pick_phases=phases.copy()))
    jax_apply_mags(evs_j, jm, blob["params"], sta, blob["grid_cart"], pick_sta, pick_amp)
    apply_magnitudes(evs_t, tm["model"], sta, blob["grid_cart"], pick_sta, pick_amp)
    assert evs_t[5].mag is None and evs_j[5].mag is None
    np.testing.assert_allclose([e.mag for e in evs_t[:5]], [e.mag for e in evs_j[:5]],
                               atol=1e-4, rtol=0)


def test_transplant_maps_raw_parameters():
    tree = load_flax_params(MAG)
    sd = transplant(tree)
    assert set(sd) == {"mag_coef", "epicenter_spatial_coef", "depth_spatial_coef", "bias"}
    with pytest.raises(KeyError, match="root-level"):
        transplant({"stray": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="mismatch"):
        load_into(MagnitudeModel(n_sta=374, n_grid=8),
                  {**tree, "extra": {"kernel": np.zeros((2, 2), np.float32)}})


# -- segment reductions ---------------------------------------------------------

@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max",
                                "segment_softmax"])
def test_segment_ops_match_jax(op):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(50, 3)).astype(np.float32)
    ids = rng.integers(0, 9, 50)
    ids[ids == 4] = 5                                   # segment 4 is empty
    want = np.asarray(getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), 9))
    got = getattr(tseg, op)(torch.from_numpy(data), torch.from_numpy(ids), 9).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if op == "segment_max":
        assert np.isneginf(got[4]).all()


# -- k-means query grid ---------------------------------------------------------

def test_kmeans_lloyd_step_matches_jax():
    rng = np.random.default_rng(8)
    v = _points(rng, 200)
    x = _points(rng, 3000)
    w = np.array([1.0, 1.0, 2.5], np.float32)
    idx, _ = jax_knn(jnp.asarray(v * w), jnp.asarray(x * w), 1)
    ip = idx[:, 0]
    want = np.asarray(jnp.asarray(v) + 0.01 * jseg.segment_mean(
        jnp.asarray(x) - jnp.asarray(v)[ip], ip, 200))
    got = kmeans_step(torch.from_numpy(v), torch.from_numpy(x), lambda a: a,
                      torch.from_numpy(w)[None], 0.01).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _mean_nn_spacing(v):
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.min(1).mean()


def test_build_query_grid_statistics_match_jax():
    cfg = tiny_config()
    ctx, _ = tiny_domain(cfg)
    tctx = build_domain_context(cfg, ctx.sta_lla, ctx.sta_cart, ctx.grids_lla,
                                ctx.grids_cart, ctx.trv_grids, "cpu")
    want = jax_query_grid(jax.random.PRNGKey(11), ctx, 300)
    got = build_query_grid(torch.Generator().manual_seed(11), tctx, 300).numpy()
    assert got.shape == want.shape == (300, 3) and got.dtype == np.float32
    lo = np.asarray(ctx.offset_cart)
    hi = lo + np.asarray(ctx.scale_cart)
    slack = 0.05 * (hi - lo)
    assert (got >= lo - slack).all() and (got <= hi + slack).all()
    assert abs(_mean_nn_spacing(got) / _mean_nn_spacing(want) - 1.0) < 0.10


# -- catalog and pick I/O ---------------------------------------------------------

def _events(cls, rng, n=4):
    out = []
    for i in range(n):
        k = int(rng.integers(3, 9))
        out.append(cls(pos_cart=rng.normal(0, 3e4, 3), time=float(rng.uniform(0, 600)),
                       picks=rng.choice(100, k, replace=False).astype(np.int64),
                       pick_phases=rng.integers(0, 2, k).astype(np.int64),
                       cov=rng.normal(size=(4, 4)) if i % 2 else None,
                       mag=float(rng.uniform(1, 4)) if i != 2 else None,
                       score=float(rng.uniform(0, 1)) if i != 1 else None))
    return out


def _assert_same_events(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.pos_cart, y.pos_cart)
        assert x.time == y.time and x.mag == y.mag and x.score == y.score
        np.testing.assert_array_equal(x.picks, y.picks)
        np.testing.assert_array_equal(x.pick_phases, y.pick_phases)
        assert (x.cov is None) == (y.cov is None)
        if x.cov is not None:
            np.testing.assert_array_equal(x.cov, y.cov)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_catalog_files_cross_read(tmp_path, writer):
    rng = np.random.default_rng(9)
    pick_t = rng.uniform(0, 600, 100)
    pick_sta = rng.integers(0, 16, 100)
    path = tmp_path / "cat.hdf5"
    if writer == "port":
        evs = _events(CatalogEvent, rng)
        tio.save_catalog(path, evs, pick_t=pick_t, pick_sta=pick_sta, extra={"day": 7})
        back = jax_io.load_catalog(path)
        assert all(isinstance(e, JaxEvent) for e in back)
    else:
        evs = _events(JaxEvent, rng)
        jax_io.save_catalog(path, evs, pick_t=pick_t, pick_sta=pick_sta, extra={"day": 7})
        back = tio.load_catalog(path)
        assert all(isinstance(e, CatalogEvent) for e in back)
    _assert_same_events(evs, back)
    import h5py
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["pick_t"][()], pick_t)
        assert f.attrs["day"] == 7


def test_pick_files_round_trip(tmp_path):
    rng = np.random.default_rng(10)
    t = np.sort(rng.uniform(0, 86000, 50))
    sta = rng.integers(0, 16, 50)
    ph = rng.integers(0, 2, 50).astype(np.float64)
    amp = 10 ** rng.uniform(-1, 1, 50)
    path = tmp_path / "Picks/2017/day.npz"
    tio.save_picks(path, t, sta, ph, amp)
    for load in (tio.load_picks, jax_io.load_picks):
        got = load(path)
        for a, b in zip(got, (t, sta, ph, amp)):
            np.testing.assert_array_equal(a, b)
    samples = np.round(t * 100.0) + 8_640_000          # integer sample indices
    jax_io.save_picks(path, samples, sta, ph)
    np.testing.assert_array_equal(tio.load_picks(path)[0], jax_io.load_picks(path)[0])
    dirs = tio.project_dirs(tmp_path / "proj", "NC")
    assert dirs["catalog"].is_dir() and (tmp_path / "proj/Picks").is_dir()
    tio.save_picks(dirs["picks"] / "a.npz", t, sta, ph)
    np.testing.assert_array_equal(tio.discover_subnetworks(dirs["picks"], 16),
                                  jax_io.discover_subnetworks(dirs["picks"], 16))
