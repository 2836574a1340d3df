"""One day file through ``workflow.process_day`` in both packages, in run6's
serving configuration: the PINN of ``Grids/pinn_nc.pkl`` wrapped in the
calibrated corrections of ``run6/corrections_nc.npz`` (grid tables shifted
by them, as ``scripts/nc_process.py`` does), the magnitude model of
``run6/mag_model_nc.pkl`` with its magnitude → distance QC, and the HDF5
catalog. The run6 weights drive the tiny synthetic domain of
tests/test_trainer.py (16 stations, so the per-station artifacts are sliced
to 16 stations in both packages).

The JAX ``process_day`` has no magnitude model, so the JAX catalog gets its
magnitudes from ``InferencePipeline.assign_magnitudes`` afterwards, which is
what ``process_from_sweep`` does last. The DE locator draws different
random numbers in the two packages: locations are held within 1 km and
0.2 s, magnitudes within 0.05."""

import pickle
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu import io as jax_io
from genie_tpu.calibration.corrections import TravelTimeCorrection as JaxCorrection
from genie_tpu.calibration.corrections import interp_weighted as jax_interp
from genie_tpu.geometry import Projection as JaxProjection
from genie_tpu.infer.pipeline import CatalogEvent as JaxEvent
from genie_tpu.infer.pipeline import InferencePipeline as JaxPipeline
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.models.magnitude import MagnitudeModel as JaxMagnitude
from genie_tpu.train.trainer import build_domain_context as jax_context
from genie_tpu.utils import compute_travel_times_chunked as jax_chunked
from genie_tpu.workflow import make_trv as jax_make_trv
from genie_tpu.workflow import process_day as jax_process_day
from genie_tpu_torch.calibration.corrections import TravelTimeCorrection, interp_weighted
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.infer.pipeline import CatalogEvent, InferencePipeline
from genie_tpu_torch.io import load_catalog
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.models.magnitude import MagnitudeModel
from genie_tpu_torch.params import load_flax_params, load_into
from genie_tpu_torch.train.trainer import build_domain_context
from genie_tpu_torch.utils import compute_travel_times_chunked
from genie_tpu_torch.workflow import make_trv, process_day

from tests.test_trainer import tiny_config, tiny_domain

ROOT = Path(__file__).resolve().parent.parent
PINN = ROOT / "projects/NC_EHZ/Grids/pinn_nc.pkl"
CORR = ROOT / "projects/NC_EHZ/run6/corrections_nc.npz"
MAG = ROOT / "projects/NC_EHZ/run6/mag_model_nc.pkl"
PLANTED = ((3, 40.0, 2.8), (17, 120.0, 3.2))   # (grid-0 node, time s, magnitude)


def _jax_side(cfg, base_ctx, z, coefs):
    proj = JaxProjection.from_center(cfg.region.center)
    pinn = jax_make_trv(cfg, proj, pinn_path=PINN)
    gc, co = jnp.asarray(z["grid_cart"]), jnp.asarray(coefs)
    trv = JaxCorrection(pinn.from_cart, gc, co)
    sta = np.asarray(base_ctx.sta_cart)
    grids = np.asarray(base_ctx.grids_cart)
    trv_grids = np.stack([jax_chunked(pinn.from_cart, sta, g)
                          + np.asarray(jax_interp(gc, co, jnp.asarray(g)))
                          for g in grids])
    ctx = jax_context(cfg, np.asarray(base_ctx.sta_lla), sta,
                      np.asarray(base_ctx.grids_lla), grids, trv_grids)
    return ctx, trv


def _port_side(cfg, base_ctx, z, coefs):
    proj = Projection.from_center(cfg.region.center)
    pinn = make_trv(cfg, proj, pinn_path=PINN, device="cpu")
    trv = TravelTimeCorrection(pinn.from_cart, z["grid_cart"], coefs)
    sta = torch.as_tensor(np.asarray(base_ctx.sta_cart))
    grids = torch.as_tensor(np.asarray(base_ctx.grids_cart))
    trv_grids = torch.stack([compute_travel_times_chunked(pinn.from_cart, sta, g)
                             + interp_weighted(trv.grid_cart, trv.coefs, g)
                             for g in grids])
    ctx = build_domain_context(cfg, np.asarray(base_ctx.sta_lla), sta,
                               np.asarray(base_ctx.grids_lla), grids, trv_grids, "cpu")
    return ctx, trv


def _picks(jctx, jmag, mag_params, grid_cart):
    """The planted span of tests/test_torch_port_pipeline.py, timed by the
    corrected PINN, with amplitudes from the magnitude model."""
    rng = np.random.default_rng(0)
    sta = np.asarray(jctx.sta_cart)
    n_sta = len(sta)
    trv = np.asarray(jctx.trv_grids[0])
    t, s, p, amp = [], [], [], []
    for node, t_ev, m in PLANTED:
        pos = np.asarray(jctx.grids_cart[0][node])
        for ph, sig in ((0, 0.1), (1, 0.15)):
            t.append(t_ev + trv[node, :, ph] + rng.normal(0, sig, n_sta))
            s.append(np.arange(n_sta))
            p.append(np.full(n_sta, ph))
            log_amp = np.asarray(jmag.apply(
                mag_params, jnp.asarray(np.repeat(pos[None], n_sta, 0)), jnp.asarray(sta),
                jnp.asarray(grid_cart), jnp.arange(n_sta), jnp.full(n_sta, ph),
                mag=jnp.full(n_sta, m)))
            amp.append(10 ** (log_amp + rng.normal(0, 0.1, n_sta)))
    t.append(rng.uniform(0, 180, 30))
    s.append(rng.integers(0, n_sta, 30))
    p.append(rng.integers(0, 2, 30))
    amp.append(10 ** rng.uniform(-1, 1, 30))
    t, s, p, amp = map(np.concatenate, (t, s, p, amp))
    order = np.argsort(t)
    return t[order], s[order], p[order].astype(np.float64), amp[order]


@pytest.fixture(scope="module")
def day(tmp_path_factory):
    cfg = tiny_config()
    cfg.process.n_rand_query = 1
    cfg.process.refine_chunk = 1
    cfg.process.n_query_grid = 0      # detection queries = grid 0 in both
    cfg.process.thresh = 0.05         # run6 weights on 16 synthetic stations
    cfg.process.thresh_assoc = 0.1
    cfg.process.min_required_picks = 5
    cfg.process.min_required_sta = 3
    base_ctx, _ = tiny_domain(cfg)
    n_sta = cfg.graph.max_sta
    z = np.load(CORR)
    coefs = z["coefs"][:, :n_sta].astype(np.float32)
    jctx, jtrv = _jax_side(cfg, base_ctx, z, coefs)
    tctx, ttrv = _port_side(cfg, base_ctx, z, coefs)

    blob = pickle.loads(MAG.read_bytes())
    grid_cart = blob["grid_cart"]
    tree = load_flax_params(MAG)
    tree["bias"] = tree["bias"][:, :n_sta]
    jmag = JaxMagnitude(n_sta=n_sta, n_grid=len(grid_cart), k=blob["k"])
    mag_params = {"params": jax.tree.map(jnp.asarray, tree)}
    tmag = load_into(MagnitudeModel(n_sta=n_sta, n_grid=len(grid_cart), k=blob["k"]),
                     tree)

    picks = _picks(jctx, jmag, mag_params, grid_cart)
    tmp = tmp_path_factory.mktemp("day")
    pick_file = tmp / "Picks/2017/NC_2017_9_10_ver_1.npz"
    jax_io.save_picks(pick_file, picks[0], picks[1], picks[2], picks[3])

    run6 = load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl")
    params = {"params": jax.tree.map(jnp.asarray, run6)}
    j_events = jax_process_day(cfg, jctx, jtrv, JaxDetector(), params, pick_file,
                               tmp / "jax.hdf5", 0.0, 180.0)
    jpipe = JaxPipeline(JaxDetector(), params, cfg, jctx, jtrv.from_cart,
                        mag_model={"model": jmag, "params": mag_params,
                                   "grid_cart": grid_cart,
                                   "dist_model": blob["dist_model"]})
    j_events = jpipe.assign_magnitudes(j_events, picks[1], picks[3])
    tmag_model = {"model": tmag, "grid_cart": grid_cart, "dist_model": blob["dist_model"]}
    t_events = process_day(cfg, tctx, ttrv, load_into(Detector(), run6), pick_file,
                           tmp / "port.hdf5", 0.0, 180.0, mag_model=tmag_model,
                           device="cpu")
    tpipe = InferencePipeline(load_into(Detector(), run6), cfg, tctx, ttrv.from_cart,
                              mag_model=tmag_model, device="cpu")
    return dict(cfg=cfg, jctx=jctx, tctx=tctx, picks=picks, tmp=tmp, jpipe=jpipe,
                tpipe=tpipe, j_events=j_events, t_events=t_events)


def test_corrected_pinn_grid_tables_match_jax(day):
    np.testing.assert_allclose(day["tctx"].trv_grids.numpy(),
                               np.asarray(day["jctx"].trv_grids), atol=1e-3, rtol=0)


def test_process_day_catalog_matches_jax(day):
    je = sorted(day["j_events"], key=lambda e: e.time)
    te = sorted(day["t_events"], key=lambda e: e.time)
    assert len(je) >= len(PLANTED)
    assert len(te) == len(je)
    for a, b in zip(je, te):
        assert set(b.picks.tolist()) == set(a.picks.tolist())
        assert np.linalg.norm(b.pos_cart - a.pos_cart) < 1e3
        assert abs(b.time - a.time) < 0.2
        assert np.isfinite(b.cov).all()
        assert a.mag is not None and b.mag is not None
        assert abs(b.mag - a.mag) < 0.05
    for node, t_ev, m in PLANTED:
        ev = min(te, key=lambda e: abs(e.time - t_ev))
        assert abs(ev.time - t_ev) < 1.0 and abs(ev.mag - m) < 0.3


def test_process_day_writes_the_catalog_jax_reads(day):
    back = jax_io.load_catalog(day["tmp"] / "port.hdf5")
    te = day["t_events"]
    assert len(back) == len(te)
    for a, b in zip(te, back):
        np.testing.assert_array_equal(b.pos_cart, a.pos_cart)
        assert b.time == a.time and b.mag == a.mag
        np.testing.assert_array_equal(b.picks, a.picks)
    ported = load_catalog(day["tmp"] / "port.hdf5")
    assert [e.mag for e in ported] == [e.mag for e in te]


def test_assign_magnitudes_and_distance_qc_match_jax(day):
    """The same located events through both pipelines' magnitude stage: the
    far picks of the second event fall to the QC in both."""
    pick_t, pick_sta, _, amp = day["picks"]
    sta = day["tctx"].sta_cart.numpy()
    rng = np.random.default_rng(11)
    evs_j, evs_t = [], []
    for i, (node, t_ev, _) in enumerate(PLANTED):
        pos = np.asarray(day["jctx"].grids_cart[0][node], np.float64)
        near = np.where(np.abs(pick_t - t_ev - 15.0) < 15.0)[0]
        if i == 1:     # place it 600 km away: every pick is past the QC distance
            pos = pos + np.array([6e5, 0.0, 0.0])
        phases = rng.integers(0, 2, len(near))
        for evs, cls in ((evs_j, JaxEvent), (evs_t, CatalogEvent)):
            evs.append(cls(pos_cart=pos.copy(), time=t_ev, picks=near.copy(),
                           pick_phases=phases.copy()))
    evs_j = day["jpipe"].assign_magnitudes(evs_j, pick_sta, amp)
    evs_t = day["tpipe"].assign_magnitudes(evs_t, pick_sta, amp)
    assert len(evs_t) == len(evs_j) >= 1
    for a, b in zip(evs_j, evs_t):
        assert set(b.picks.tolist()) == set(a.picks.tolist())
        assert abs(b.mag - a.mag) < 1e-4
    assert len(sta) == 16
    assert day["tpipe"].assign_magnitudes(evs_t, pick_sta, None) is evs_t
