"""The port's synthetic-data generator against the JAX package's, on the tiny
domain of tests/test_trainer.py.

The deterministic pieces are held element by element to the JAX functions
on JAX's own draws: the smooth rate, inverse-CDF times, the surface
elevation, the Gaussian labels and everything ``window_from_draws`` derives
from a JAX timeline and the draws a JAX ``WindowBatch`` records (picks
compared where ``pick_mask`` holds, station neighbour tables as sets). The
random pieces draw from a ``torch.Generator``, so they are held to JAX in
distribution: means over 64 seeds of each generator within 3 standard
errors. The mechanism tests of tests/test_trainer.py have port twins."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.synth import generator as jgen
from genie_tpu.train.trainer import _corr_chol as jax_corr_chol
from genie_tpu.train.trainer import generate_batch as jax_generate_batch
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.synth import generator as tgen
from genie_tpu_torch.train.trainer import (_corr_chol, build_domain_context,
                                           build_training_dataset, generate_batch,
                                           load_training_batch)

from tests.test_trainer import tiny_config, tiny_domain

N_SEEDS = 64


def T(a):
    return torch.as_tensor(np.array(a))


def port_config(jcfg) -> Config:
    return Config.from_dict(jcfg.to_dict())


def port_ctx(cfg, jctx, **kw):
    return build_domain_context(cfg, np.asarray(jctx.sta_lla), np.asarray(jctx.sta_cart),
                                np.asarray(jctx.grids_lla), np.asarray(jctx.grids_cart),
                                np.asarray(jctx.trv_grids), "cpu", **kw)


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config()
    jctx, jtt = tiny_domain(jcfg)
    cfg = port_config(jcfg)
    ctx = port_ctx(cfg, jctx)
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    return dict(jcfg=jcfg, jctx=jctx, jtt=jtt, cfg=cfg, ctx=ctx, tt=tt)


def _timeline_args(ctx):
    return (ctx.sta_cart, ctx.scale_cart, ctx.offset_cart,
            (ctx.offset_cart[2], ctx.offset_cart[2] + ctx.scale_cart[2]))


def _port_timeline(cfg, ctx, tt, seed, **kw):
    sta, scale, offset, depth = _timeline_args(ctx)
    gen = torch.Generator().manual_seed(seed)
    return tgen.synthesize_timeline(gen, cfg.synth, sta, tt.from_cart, scale, offset,
                                    depth, n_sta_real=sta.shape[0], **kw)


def _jax_timeline(jcfg, jctx, jtt, seed, key=None, **kw):
    sta, scale, offset, depth = _timeline_args(jctx)
    return jgen.synthesize_timeline(jax.random.PRNGKey(seed) if key is None else key,
                                    jcfg.synth, sta, jtt.from_cart, scale, offset, depth,
                                    n_sta_real=sta.shape[0], **kw)


# -- deterministic pieces, element by element ----------------------------------

def test_smooth_rate_and_times_match_jax():
    key = jax.random.PRNGKey(3)
    for n_bins, tscale in ((120, 120.0), (16, 4.0), (37, 0.5)):
        want = np.asarray(jgen.smooth_rate(key, n_bins, tscale))
        noise = T(jax.random.normal(key, (n_bins,)))
        got = tgen.smooth_rate_from_noise(noise, tscale).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    rate = jgen.smooth_rate(key, 120, 120.0)
    k2 = jax.random.PRNGKey(11)
    want = np.asarray(jgen._sample_times_from_rate(k2, rate, 500, 3600.0))
    u = T(jax.random.uniform(k2, (500,)))
    u_bin = T(jax.random.uniform(jax.random.fold_in(k2, 1), (500,)))
    got = tgen.times_from_rate(T(rate), u, u_bin, 3600.0).numpy()
    # the same bin for all but draws within f32 rounding of a bin edge
    assert np.mean(np.abs(got - want) < 1e-3) > 0.99
    assert np.all(np.abs(got - want) <= 3600.0 / 120 + 1e-3)


def test_surface_elevation_and_gauss_labels_match_jax():
    rng = np.random.default_rng(0)
    elev = rng.uniform(-500, 2500, (9, 7)).astype(np.float32)
    lo, h = np.array([-50e3, -40e3], np.float32), np.array([12e3, 14e3], np.float32)
    xy = rng.uniform(-70e3, 80e3, (50, 2)).astype(np.float32)   # some outside
    want = jgen.surface_elevation((jnp.asarray(elev), jnp.asarray(lo), jnp.asarray(h)),
                                  jnp.asarray(xy))
    got = tgen.surface_elevation((T(elev), T(lo), T(h)), T(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-2)

    pos = rng.uniform(-60e3, 60e3, (30, 3)).astype(np.float32)
    ev = rng.uniform(-60e3, 60e3, (6, 3)).astype(np.float32)
    ev_t = rng.uniform(0, 20, 6).astype(np.float32)
    act = np.array([1, 0, 1, 1, 0, 1], bool)
    t_abs = np.linspace(5.0, 15.0, 9).astype(np.float32)
    args = (15e3, 10e3, 3.0)
    want = jgen._gauss_labels(jnp.asarray(pos), jnp.asarray(t_abs), jnp.asarray(ev),
                              jnp.asarray(ev_t), jnp.asarray(act), *args)
    got = tgen._gauss_labels(T(pos), T(t_abs), T(ev), T(ev_t), T(act), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # a leading window axis: each window with its own times and active set
    got_b = tgen._gauss_labels(T(np.stack([pos, pos])), T(np.stack([t_abs, t_abs + 3])),
                               T(ev), T(ev_t), T(np.stack([act, ~act])), *args)
    want_b = jgen._gauss_labels(jnp.asarray(pos), jnp.asarray(t_abs + 3), jnp.asarray(ev),
                                jnp.asarray(ev_t), jnp.asarray(~act), *args)
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_b[1].numpy(), np.asarray(want_b), atol=1e-6)


def _rows_as_sets(nbr, valid):
    n = np.where(valid, nbr, -1)
    return [set(r.tolist()) for r in n.reshape(-1, n.shape[-1])]


@pytest.fixture(scope="module")
def jax_windows(setup):
    """Jitted JAX timeline + six windows of a seed."""
    jcfg, jctx, jtt = setup["jcfg"], setup["jctx"], setup["jtt"]
    wcfg = tiny_config()
    wcfg.train.n_batch = 6

    @jax.jit
    def run(key):
        tl = _jax_timeline(jcfg, jctx, jtt, 0, key=key)
        return tl, jgen.make_windows(jax.random.fold_in(key, 100), wcfg.synth, wcfg.train,
                                     wcfg.graph, tl, jctx.sta_cart, jctx.grids_cart,
                                     jctx.trv_grids, jctx.scale_cart, jctx.offset_cart,
                                     t_win=wcfg.model.t_win)

    return run


@pytest.mark.parametrize("seed", [0, 7, 8])
def test_window_from_draws_matches_jax(setup, jax_windows, seed):
    """Every field of a JAX WindowBatch, recomputed by the port from the
    JAX timeline and the draws that batch records."""
    s = setup
    jtl, jwb = jax_windows(jax.random.PRNGKey(seed))
    tl = tgen.Timeline(*[T(a) for a in jtl])
    ctx, cfg = s["ctx"], s["cfg"]
    wb = tgen.window_from_draws(
        cfg.synth, cfg.train, cfg.graph, tl, ctx.sta_cart, ctx.grids_cart, ctx.trv_grids,
        T(jwb.t_sample), T(jwb.grid_idx), T(jwb.sta_mask), T(jwb.x_query), T(jwb.x_qsrc),
        T(jwb.tq_sample), t_win=cfg.model.t_win)
    j = {f: np.asarray(getattr(jwb, f)) for f in jwb._fields}
    g = {f: getattr(wb, f).numpy() for f in wb._fields}
    np.testing.assert_array_equal(g["pick_mask"], j["pick_mask"])
    pm = j["pick_mask"]
    assert pm.sum() > 20                       # the windows do hold picks
    np.testing.assert_allclose(g["tpick"][pm], j["tpick"][pm], atol=1e-4)
    np.testing.assert_array_equal(g["ipick"][pm], j["ipick"][pm])
    np.testing.assert_array_equal(g["phase"][pm], j["phase"][pm])
    # jit fuses JAX's sort-key arithmetic (pick time + station offset), which
    # moves a key by up to an f32 ulp: 4e-3 s at 16 stations, 5e-5 in a feature
    np.testing.assert_allclose(g["feat"], j["feat"], atol=1e-4)
    np.testing.assert_array_equal(g["mask"], j["mask"])
    for f in ("lbl_grid", "lbl_query", "lbl_assoc"):
        np.testing.assert_allclose(g[f], j[f], atol=1e-5, err_msg=f)
    assert j["lbl_query"].max() > 0.5          # some window has an active event
    for f in ("sta_mask", "grid_idx", "t_sample", "x_query", "x_qsrc", "tq_sample"):
        np.testing.assert_array_equal(g[f], j[f], err_msg=f)
    np.testing.assert_array_equal(g["sta_nbr_valid"], j["sta_nbr_valid"])
    assert (_rows_as_sets(g["sta_nbr"], g["sta_nbr_valid"])
            == _rows_as_sets(j["sta_nbr"], j["sta_nbr_valid"]))


# -- distributions over seeds ---------------------------------------------------

def _timeline_stats(ev_mask, pick_mask, pick_event, pick_phase, n_slots):
    """Per timeline: events, true / coda / false picks and the flipped
    fraction of true + coda picks (their pre-flip phase is the slot's)."""
    struct_ph = np.tile(np.arange(2), n_slots // 2)
    out = []
    for em, m, ev, ph in zip(ev_mask, pick_mask, pick_event, pick_phase):
        tc = m[:2 * n_slots]
        flipped = (ph[:2 * n_slots] != np.tile(struct_ph, 2))[tc]
        out.append([em.sum(), (m[:n_slots]).sum(), (m[n_slots:2 * n_slots]).sum(),
                    m[2 * n_slots:].sum(), flipped.mean() if flipped.size else np.nan])
    return np.asarray(out, np.float64)


def _window_stats(pick_mask, lbl_grid, lbl_query):
    """Per window: picks, an active event (a query label near 1: the exact
    rows), grid and query label maxima."""
    return np.stack((pick_mask.sum(-1), lbl_query.max(axis=(-1, -2)) > 0.5,
                     lbl_grid.max(axis=(-1, -2)), lbl_query.max(axis=(-1, -2))),
                    axis=-1).astype(np.float64).reshape(-1, 4)


def _agree(a, b, names):
    for k, name in enumerate(names):
        x, y = a[:, k], b[:, k]
        x, y = x[np.isfinite(x)], y[np.isfinite(y)]
        se = np.sqrt(x.var(ddof=1) / len(x) + y.var(ddof=1) / len(y))
        assert abs(x.mean() - y.mean()) <= 3.0 * se + 1e-9, (
            name, x.mean(), y.mean(), se)


def test_distributions_match_jax_over_seeds(setup):
    s = setup
    jcfg, jctx, jtt, cfg, ctx, tt = (s[k] for k in ("jcfg", "jctx", "jtt", "cfg", "ctx",
                                                   "tt"))
    n_slots = 2 * cfg.synth.max_events * ctx.sta_cart.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(1), N_SEEDS)
    jtl = jax.jit(jax.vmap(lambda k: jgen.synthesize_timeline(
        k, jcfg.synth, jctx.sta_cart, jtt.from_cart, jctx.scale_cart, jctx.offset_cart,
        (jctx.offset_cart[2], jctx.offset_cart[2] + jctx.scale_cart[2]),
        n_sta_real=jctx.sta_cart.shape[0])))(keys)
    jstats = _timeline_stats(*(np.asarray(getattr(jtl, f)) for f in (
        "ev_mask", "pick_mask", "pick_event", "pick_phase")), n_slots)
    tls = [_port_timeline(cfg, ctx, tt, 1000 + i) for i in range(N_SEEDS)]
    tstats = _timeline_stats(*(np.stack([getattr(tl, f).numpy() for tl in tls]) for f in (
        "ev_mask", "pick_mask", "pick_event", "pick_phase")), n_slots)
    _agree(tstats, jstats, ("events", "true picks", "coda picks", "false picks",
                            "flip fraction"))

    jwb = jax.jit(jax.vmap(lambda k: jax_generate_batch(k, jcfg, jctx, jtt.from_cart)))(
        keys)
    jw = _window_stats(*(np.asarray(getattr(jwb, f)) for f in (
        "pick_mask", "lbl_grid", "lbl_query")))
    gen = torch.Generator()
    wbs = [generate_batch(gen.manual_seed(2000 + i), cfg, ctx, tt.from_cart)
           for i in range(N_SEEDS)]
    tw = _window_stats(*(np.stack([getattr(wb, f).numpy() for wb in wbs]) for f in (
        "pick_mask", "lbl_grid", "lbl_query")))
    _agree(tw, jw, ("picks per window", "active share", "grid label max",
                    "query label max"))
    assert 0.2 < tw[:, 1].mean() < 1.0


# -- mechanism twins of tests/test_trainer.py ------------------------------------

def test_generate_batch_shapes(setup):
    cfg, ctx, tt = setup["cfg"], setup["ctx"], setup["tt"]
    wb = generate_batch(torch.Generator().manual_seed(0), cfg, ctx, tt.from_cart)
    B, n_src, n_sta = cfg.train.n_batch, 50, 16
    assert wb.feat.shape == (B, n_src, n_sta, 4)
    assert wb.tpick.shape == (B, cfg.graph.max_picks)
    assert wb.lbl_grid.shape == (B, n_src, 9)
    assert wb.lbl_query.shape == (B, cfg.train.n_spc_query, 9)
    assert wb.lbl_assoc.shape == (B, cfg.train.n_src_query, cfg.graph.max_picks, 2)
    assert wb.sta_nbr.shape == (B, n_sta, cfg.graph.k_sta_edges)
    for f in wb._fields:
        assert torch.isfinite(getattr(wb, f).float()).all(), f
    assert float(wb.feat.max()) > 0.5
    assert 0.0 <= float(wb.lbl_grid.min()) and float(wb.lbl_grid.max()) <= 1.0 + 1e-5


def test_fixed_subnetworks_used_in_windows(setup):
    cfg, ctx, tt = setup["cfg"], setup["ctx"], setup["tt"]
    n_sta = ctx.sta_cart.shape[0]
    subnet = np.zeros((2, n_sta), bool)
    subnet[0, :5] = True
    subnet[1, 5:10] = True
    tl = _port_timeline(cfg, ctx, tt, 0)
    tcfg = Config.from_dict(cfg.to_dict()).train
    tcfg.n_batch = 8
    wb = tgen.make_windows(torch.Generator().manual_seed(5), cfg.synth, tcfg, cfg.graph,
                           tl, ctx.sta_cart, ctx.grids_cart, ctx.trv_grids,
                           ctx.scale_cart, ctx.offset_cart, subnetworks=T(subnet))
    masks = wb.sta_mask.numpy()
    assert any((masks[i] == subnet[j]).all() for i in range(8) for j in range(2))
    # a kept station's neighbours are kept stations
    nbr, valid = wb.sta_nbr.numpy(), wb.sta_nbr_valid.numpy()
    for i in range(8):
        assert masks[i][nbr[i][valid[i]]].all()


def test_reference_density_event_sampling(setup):
    cfg = port_config(tiny_config())
    cfg.synth.use_reference_spatial_density = True
    cfg.synth.frac_reference_catalog = 1.0
    cfg.synth.spatial_sigma = 500.0
    ctx, tt = setup["ctx"], setup["tt"]
    ref = T(np.array([[30e3, -20e3, -8e3]], np.float32))
    tl = _port_timeline(cfg, ctx, tt, 3, ref_srcs_cart=ref)
    ev = tl.ev_pos_cart.numpy()[tl.ev_mask.numpy()]
    assert len(ev) > 0
    assert np.all(np.linalg.norm(ev[:, :2] - ref.numpy()[0, :2], axis=1) < 5e3)


def test_correlated_travel_time_noise():
    """Co-located stations get near-identical arrival residuals under a long
    correlation length; independent Laplace noise does not."""
    cfg = port_config(tiny_config())
    cfg.synth.max_rate_events = 16.0
    n_sta = cfg.graph.max_sta
    sta = np.tile(np.array([[10e3, 5e3, 0.0]], np.float32), (n_sta, 1))
    sta += np.random.default_rng(0).normal(0, 10.0, sta.shape).astype(np.float32)
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    scale = T(np.array([160e3, 160e3, 40e3], np.float32))
    offset = T(np.array([-80e3, -80e3, -40e3], np.float32))
    cfg.synth.corr_noise_params = (0.05, 0.0, 0.01, 0.01, 1e9, 0.0, 0.0)
    L = _corr_chol(cfg, sta)
    assert np.allclose(L.numpy()[:, 0], 1.0, atol=1e-2)
    jcfg = tiny_config()
    jcfg.synth.corr_noise_params = cfg.synth.corr_noise_params
    np.testing.assert_allclose(L.numpy(), np.asarray(jax_corr_chol(jcfg, sta)), atol=1e-6)

    def spread(corr_chol, use):
        cfg.synth.use_correlated_noise = use
        tl = tgen.synthesize_timeline(torch.Generator().manual_seed(2), cfg.synth, T(sta),
                                      tt.from_cart, scale, offset,
                                      (offset[2], offset[2] + scale[2]), n_sta_real=n_sta,
                                      corr_chol=corr_chol)
        t, evi, ph = tl.pick_t.numpy(), tl.pick_event.numpy(), tl.pick_phase.numpy()
        m = tl.pick_mask.numpy() & (evi >= 0) & tl.pick_assoc_ok.numpy()
        outs = [np.std(t[m & (evi == e) & (ph == p)]) for e in np.unique(evi[m])
                for p in (0, 1) if (m & (evi == e) & (ph == p)).sum() >= 6]
        return np.median(outs)

    assert spread(L, True) < 0.35 * spread(None, False)


def test_preferential_sampling_gates_on_detectable_events(setup):
    """Preferential windows (half of them) target only events whose picks
    pass the min_sta/min_pick gate, centred on them; a pickless event only
    ever gets the uniform windows' share."""
    cfg = port_config(tiny_config())
    cfg.train.n_batch = 64
    cfg.synth.n_sta_range = (1.0, 1.0)
    ctx, tt = setup["ctx"], setup["tt"]
    E, N, n_pk = 2, 64, 12
    ev_pos = np.zeros((E, 3), np.float32)
    ev_pos[:, 2] = -8e3
    ev_time = np.array([400.0, 150.0], np.float32)
    trv = tt.from_cart(ctx.sta_cart, T(ev_pos)).numpy()
    pick_t = np.zeros(N, np.float32)
    pick_sta = np.zeros(N, np.int32)
    pick_event = np.full(N, -1, np.int32)
    pick_mask = np.zeros(N, bool)
    pick_t[:n_pk] = ev_time[0] + trv[0, :n_pk, 0]
    pick_sta[:n_pk] = np.arange(n_pk)
    pick_event[:n_pk] = 0
    pick_mask[:n_pk] = True
    tl = tgen.Timeline(T(ev_pos), T(ev_time), torch.zeros(E), T([True, True]), T(pick_t),
                       T(pick_sta), torch.zeros(N, dtype=torch.int32), T(pick_event),
                       T(pick_mask), T(pick_mask))
    wb = tgen.make_windows(torch.Generator().manual_seed(3), cfg.synth, cfg.train,
                           cfg.graph, tl, ctx.sta_cart, ctx.grids_cart, ctx.trv_grids,
                           ctx.scale_cart, ctx.offset_cart, t_win=cfg.model.t_win)
    t0s = wb.t_sample.numpy()
    lbl_max = wb.lbl_grid.numpy().max(axis=(1, 2))
    near_a = np.abs(t0s - ev_time[0]) < 6.0
    near_b = np.abs(t0s - ev_time[1]) < 6.0
    # 32 preferential windows expected near event 0; uniform windows land
    # within 6 s of a given time with probability 12/590
    assert near_a.sum() >= 20, t0s
    assert near_b.sum() <= 3, t0s
    assert lbl_max[near_a].max() > 0.5
    # the event is active in the targeted windows: exact query rows sit on it
    xq = wb.x_query.numpy()
    assert np.allclose(xq[near_a][:, 0], ev_pos[0])


def test_clean_data_interval_carves_false_picks(setup):
    def run(enabled):
        cfg = port_config(tiny_config())
        cfg.synth.use_clean_data_interval = enabled
        cfg.synth.clean_interval_frac = (0.5, 0.5)
        cfg.synth.coda_rate = 0.0
        cfg.synth.max_rate_events = 200.0
        tl = _port_timeline(cfg, setup["ctx"], setup["tt"], 0)
        return tl.pick_t.numpy()[tl.pick_mask.numpy() & (tl.pick_event.numpy() == -1)]

    t_off, t_on = run(False), run(True)
    assert len(t_on) > 0
    assert len(t_on) < 0.8 * len(t_off)


def test_other_timeline_branches_run(setup):
    """Shallow sources, no aftershocks, the surface clamp, s_extra, no
    stable labels, no spikes: finite timelines that obey each option."""
    cfg = port_config(tiny_config())
    cfg.synth.use_shallow_sources = True
    cfg.synth.use_aftershocks = False
    cfg.synth.s_extra = 1.0                    # every S arrival dropped
    cfg.synth.use_stable_association_labels = False
    cfg.synth.max_num_spikes = 0
    cfg.synth.coda_rate = 0.0
    ctx, tt = setup["ctx"], setup["tt"]
    elev = torch.full((4, 4), -5e3)            # surface 5 km below sea level
    surface = (elev, ctx.offset_cart[:2], ctx.scale_cart[:2] / 3)
    tl = _port_timeline(cfg, ctx, tt, 7, surface=surface)
    for f in tl._fields:
        assert torch.isfinite(tl[tl._fields.index(f)].float()).all(), f
    ev = tl.ev_pos_cart.numpy()[tl.ev_mask.numpy()]
    assert len(ev) > 0 and (ev[:, 2] <= -5e3 + 1e-3).all()
    n_slots = 2 * cfg.synth.max_events * ctx.sta_cart.shape[0]
    true_m = tl.pick_mask.numpy()[:n_slots]
    assert true_m.sum() > 0 and not true_m.reshape(-1, 2)[:, 1].any()
    assert (tl.pick_assoc_ok.numpy()[:n_slots] == true_m).all()


def test_dataset_roundtrip(setup, tmp_path):
    """Two interleaved jobs write disjoint stripes atomically, a rerun
    rewrites nothing, the loader restores the generated batch exactly, and
    a batch the JAX package wrote loads too."""
    from genie_tpu.train.trainer import build_training_dataset as jax_build

    cfg, ctx, tt = setup["cfg"], setup["ctx"], setup["tt"]
    w0 = build_training_dataset(cfg, ctx, tt.from_cart, tmp_path, 4, seed=7, job=0,
                                n_jobs=2)
    w1 = build_training_dataset(cfg, ctx, tt.from_cart, tmp_path, 4, seed=7, job=1,
                                n_jobs=2)
    assert sorted(p.name for p in (*w0, *w1)) == [f"training_batch_{i}.npz"
                                                  for i in range(4)]
    mtime = w0[0].stat().st_mtime_ns
    again = build_training_dataset(cfg, ctx, tt.from_cart, tmp_path, 4, seed=7, job=0,
                                   n_jobs=2)
    assert again == w0 and w0[0].stat().st_mtime_ns == mtime
    assert not list(tmp_path.glob(".tmp*"))
    from genie_tpu_torch.train.trainer import step_seed

    wb = load_training_batch(tmp_path / "training_batch_2.npz", "cpu")
    fresh = generate_batch(torch.Generator().manual_seed(step_seed(7, 2)), cfg, ctx,
                           tt.from_cart)
    for f in wb._fields:
        np.testing.assert_array_equal(getattr(wb, f).numpy(), getattr(fresh, f).numpy(), f)
        assert getattr(wb, f).dtype == getattr(fresh, f).dtype, f

    jdir = tmp_path / "jax"
    jax_build(setup["jcfg"], setup["jctx"], setup["jtt"].from_cart, jdir, 1, seed=3)
    jwb = load_training_batch(jdir / "training_batch_0.npz", "cpu")
    z = np.load(jdir / "training_batch_0.npz")
    for f in jwb._fields:
        np.testing.assert_array_equal(getattr(jwb, f).numpy(), z[f], f)
        assert getattr(jwb, f).dtype == getattr(fresh, f).dtype, f
