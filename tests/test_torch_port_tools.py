"""The port's leftover tools against the JAX package: ``knn_tiled``,
``spmm`` and its gradients, the axis-mean dispatchers, natural-neighbour
interpolation, the Bayesian optimisation of the generator (``gp_minimize``,
the pick statistics, ``apply_params``, and ``nc_optimize_data.py``'s
objective on the port's generator) and the plots."""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tpu.config import Config as JConfig
from genie_tpu.ops import interp as JI
from genie_tpu.ops import knn as JK
from genie_tpu.ops import segment as JS
from genie_tpu.train import bayes_opt as JB
from genie_tpu_torch.config import Config
from genie_tpu_torch.ops import interp as TI
from genie_tpu_torch.ops import knn as TK
from genie_tpu_torch.ops import segment as TS
from genie_tpu_torch.train import bayes_opt as TB


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread runs them fastest, and with
    several test workers on the machine more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sq_dist(q, c, idx):
    return ((q[:, None, :] - c[idx]) ** 2).sum(-1)


@pytest.mark.parametrize("case", ["plain", "context_mask", "fewer_than_k"])
def test_knn_tiled_matches_jax(case):
    """3,000 queries × 700 context points, tile 256 (two full tiles and a
    ragged one), k 7: indices and valid flags equal to JAX's; with 5
    context points, fewer than k. Where an index differs (a near tie), its
    distance agrees."""
    rng = np.random.default_rng(0)
    n_c = 5 if case == "fewer_than_k" else 700
    xc = rng.uniform(-1.0, 1.0, (n_c, 3)).astype(np.float32)
    xq = rng.uniform(-1.0, 1.0, (3000, 3)).astype(np.float32)
    mask = rng.uniform(size=n_c) > 0.3 if case == "context_mask" else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ji, jv = JK.knn_tiled(jnp.asarray(xc), jnp.asarray(xq), 7, context_mask=jm, tile=256)
    ti, tv = TK.knn_tiled(torch.from_numpy(xc), torch.from_numpy(xq), 7, context_mask=tm,
                          tile=256)
    ji, jv = np.asarray(ji), np.asarray(jv)
    assert ti.dtype == torch.int32 and ti.shape == (3000, 7)
    np.testing.assert_array_equal(tv.numpy(), jv)
    diff = ti.numpy() != ji
    assert diff.mean() < 1e-3
    np.testing.assert_allclose(_sq_dist(xq, xc, ti.numpy())[diff],
                               _sq_dist(xq, xc, ji)[diff], rtol=1e-5, atol=1e-6)
    if case == "fewer_than_k":
        assert tv[:, :5].all() and not tv[:, 5:].any()
        return
    # the untiled search finds the same valid neighbours
    ki, kv = TK.knn(torch.from_numpy(xc), torch.from_numpy(xq), 7, context_mask=tm)
    np.testing.assert_array_equal(kv.numpy(), tv.numpy())
    assert (np.sort(ki.numpy(), 1) == np.sort(ti.numpy(), 1)).mean() > 0.999


def _graph(weighted):
    """60 source rows of width 5 into 40 destinations over 300 edges;
    destination 7 receives nothing."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 60, 300).astype(np.int32)
    dst = rng.integers(0, 40, 300).astype(np.int32)
    dst[dst == 7] = 8
    x = rng.normal(size=(60, 5)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, 300).astype(np.float32) if weighted else None
    return src, dst, x, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_spmm_matches_jax(aggr, weighted):
    src, dst, x, w = _graph(weighted)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    want = np.asarray(JS.spmm(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), 40,
                              edge_weight=jw, aggr=aggr))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TS.spmm(torch.from_numpy(src), torch.from_numpy(dst), xt, 40, edge_weight=tw,
                  aggr=aggr)
    if aggr == "max":
        assert np.isneginf(want[7]).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    if aggr == "max":
        return
    # gradients of a weighted read-out of the product against jax.grad
    r = np.random.default_rng(2).normal(size=(40, 5)).astype(np.float32)

    def jloss(xx, ww):
        out = JS.spmm(jnp.asarray(src), jnp.asarray(dst), xx, 40, edge_weight=ww, aggr=aggr)
        return (out * r).sum()

    args = (jnp.asarray(x), jw)
    jgrads = jax.grad(jloss, argnums=(0, 1) if weighted else 0)(*args)
    jgrads = jgrads if weighted else (jgrads,)
    if weighted:
        tw.requires_grad_(True)
        got = TS.spmm(torch.from_numpy(src), torch.from_numpy(dst), xt, 40,
                      edge_weight=tw, aggr=aggr)
    (got * torch.from_numpy(r)).sum().backward()
    tgrads = (xt.grad, tw.grad) if weighted else (xt.grad,)
    for g, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_spmm_rejects_an_unknown_reduction():
    src, dst, x, _ = _graph(False)
    with pytest.raises(ValueError):
        TS.spmm(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(x), 40,
                aggr="min")


@pytest.mark.parametrize("via_matmul", [False, True])
def test_axis_means_match_jax(via_matmul):
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(9, 11, 4)).astype(np.float32)
    sta_nbr = rng.integers(0, 11, (11, 3)).astype(np.int32)
    src_nbr = rng.integers(0, 9, (9, 5)).astype(np.int32)
    sta_v = rng.uniform(size=(11, 3)) > 0.3
    src_v = rng.uniform(size=(9, 5)) > 0.3
    for valid in (False, True):
        sv = jnp.asarray(sta_v) if valid else None
        rv = jnp.asarray(src_v) if valid else None
        want_sta = JS.mean_sta_axis(jnp.asarray(feat), jnp.asarray(sta_nbr), sv,
                                    via_matmul=via_matmul)
        want_src = JS.mean_src_axis(jnp.asarray(feat), jnp.asarray(src_nbr), rv,
                                    via_matmul=via_matmul)
        got_sta = TS.mean_sta_axis(torch.from_numpy(feat), torch.from_numpy(sta_nbr),
                                   torch.from_numpy(sta_v) if valid else None,
                                   via_matmul=via_matmul)
        got_src = TS.mean_src_axis(torch.from_numpy(feat), torch.from_numpy(src_nbr),
                                   torch.from_numpy(src_v) if valid else None,
                                   via_matmul=via_matmul)
        np.testing.assert_allclose(got_sta.numpy(), np.asarray(want_sta), atol=1e-5)
        np.testing.assert_allclose(got_src.numpy(), np.asarray(want_src), atol=1e-5)


def _interp_cases():
    """The inputs of tests/test_ops.py:192-235, in its draw order:
    (ref, vals, queries, kwargs)."""
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 100.0, (200, 3)).astype(np.float32)
    q = rng.uniform(10, 90, (20, 3)).astype(np.float32)
    cases = [("constant", ref, np.full(200, 3.5), q, {})]
    vals = rng.normal(size=200).astype(np.float32)
    cases.append(("at_nodes", ref, vals, ref[:5], dict(n_res=9)))
    ref2 = np.array([[0, 0, 0], [10, 0, 0]], np.float32)
    cases.append(("midway", ref2, np.array([1.0, 3.0], np.float32),
                  np.array([[5.0, 0, 0]], np.float32), dict(n_res=11, dx=1.0)))
    g = np.stack(np.meshgrid(*[np.linspace(0, 60, 7)] * 3,
                             indexing="ij"), -1).reshape(-1, 3)
    g = (g + rng.normal(0, 1.0, g.shape)).astype(np.float32)
    lin = (0.3 * g[:, 0] - 0.2 * g[:, 1] + 0.1 * g[:, 2]).astype(np.float32)
    q = rng.uniform(15, 45, (30, 3)).astype(np.float32)
    cases.append(("linear", g, lin, q, {}))
    vals_c = rng.normal(size=(200, 4)).astype(np.float32)
    cases.append(("channels", ref, vals_c, q[:4], {}))
    cases.append(("far_outside", ref, vals, np.array([[400.0, 50, 50]], np.float32),
                  dict(dx=0.5)))
    cases.append(("chunked", g, lin, q, dict(query_chunk=16)))
    return cases


@pytest.mark.parametrize("case", [c[0] for c in _interp_cases()])
def test_natural_neighbor_interp_matches_jax(case):
    _, ref, vals, q, kw = next(c for c in _interp_cases() if c[0] == case)
    want = np.asarray(JI.natural_neighbor_interp(ref, vals, q, **kw))
    got = TI.natural_neighbor_interp(ref, vals, q, device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_default_dx_and_offset_cube_equal_jax():
    rng = np.random.default_rng(4)
    ref = rng.uniform(-40e3, 40e3, (1500, 3)).astype(np.float32)
    for n_res in (9, 11):
        assert TI.default_dx(ref, n_res) == pytest.approx(JI.default_dx(ref, n_res),
                                                          rel=1e-6)
        np.testing.assert_array_equal(TI.make_offset_cube(n_res, 250.0),
                                      JI.make_offset_cube(n_res, 250.0))
    assert TI.default_dx(ref[:1]) == JI.default_dx(ref[:1])


def test_gp_minimize_equals_jax_module():
    """tests/test_extras.py:135-152's bowl: the copied minimizer takes the
    same points and values."""
    opt = np.array([0.3, -0.6, 0.1, 0.8])

    def f(x):
        return float(((x - opt) ** 2).sum() + 0.3 * np.sin(3 * x).sum())

    bounds = [(-2.0, 2.0)] * 4
    calls = []
    want = JB.gp_minimize(f, bounds, n_calls=40, n_random_starts=12, seed=3)
    got = TB.gp_minimize(f, bounds, n_calls=40, n_random_starts=12, seed=3,
                         callback=lambda i, x, y: calls.append(i))
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-12)
    assert got[1] == want[1] and calls == list(range(40))
    assert got[1] < 0.5 * min(got[3][:12])


def test_pick_statistics_and_apply_params_equal_jax():
    rng = np.random.default_rng(5)
    sta = rng.uniform(0, 200e3, (24, 3))
    pick_t = np.sort(rng.uniform(0, 7200.0, 3000))
    pick_sta = rng.integers(0, 24, 3000)
    want = JB.pick_statistics(pick_t, pick_sta, sta)
    got = TB.pick_statistics(pick_t, pick_sta, sta)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    targets = [JB.pick_statistics(pick_t[::2], pick_sta[::2], sta, seed=1)]
    assert TB.stats_residual(got, targets) == JB.stats_residual(want, targets)
    assert TB.PARAM_SPACE == JB.PARAM_SPACE
    x = np.array([(lo + hi) / 2 for _, lo, hi in TB.PARAM_SPACE]) * 1.01
    jc, tc = JConfig(), Config()
    JB.apply_params(jc.synth, x)
    TB.apply_params(tc.synth, x)
    assert tc.to_dict()["synth"] == jc.to_dict()["synth"]
    assert tc.synth.dist_range[0] == pytest.approx(x[4])


def test_optimize_data_objective_runs_the_generator():
    """``nc_optimize_data.py``'s objective on the port's generator (tiny
    domain, T 600 s): finite residuals, 0 against its own statistics'
    source, and the loop of the script (GP-EI over PARAM_SPACE) runs."""
    from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
    from genie_tpu_torch.geometry import Projection
    from genie_tpu_torch.train.trainer import build_domain_context
    from genie_tpu_torch.workflow import optimize_data_objective, synthetic_pick_statistics

    from tests.test_trainer import tiny_config

    cfg = Config.from_dict(tiny_config().to_dict())
    rng = np.random.default_rng(0)
    sta = rng.uniform(-60e3, 60e3, (16, 3)).astype(np.float32)
    grids = rng.uniform(-80e3, 80e3, (2, 50, 3)).astype(np.float32)
    grids[..., 2] = rng.uniform(-40e3, 2e3, (2, 50))
    trv = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    tt = torch.stack([trv.from_cart(torch.from_numpy(sta), torch.from_numpy(g))
                      for g in grids])
    ctx = build_domain_context(cfg, sta, sta, grids, grids, tt, "cpu")
    gen = torch.Generator().manual_seed(0)
    targets = [synthetic_pick_statistics(cfg, ctx, trv.from_cart, gen) for _ in range(2)]
    assert [t.shape for t in targets[0]] == [(5,), (15,)]
    assert TB.stats_residual(targets[0], targets[:1]) == 0.0
    obj = optimize_data_objective(cfg, ctx, trv.from_cart, targets, gen)
    x_best, y_best, X, Y = TB.gp_minimize(obj, [(p[1], p[2]) for p in TB.PARAM_SPACE],
                                          n_calls=4, n_random_starts=3)
    assert np.isfinite(Y).all() and y_best == Y.min() and X.shape == (4, 10)
    assert cfg.synth.coda_win[1] == pytest.approx(X[-1][3])


needs_matplotlib = pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                                      reason="matplotlib is not installed")


@needs_matplotlib
def test_plots_write_pngs(tmp_path):
    from genie_tpu_torch.viz import plot_catalog_day, visualize_predictions

    rng = np.random.default_rng(0)
    det = rng.uniform(-50e3, 50e3, (12, 4))
    det[:, 3] = rng.uniform(0, 86400, 12)
    usgs = rng.uniform(-50e3, 50e3, (8, 4))
    usgs[:, 3] = rng.uniform(0, 86400, 8)
    p = plot_catalog_day(tmp_path / "day.png", det, usgs, det_mags=rng.uniform(1, 4, 12),
                         usgs_mags=rng.uniform(1, 4, 8), title="test day")
    assert p.exists() and p.stat().st_size > 10_000
    grid = rng.uniform(-50e3, 50e3, (60, 3))
    lbl, pred = rng.uniform(size=(60, 5)), rng.uniform(size=(60, 5))
    xq = rng.uniform(-50e3, 50e3, (30, 3))
    p = visualize_predictions(tmp_path / "plots", 7, grid, lbl, pred, x_query=xq,
                              lbl_query=rng.uniform(size=(30, 5)),
                              pred_query=rng.uniform(size=(30, 5)),
                              arv_p=rng.uniform(size=(10, 20)),
                              lbl_p=rng.uniform(size=(10, 20)))
    assert p.exists() and p.stat().st_size > 10_000
