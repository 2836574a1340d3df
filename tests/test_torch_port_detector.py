"""The port's detector, featurizers, graph tables, geometry and travel times
against the JAX package, with the checked-in run6 weights on the tiny
synthetic domain of tests/test_trainer.py.

The detector is compared on identical graph tables (built by the JAX
package); the port's own tables are compared as sets, since
``torch.topk`` and ``jax.lax.top_k`` may order ties differently. Tolerance
of the composed forward: atol 2e-4 / rtol 1e-4, the JAX↔torch chain
tolerance of tests/test_torch_parity_full.py."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.geometry import Projection as JaxProjection
from genie_tpu.graphs.build import (build_pair_table as jax_pair_table,
                                    build_query_attachment as jax_attach,
                                    build_station_graph as jax_station_graph,
                                    build_time_pointers as jax_time_pointers)
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.models.detector import GraphBundle as JaxGraph
from genie_tpu.models.detector import PickSet as JaxPicks
from genie_tpu.models.detector import QuerySet as JaxQueries
from genie_tpu.models.travel_time import GridTravelTime as JaxGridTT
from genie_tpu.synth.generator import featurize_window as jax_featurize
from genie_tpu.synth.generator import featurize_window_rasterized as jax_raster
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.graphs.build import (build_pair_table, build_query_attachment,
                                          build_station_graph, build_time_pointers)
from genie_tpu_torch.models.detector import Detector, GraphBundle, PickSet, QuerySet
from genie_tpu_torch.models.travel_time import GridTravelTime, HomogeneousTravelTime
from genie_tpu_torch.params import load_flax_params, load_into
from genie_tpu_torch.synth.generator import (featurize_window,
                                             featurize_window_rasterized)
from genie_tpu_torch.train.trainer import build_domain_context

from tests.test_trainer import tiny_config, tiny_domain

ROOT = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-4, 1e-4


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    ctx, tt = tiny_domain(cfg)
    tree = load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl")
    jparams = {"params": jax.tree.map(jnp.asarray, tree)}
    model = load_into(Detector(src_chunk=4), tree).eval()
    rng = np.random.default_rng(5)
    n_sta, n_pick = ctx.sta_cart.shape[0], cfg.graph.max_picks
    trv0 = np.asarray(ctx.trv_grids[0])
    # one planted event at grid node 7 plus clutter, some padded slots
    tp = np.concatenate((20.0 + trv0[7, :, 0] + rng.normal(0, 0.1, n_sta),
                         20.0 + trv0[7, :, 1] + rng.normal(0, 0.1, n_sta),
                         rng.uniform(0, 60, n_pick - 2 * n_sta))).astype(np.float32)
    ip = np.concatenate((np.arange(n_sta), np.arange(n_sta),
                         rng.integers(0, n_sta, n_pick - 2 * n_sta))).astype(np.int32)
    ph = np.concatenate((np.zeros(n_sta), np.ones(n_sta),
                         rng.integers(0, 2, n_pick - 2 * n_sta)))[:, None].astype(np.float32)
    pm = np.ones(n_pick, bool)
    pm[-6:] = False
    order = np.lexsort((tp, ip))
    tp, ip, ph = tp[order], ip[order], ph[order]
    sta_mask = np.ones(n_sta, bool)
    sta_mask[[2, 9]] = False
    max_t = float(trv0.max())
    kw = dict(t_lo=-10.0, t_hi=cfg.model.t_win + max_t + 10.0)
    feat, fmask = jax_raster(*map(jnp.asarray, (tp, ip, ph, pm)), ctx.trv_grids[0],
                             3.0, jnp.asarray(sta_mask), **kw)
    sn, sv = jax_station_graph(ctx.sta_cart, cfg.graph.k_sta_edges, jnp.asarray(sta_mask))
    jg = JaxGraph(sn, sv, ctx.src_nbr[0], jnp.asarray(sta_mask), ctx.edge_feat[0],
                  ctx.grids_cart[0], ctx.time_ptr_p[0], ctx.time_ptr_s[0],
                  jnp.float32(ctx.dt0), jnp.float32(ctx.dt), ctx.trv_grids[0])
    tg = GraphBundle(*[T(a) for a in jg])
    xq = np.asarray(ctx.grids_cart[0][:9]) + rng.normal(0, 3e3, (9, 3)).astype(np.float32)
    xq_idx = jax_attach(ctx.grids_cart[0], jnp.asarray(xq), k=cfg.graph.k_spatial_attn)
    t_query = jnp.linspace(-5.0, 5.0, 9)[:, None]
    return dict(cfg=cfg, ctx=ctx, tt=tt, tree=tree, jparams=jparams, model=model,
                picks=(tp, ip, ph, pm), sta_mask=sta_mask, feat=feat, fmask=fmask,
                jg=jg, tg=tg, xq=xq, xq_idx=xq_idx, t_query=t_query, kw=kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_forward_detection_only_matches_jax(setup):
    s = setup
    jm = JaxDetector(src_chunk=4)
    jy, jx = jm.apply(s["jparams"], s["feat"], s["fmask"], s["jg"], s["ctx"].sta_cart,
                      jnp.asarray(s["xq"]), s["xq_idx"], s["t_query"],
                      method=JaxDetector.forward_detection_only)
    with torch.no_grad():
        y, x = s["model"].forward_detection_only(
            T(s["feat"])[None], T(s["fmask"])[None], s["tg"], T(s["ctx"].sta_cart),
            T(s["xq"]), T(s["xq_idx"]), T(s["t_query"]))
    _close(y[0], jy)
    _close(x[0], jx)
    assert float(jnp.abs(jy).max()) > 1e-3  # the weights do produce output


def test_trunk_and_query_head_match_jax(setup):
    s = setup
    jm = JaxDetector(src_chunk=4)
    jxs, jyl = jm.apply(s["jparams"], s["feat"], s["fmask"], s["jg"], s["ctx"].sta_cart,
                        method=JaxDetector.forward_trunk)
    jq = jm.apply(s["jparams"], jxs, s["jg"], jnp.asarray(s["xq"]), s["xq_idx"],
                  s["t_query"], method=JaxDetector.forward_query_head)
    with torch.no_grad():
        xs, yl = s["model"].forward_trunk(T(s["feat"])[None], T(s["fmask"])[None],
                                          s["tg"], T(s["ctx"].sta_cart))
        q = s["model"].forward_query_head(xs, s["tg"], T(s["xq"]), T(s["xq_idx"]),
                                          T(s["t_query"]))
    _close(xs[0], jxs)
    _close(yl[0], jyl)
    _close(q[0], jq)


def test_full_forward_matches_jax(setup):
    """(y, x, arv_p, arv_s) of Detector.__call__; three association query
    sources (JAX pads them to its src_chunk; the real rows must match)."""
    s = setup
    cfg, ctx = s["cfg"], s["ctx"]
    tp, ip, ph, pm = map(jnp.asarray, s["picks"])
    pair_idx, pair_valid = jax_pair_table(tp, ip, pm, k_pair=cfg.graph.k_pick_pairs)
    xqs = jnp.asarray(s["xq"][:3])
    xqs_idx = s["xq_idx"][:3]
    tq = jnp.asarray([0.0, 2.5, 6.0], jnp.float32)
    trv_q = s["tt"].from_cart(ctx.sta_cart, xqs)
    jm = JaxDetector(src_chunk=4)
    jout = jm.apply(s["jparams"], s["feat"], s["fmask"], s["jg"], ctx.sta_cart,
                    JaxPicks(tp, ip, ph, pm, pair_idx, pair_valid),
                    JaxQueries(jnp.asarray(s["xq"]), s["xq_idx"], s["t_query"], xqs,
                               xqs_idx, tq, trv_q))
    picks = PickSet(*[T(a)[None] for a in (tp, ip, ph, pm, pair_idx, pair_valid)])
    queries = QuerySet(T(s["xq"]), T(s["xq_idx"]), T(s["t_query"]), T(xqs)[None],
                       T(xqs_idx)[None], T(tq)[None], T(trv_q)[None])
    with torch.no_grad():
        out = s["model"](T(s["feat"])[None], T(s["fmask"])[None], s["tg"],
                         T(ctx.sta_cart), picks, queries)
    for got, want in zip(out, jout):
        _close(got[0], want)
    assert float(jnp.abs(jout[2]).max()) > 1e-3


@pytest.mark.parametrize("kind", ["rasterized", "searchsorted"])
def test_featurizers_match_jax(setup, kind):
    s = setup
    ctx = s["ctx"]
    tp, ip, ph, pm = s["picks"]
    # a second window: shifted picks, one phase class only
    tp2, ph2 = tp + 7.3, np.zeros_like(ph)
    wins = [(tp, ip, ph, pm), (tp2, ip, ph2, pm)]
    for g in range(ctx.trv_grids.shape[0]):
        trv = ctx.trv_grids[g]
        want = []
        for w in wins:
            args = (*map(jnp.asarray, w), trv, 3.0, jnp.asarray(s["sta_mask"]))
            want.append(jax_raster(*args, **s["kw"]) if kind == "rasterized"
                        else jax_featurize(*args))
        batch = [T(np.stack([w[i] for w in wins])) for i in range(4)]
        targs = (*batch, T(trv), 3.0, T(s["sta_mask"]))
        got = (featurize_window_rasterized(*targs, **s["kw"]) if kind == "rasterized"
               else featurize_window(*targs))
        for b in range(2):
            np.testing.assert_allclose(got[0][b].numpy(), np.asarray(want[b][0]), atol=1e-6)
            np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[b][1]))


def _rows_as_sets(a):
    return [set(r.tolist()) for r in np.asarray(a).reshape(-1, np.asarray(a).shape[-1])]


def test_knn_tables_match_jax_as_sets(setup):
    s = setup
    ctx, cfg = s["ctx"], s["cfg"]
    sta_mask = T(s["sta_mask"])
    nbr, valid = build_station_graph(T(ctx.sta_cart), cfg.graph.k_sta_edges, sta_mask)
    jn, jv = jax_station_graph(ctx.sta_cart, cfg.graph.k_sta_edges, jnp.asarray(s["sta_mask"]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    vn = np.where(valid.numpy(), nbr.numpy(), -1)
    vj = np.where(np.asarray(jv), np.asarray(jn), -1)
    assert _rows_as_sets(vn) == _rows_as_sets(vj)
    att = build_query_attachment(T(ctx.grids_cart[0]), T(s["xq"]), k=cfg.graph.k_spatial_attn)
    assert _rows_as_sets(att) == _rows_as_sets(s["xq_idx"])
    # batched attachment (refinement queries carry a window axis)
    att2 = build_query_attachment(T(ctx.grids_cart[0]), T(np.stack([s["xq"], s["xq"][::-1]])),
                                  k=cfg.graph.k_spatial_attn)
    assert _rows_as_sets(att2[1]) == _rows_as_sets(np.asarray(s["xq_idx"])[::-1])


def test_domain_tables_match_jax(setup):
    """Source kNN, time pointers and edge features of build_domain_context."""
    s = setup
    ctx, cfg = s["ctx"], s["cfg"]
    tctx = build_domain_context(cfg, ctx.sta_lla, ctx.sta_cart, ctx.grids_lla,
                                ctx.grids_cart, ctx.trv_grids, "cpu")
    assert _rows_as_sets(tctx.src_nbr) == _rows_as_sets(ctx.src_nbr)
    assert _rows_as_sets(tctx.time_ptr_p) == _rows_as_sets(ctx.time_ptr_p)
    assert _rows_as_sets(tctx.time_ptr_s) == _rows_as_sets(ctx.time_ptr_s)
    assert (tctx.dt0, tctx.dt) == (ctx.dt0, ctx.dt)
    np.testing.assert_allclose(tctx.edge_feat.numpy(), np.asarray(ctx.edge_feat), atol=1e-6)
    np.testing.assert_allclose(tctx.scale_cart.numpy(), np.asarray(ctx.scale_cart))
    p, q, dt0, dt, n_dt = build_time_pointers(T(ctx.trv_grids[1]), k=3, win=5.0)
    jp, jq, jdt0, jdt, jn = jax_time_pointers(ctx.trv_grids[1], k=3, win=5.0)
    assert (dt0, dt, n_dt) == (jdt0, jdt, jn)
    assert _rows_as_sets(p) == _rows_as_sets(jp)


def test_pair_table_matches_jax(setup):
    s = setup
    tp, ip, ph, pm = s["picks"]
    k = s["cfg"].graph.k_pick_pairs
    jidx, jval = jax_pair_table(*map(jnp.asarray, (tp, ip, pm)), k_pair=k)
    idx, val = build_pair_table(*(T(a)[None] for a in (tp, ip, pm)), k_pair=k)
    np.testing.assert_array_equal(val[0].numpy(), np.asarray(jval))
    assert _rows_as_sets(idx[0]) == _rows_as_sets(jidx)
    assert (idx[0, :, -1] == len(tp)).all()


def test_geometry_and_travel_times_match_jax(setup):
    s = setup
    cfg = s["cfg"]
    jp = JaxProjection.from_center(cfg.region.center)
    p = Projection.from_center(cfg.region.center)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1e5, 1e5, (20, 3))
    np.testing.assert_allclose(p.to_lla_np(x), jp.to_lla_np(x), atol=1e-5, rtol=1e-9)
    lla = jp.to_lla_np(x).astype(np.float32)
    np.testing.assert_allclose(p.to_cart(T(lla)).numpy(), np.asarray(jp.to_cart(lla)),
                               atol=2.0)
    got_lla = p.to_lla(T(x.astype(np.float32))).numpy()
    want_lla = np.asarray(jp.to_lla(x.astype(np.float32)))
    np.testing.assert_allclose(got_lla[:, :2], want_lla[:, :2], atol=1e-4)  # degrees
    np.testing.assert_allclose(got_lla[:, 2], want_lla[:, 2], atol=2.0)      # metres, f32
    sta = np.asarray(s["ctx"].sta_cart)
    src = x.astype(np.float32)
    sta_lla = np.asarray(s["ctx"].sta_lla)
    ht, jht = HomogeneousTravelTime(p), s["tt"]
    np.testing.assert_allclose(ht(T(sta_lla), T(lla)).numpy(),
                               np.asarray(jht(jnp.asarray(sta_lla), jnp.asarray(lla))),
                               atol=1e-3)
    np.testing.assert_allclose(ht.pairwise(T(sta_lla[:5]), T(lla[:5])).numpy(),
                               np.asarray(jht.pairwise(jnp.asarray(sta_lla[:5]),
                                                       jnp.asarray(lla[:5]))), atol=1e-3)
    np.testing.assert_allclose(
        HomogeneousTravelTime(p).from_cart(T(sta), T(src)).numpy(),
        np.asarray(s["tt"].from_cart(jnp.asarray(sta), jnp.asarray(src))), rtol=1e-6)
    lats, lons = np.linspace(39, 40, 5), np.linspace(-124, -123, 6)
    deps = np.linspace(-40e3, 2e3, 4)
    table = rng.uniform(0, 60, (3, 5, 6, 4, 2)).astype(np.float32)
    q = np.stack((rng.uniform(38.9, 40.1, 7), rng.uniform(-124.1, -122.9, 7),
                  rng.uniform(-41e3, 3e3, 7)), 1).astype(np.float32)
    jt = JaxGridTT(table, lats, lons, deps)
    tt = GridTravelTime(table, lats, lons, deps)
    np.testing.assert_allclose(tt(None, T(q)).numpy(), np.asarray(jt(None, jnp.asarray(q))),
                               atol=1e-4)
    qi = np.array([0, 1, 2, 0, 1, 2, 0])
    np.testing.assert_allclose(tt.pairwise(None, T(q), qi).numpy(),
                               np.asarray(jt.pairwise(None, jnp.asarray(q), qi)), atol=1e-4)
