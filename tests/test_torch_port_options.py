"""The detector and pipeline options that run6 leaves off, held against the
JAX package on the tiny domain of tests/test_trainer.py: the updated model
definition (``mean_rel_pos_embed`` and the edge-featured dual-relation
rounds, whose edge form runs in the fused round), ``use_absolute_pos``,
``normalize_readin`` (the read-in's ``sum_gain``), subgraph pair masks and
the bf16-weight sweep.

Tolerances: ``mean_rel_pos_embed`` atol 1e-6; layers and the composed
forward atol 2e-4 / rtol 1e-4 (the chain tolerance of
tests/test_torch_port_detector.py); the loss rtol 1e-4 and every gradient
leaf within 1e-4 × its own max |g| (as the init-weight case of
tests/test_torch_port_train_step.py); pair masks exactly, on positions
drawn from a continuous law (``torch.topk`` and ``jax.lax.top_k`` may pick
different stations among equal distances, which such draws do not have);
the bf16 sweep 1e-3 (f16 spacing near 1 is 4.9e-4). Comparisons run at the
batch-function level, so each JAX program compiles once at the tiny size."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.graphs.build import build_query_attachment as jax_attach
from genie_tpu.graphs.build import build_pair_table as jax_pair_table
from genie_tpu.graphs.build import build_station_graph as jax_station_graph
from genie_tpu.graphs.subgraph import pair_mask as jax_pair_mask
from genie_tpu.infer.pipeline import InferencePipeline as JaxPipeline
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.models.detector import GraphBundle as JaxGraph
from genie_tpu.models.detector import PickSet as JaxPicks
from genie_tpu.models.detector import QuerySet as JaxQueries
from genie_tpu.models.layers import DataAggregation as JaxDataAggregation
from genie_tpu.models.layers import DataAggregationAssociationPhase as JaxAssocAgg
from genie_tpu.models.layers import mean_rel_pos_embed as jax_mean_rel_pos_embed
from genie_tpu.synth.generator import WindowBatch as JaxWindowBatch
from genie_tpu.synth.generator import featurize_window_rasterized as jax_raster
from genie_tpu.train.trainer import loss_fn as jax_loss_fn
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.graphs.subgraph import apply_pair_mask, pair_mask
from genie_tpu_torch.infer.pipeline import InferencePipeline
from genie_tpu_torch.models.detector import Detector, GraphBundle, PickSet, QuerySet
from genie_tpu_torch.models.init import init_detector
from genie_tpu_torch.models.layers import (DataAggregation,
                                           DataAggregationAssociationPhase,
                                           ProductTables, mean_rel_pos_embed)
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.ops.segment import aggregation_matrix, aggregation_weights
from genie_tpu_torch.params import (flatten_tree, load_flax_params, load_into, to_flax,
                                    transplant)
from genie_tpu_torch.train.trainer import build_domain_context, generate_batch, loss_fn, step_seed
from genie_tpu_torch.workflow import train

from tests.test_trainer import tiny_config, tiny_domain

ROOT = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-4, 1e-4
MODEL_OPTIONS = ("use_updated_model_definition", "use_absolute_pos", "normalize_readin")
SEED = 4


def T(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config()
    jcfg.train.positive_boost = 100.0
    jctx, jtt = tiny_domain(jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    ctx = build_domain_context(cfg, np.asarray(jctx.sta_lla), np.asarray(jctx.sta_cart),
                               np.asarray(jctx.grids_lla), np.asarray(jctx.grids_cart),
                               np.asarray(jctx.trv_grids), "cpu")
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    return dict(jcfg=jcfg, jctx=jctx, jtt=jtt, cfg=cfg, ctx=ctx, tt=tt)


@pytest.fixture(scope="module")
def window(setup):
    """One pick window featurized by the JAX package, its graph tables for
    both packages and a detection query set (tests/test_torch_port_detector
    .py's construction)."""
    cfg, ctx = setup["jcfg"], setup["jctx"]
    rng = np.random.default_rng(5)
    n_sta, n_pick = ctx.sta_cart.shape[0], cfg.graph.max_picks
    trv0 = np.asarray(ctx.trv_grids[0])
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
    kw = dict(t_lo=-10.0, t_hi=cfg.model.t_win + float(trv0.max()) + 10.0)
    feat, fmask = jax_raster(*map(jnp.asarray, (tp, ip, ph, pm)), ctx.trv_grids[0],
                             3.0, jnp.asarray(sta_mask), **kw)
    sn, sv = jax_station_graph(ctx.sta_cart, cfg.graph.k_sta_edges, jnp.asarray(sta_mask))
    jg = JaxGraph(sn, sv, ctx.src_nbr[0], jnp.asarray(sta_mask), ctx.edge_feat[0],
                  ctx.grids_cart[0], ctx.time_ptr_p[0], ctx.time_ptr_s[0],
                  jnp.float32(ctx.dt0), jnp.float32(ctx.dt), ctx.trv_grids[0])
    xq = np.asarray(ctx.grids_cart[0][:9]) + rng.normal(0, 3e3, (9, 3)).astype(np.float32)
    return dict(picks=(tp, ip, ph, pm), feat=feat, fmask=fmask, jg=jg,
                tg=GraphBundle(*[T(a) for a in jg]), xq=xq,
                xq_idx=jax_attach(ctx.grids_cart[0], jnp.asarray(xq),
                                  k=cfg.graph.k_spatial_attn),
                t_query=jnp.linspace(-5.0, 5.0, 9)[:, None])


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [True, False], ids=["valid", "all"])
def test_mean_rel_pos_embed_matches_jax(setup, with_valid):
    """Station tables over ``sta_nbr_valid`` (invalid slots point at the
    station itself: the self-edge's sign(0) = 0 and norm channel ≈ 1) and
    source tables over the plain k-mean."""
    ctx, cfg = setup["jctx"], setup["jcfg"]
    if with_valid:
        sta_mask = np.ones(ctx.sta_cart.shape[0], bool)
        sta_mask[[1, 5, 6]] = False
        nbr, valid = jax_station_graph(ctx.sta_cart, cfg.graph.k_sta_edges,
                                       jnp.asarray(sta_mask))
        pos = ctx.sta_cart
        assert not np.asarray(valid).all()
    else:
        nbr, valid, pos = ctx.src_nbr[0], None, ctx.grids_cart[0]
    want = jax_mean_rel_pos_embed(pos, nbr, cfg.model.scale_rel, valid)
    got = mean_rel_pos_embed(T(pos), T(nbr), cfg.model.scale_rel,
                             None if valid is None else T(valid))
    assert got.shape == want.shape == (pos.shape[0], 4)
    _close(got, want, atol=1e-6, rtol=0)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


@pytest.mark.parametrize("layer", ["data_agg", "assoc_agg"])
def test_edge_layers_match_jax(setup, window, layer):
    """``DataAggregation`` / ``DataAggregationAssociationPhase`` with
    ``use_edges`` on JAX-initialised weights carried across by
    ``transplant`` (the widened ``l*_t*_2`` linears in the column order
    [x ‖ agg ‖ e ‖ mask])."""
    ctx, cfg = setup["jctx"], setup["jcfg"]
    jg = window["jg"]
    rng = np.random.default_rng(11)
    n_src, n_sta = window["feat"].shape[:2]
    rel_sta = jax_mean_rel_pos_embed(ctx.sta_cart, jg.sta_nbr, cfg.model.scale_rel,
                                     jg.sta_nbr_valid)
    rel_src = jax_mean_rel_pos_embed(jg.src_pos, jg.src_nbr, cfg.model.scale_rel)
    graph = (jg.sta_nbr, jg.sta_nbr_valid, jg.src_nbr, rel_sta, rel_src)
    if layer == "data_agg":
        jm = JaxDataAggregation(in_channels=4, out_channels=15, use_edges=True)
        inputs = (window["feat"], window["fmask"])
        tm = DataAggregation(4, 15, use_edges=True)
    else:
        jm = JaxAssocAgg(15, 15, use_edges=True)
        inputs = (jnp.asarray(rng.normal(size=(n_src, n_sta, 15)).astype(np.float32)),
                  jnp.asarray(rng.normal(size=(n_src, n_sta, 30)).astype(np.float32)),
                  jnp.asarray((rng.random((n_src, n_sta, 1)) > 0.5).astype(np.float32)),
                  window["fmask"])
        tm = DataAggregationAssociationPhase(15, 15, use_edges=True)
    params = jm.init(jax.random.PRNGKey(3), *inputs, *graph)
    tree = jax.tree.map(np.asarray, params["params"])
    # non-zero biases, so no PReLU sits at its kink
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if p[-1].key == "bias" else a, tree)
    want = jm.apply({"params": tree}, *inputs, *graph)
    load_into(tm, tree)
    tables = ProductTables(
        sta_nbr=T(jg.sta_nbr).to(torch.int32),
        sta_w=aggregation_weights(T(jg.sta_nbr), T(jg.sta_nbr_valid)),
        a_src=aggregation_matrix(T(jg.src_nbr), n_src), e_sta=T(rel_sta), e_src=T(rel_src))
    with torch.no_grad():
        got = tm(*[T(a)[None] for a in inputs], tables)
    _close(got[0], want)
    # the edge columns matter: zeroed tables change the output
    zero = tables._replace(e_sta=tables.e_sta * 0, e_src=tables.e_src * 0)
    with torch.no_grad():
        assert float((tm(*[T(a)[None] for a in inputs], zero) - got).abs().max()) > 1e-3


# -- the detector -------------------------------------------------------------------

def _options(which):
    return {o: which in (o, "all") for o in MODEL_OPTIONS}


def _port_model(which, seed=SEED):
    """A port detector with ``which`` option(s), flax-default weights with
    small random biases (so no PReLU sits at its kink), and the JAX twin."""
    opts = _options(which)
    model = init_detector(Detector(src_chunk=4, **opts), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model, JaxDetector(src_chunk=4, **opts)


def _call_args(setup, window):
    """The full forward's arguments: JAX (feat, fmask, graph, sta_pos,
    picks, queries) and the port's, with three association queries."""
    s, w = setup, window
    ctx, cfg = s["jctx"], s["jcfg"]
    tp, ip, ph, pm = map(jnp.asarray, w["picks"])
    pair_idx, pair_valid = jax_pair_table(tp, ip, pm, k_pair=cfg.graph.k_pick_pairs)
    xqs, xqs_idx = jnp.asarray(w["xq"][:3]), w["xq_idx"][:3]
    tq = jnp.asarray([0.0, 2.5, 6.0], jnp.float32)
    trv_q = s["jtt"].from_cart(ctx.sta_cart, xqs)
    jargs = (w["feat"], w["fmask"], w["jg"], ctx.sta_cart,
             JaxPicks(tp, ip, ph, pm, pair_idx, pair_valid),
             JaxQueries(jnp.asarray(w["xq"]), w["xq_idx"], w["t_query"], xqs, xqs_idx,
                        tq, trv_q))
    targs = (T(w["feat"])[None], T(w["fmask"])[None], w["tg"], T(ctx.sta_cart),
             PickSet(*[T(a)[None] for a in (tp, ip, ph, pm, pair_idx, pair_valid)]),
             QuerySet(T(w["xq"]), T(w["xq_idx"]), T(w["t_query"]), T(xqs)[None],
                      T(xqs_idx)[None], T(tq)[None], T(trv_q)[None]))
    return jargs, targs


@pytest.mark.parametrize("which", [*MODEL_OPTIONS, "all"])
def test_detector_forward_with_options_matches_jax(setup, window, which):
    """(y, x, arv_p, arv_s) of the full forward for each option alone and
    all together; the JAX model runs the port's weights through
    ``to_flax``."""
    model, jm = _port_model(which)
    jargs, targs = _call_args(setup, window)
    jout = jm.apply({"params": jax.tree.map(jnp.asarray, to_flax(model))}, *jargs)
    with torch.no_grad():
        out = model(*targs)
    for got, want in zip(out, jout):
        _close(got[0], want)
    assert float(jnp.abs(jout[0]).max()) > 1e-3 and float(jnp.abs(jout[2]).max()) > 1e-3


def test_weights_carry_across_with_all_options(setup, window):
    """JAX-initialised weights of the detector with all three options load
    into the port strictly (``read_in/sum_gain`` a 0-d leaf, 8.0) and come
    back leaf for leaf through ``to_flax``. The other direction, the port's
    weights through ``to_flax`` into JAX ``Detector.apply``, is the ``all``
    case of the forward test above."""
    jm = JaxDetector(src_chunk=4, **_options("all"))
    tree = jax.tree.map(np.asarray,
                        jm.init(jax.random.PRNGKey(0), *_call_args(setup, window)[0])["params"])
    flat = flatten_tree(tree)
    assert flat["read_in/sum_gain"].shape == () and float(flat["read_in/sum_gain"]) == 8.0
    assert transplant(tree)["read_in.sum_gain"].shape == ()
    model = load_into(Detector(src_chunk=4, **_options("all")), tree)
    back = flatten_tree(to_flax(model))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# -- training with all three model options -----------------------------------------

@pytest.fixture(scope="module")
def shared_batch(setup):
    """The batch ``workflow.train(seed=SEED)`` draws at step 0, as numpy for
    JAX, and JAX's loss and gradients at ``workflow.train``'s initial
    weights (``init_detector`` from a generator seeded with SEED) with all
    three model options."""
    s = setup
    cfg = s["cfg"]
    wb = generate_batch(torch.Generator().manual_seed(step_seed(SEED, 0)), cfg, s["ctx"],
                        s["tt"].from_cart)
    jwb = JaxWindowBatch(*[jnp.asarray(t.numpy()) for t in wb])
    model = init_detector(Detector(**_options("all")), torch.Generator().manual_seed(SEED))
    jm = JaxDetector(src_chunk=16, **_options("all"))

    def loss(p):
        return jax_loss_fn(jm, p, s["jctx"], s["jcfg"], jwb, s["jtt"].from_cart)

    params = {"params": jax.tree.map(jnp.asarray, to_flax(model))}
    (total_j, _), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(wb=wb, model=model, total_j=float(total_j),
                grads_j=flatten_tree(jax.tree.map(np.asarray, grads_j["params"])))


def test_loss_and_gradients_with_all_options_match_jax(setup, shared_batch):
    """Loss and every gradient leaf at ``init_detector`` weights with the
    updated model definition, absolute positions and the normalised
    read-in, on one shared batch: the widened linears' edge columns and
    ``sum_gain`` take their gradients through the ``FusedRound`` backward
    and the read-in."""
    s, b = setup, shared_batch
    assert float(b["wb"].lbl_grid.max()) > 0.5        # the batch holds an event
    model = b["model"]
    model.zero_grad()
    total, _ = loss_fn(model, s["ctx"], s["cfg"], b["wb"], s["tt"].from_cart,
                       backward=True)
    np.testing.assert_allclose(float(total), b["total_j"], rtol=1e-4)
    got = flatten_tree(to_flax({n: p.grad for n, p in model.named_parameters()}))
    want = b["grads_j"]
    assert set(got) == set(want) and "read_in/sum_gain" in want
    bad = {}
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float(np.abs(got[k] - want[k]).max())
        if err > 1e-4 * max(float(np.abs(want[k]).max()), 1e-30):
            bad[k] = (err, float(np.abs(want[k]).max()))
    assert not bad, bad
    assert float(np.abs(want["data_agg/l1_t1_2/kernel"][60:64]).max()) > 0  # edge rows


def test_workflow_train_with_options_moves_sum_gain(setup, shared_batch, tmp_path):
    """``workflow.train`` builds the detector with ``cfg.model``'s options:
    its first step's loss is JAX's on the same batch and weights, and one
    Adam step moves the read-in's ``sum_gain`` off 8.0."""
    s = setup
    cfg = Config.from_dict(s["cfg"].to_dict())
    for o in MODEL_OPTIONS:
        setattr(cfg.model, o, True)
    model, state, hist = train(cfg, s["ctx"], s["tt"], tmp_path, n_steps=1, log_every=1,
                               seed=SEED)
    assert model.read_in.normalize and model.use_edges and model.use_absolute_pos
    assert state.step == 1
    np.testing.assert_allclose(hist[0][0]["loss"], shared_batch["total_j"], rtol=1e-4)
    assert float(model.read_in.sum_gain.detach()) != 8.0


# -- subgraph mode and the bf16 sweep ----------------------------------------------

def test_pair_mask_matches_jax_exactly(setup):
    """ε-ball OR k nearest stations, on the tiny domain (grid 1) and on
    positions drawn uniformly (no equal distances); and the feature
    masking."""
    ctx = setup["jctx"]
    rng = np.random.default_rng(2)
    cases = [(ctx.grids_lla[1], ctx.sta_lla, 0.3, 3),
             (rng.uniform(36, 40, (40, 3)).astype(np.float32),
              rng.uniform(36, 40, (25, 3)).astype(np.float32), 1.0, 4),
             (rng.uniform(36, 40, (7, 3)).astype(np.float32),
              rng.uniform(36, 40, (5, 3)).astype(np.float32), 1e-6, 30)]
    for src, sta, eps, k in cases:
        want = np.asarray(jax_pair_mask(jnp.asarray(src), jnp.asarray(sta), eps, k))
        got = pair_mask(T(src), T(sta), eps, k).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all() or k >= sta.shape[0]
    feat = rng.normal(size=(2, 40, 25, 4)).astype(np.float32)
    m = pair_mask(T(cases[1][0]), T(cases[1][1]), 1.0, 4)
    f, fm = apply_pair_mask(T(feat), (T(feat) > 0).float(), m)
    np.testing.assert_array_equal(f.numpy(), feat * m.numpy()[None, :, :, None])
    np.testing.assert_array_equal(fm.numpy(), (feat > 0) * m.numpy()[None, :, :, None])


@pytest.fixture(scope="module")
def sweep_batch(setup):
    """One two-window sweep batch (the planted-event windows of
    tests/test_torch_port_pipeline.py) with the run6 weights."""
    from tests.test_torch_port_pipeline import _planted_span

    s = setup
    cfg = tiny_config()
    cfg.process.n_query_grid = 0
    tree = load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl")
    picks = _planted_span(s["jctx"])
    return dict(cfg=cfg, tree=tree, picks=picks, t0s=(30.0, 110.0))


def _batch(pipe, picks, t0s):
    return [pipe._window_picks(*picks, t0)[:4] for t0 in t0s]


@pytest.mark.parametrize("mode", ["subgraph", "sweep_half"])
def test_sweep_batch_options_match_jax(setup, sweep_batch, mode):
    """A sweep batch with a thin pair mask (``max_deg_offset`` 1e-6, k 2:
    each source keeps its 2 nearest stations) against the JAX
    ``_sweep_batch_fn`` at 2e-4; and the bf16-weight sweep against the JAX
    ``sweep_half`` at 1e-3, f16 on both sides."""
    s, b = setup, sweep_batch
    cfg = Config.from_dict(b["cfg"].to_dict())
    if mode == "subgraph":
        cfg.graph.use_subgraph = True
        cfg.graph.max_deg_offset = 1e-6
        cfg.graph.k_nearest_pairs = 2
    kw = dict(sweep_half=mode == "sweep_half")
    jcfg = type(s["jcfg"]).from_dict(cfg.to_dict())
    jpipe = JaxPipeline(JaxDetector(), {"params": jax.tree.map(jnp.asarray, b["tree"])},
                        jcfg, s["jctx"], s["jtt"].from_cart, **kw)
    tpipe = InferencePipeline(load_into(Detector(), b["tree"]), cfg, s["ctx"],
                              s["tt"].from_cart, device="cpu", **kw)
    wins = _batch(tpipe, b["picks"], b["t0s"])
    tp, ip, ph, pm = (np.stack([w[i] for w in wins]) for i in range(4))
    want = np.asarray(jpipe._sweep_batch_fn(*map(jnp.asarray, (tp, ip, ph, pm)),
                                            jpipe.sta_mask, jpipe.sta_nbr,
                                            jpipe.sta_nbr_valid, 0))
    got = tpipe._sweep_batch(*tpipe._to_device(wins), 0)
    f32 = InferencePipeline(load_into(Detector(), b["tree"]), b["cfg"], s["ctx"],
                            s["tt"].from_cart, device="cpu")._sweep_batch(
                                *tpipe._to_device(wins), 0)
    if mode == "subgraph":
        assert got.dtype == torch.float32
        _close(got, want)
        assert float((got - f32).abs().max()) > 1e-2       # the mask matters
        np.testing.assert_array_equal(
            tpipe._pair_masks[0].sum(1).numpy(), np.full(tpipe._pair_masks[0].shape[0], 2))
    else:
        assert got.dtype == torch.float16 and want.dtype == np.float16
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   atol=1e-3, rtol=0)
        assert float((got.float() - f32).abs().max()) < 0.05   # the JAX test's bound
        assert float(f32.abs().max()) > 0.05
