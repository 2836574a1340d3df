"""The port's evaluation and scaling commands
(``genie_tpu_torch.scripts.{eval_synthetic,measure_scaling,scaling_model}``)
against the repo's JAX scripts (``scripts/``, loaded from their files), on
the CPU at small sizes.

* ``eval_synthetic``: ``build``'s domain field by field (1e-6); the
  detectable-event mask (exactly) and the score dict (floats 1e-6) on one
  JAX timeline, against the JAX script's lines transcribed here (they sit
  inside its ``main``); a two-step ``main`` prints one JSON line with the
  JAX script's keys, and its seed flags reach ``evaluate``; its ``--save-params`` pickle, loaded into the JAX
  ``Detector``, gives the port model's detection outputs within 1e-5;
* ``measure_scaling`` / ``scaling_model``: the clustered cloud and the halo
  plan's statistics exactly, the halo sweep's points and slope, the
  efficiency with the v5e constants to 1e-12, and the sharded source mean
  of a 2-rank gloo group equal to the dense one within 1e-6.
"""

import argparse
import contextlib
import copy
import importlib.util
import io
import json
import pickle
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tpu.calibration.corrections import matched_catalog_stats as jax_matched
from genie_tpu.graphs.build import build_query_attachment as jax_attach
from genie_tpu.graphs.build import build_source_graph as jax_source_graph
from genie_tpu.graphs.build import build_station_graph as jax_station_graph
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.models.detector import GraphBundle as JaxGraph
from genie_tpu.parallel.product_shard import build_partition as jax_partition
from genie_tpu.synth.generator import featurize_window_rasterized as jax_raster
from genie_tpu.synth.generator import synthesize_timeline as jax_timeline
from genie_tpu_torch.models.detector import GraphBundle
from genie_tpu_torch.scripts import eval_synthetic, measure_scaling, scaling_model
from genie_tpu_torch.synth.generator import Timeline

ROOT = Path(__file__).resolve().parent.parent

# the JAX script's JSON keys (scripts/eval_synthetic.py, ``out``)
EVAL_KEYS = {"steps", "train_s_per_step", "infer_time_s", "n_true", "n_detected",
             "n_matched", "precision", "recall", "f1", "median_epi_err_m",
             "median_t_err_s"}
# the JAX script's JSON keys (scripts/measure_scaling.py, ``out``)
SCALING_KEYS = {"n_src", "n_sta", "channels", "k_src", "n_shards", "halo_rows_exchanged",
                "halo_rows_moved_padded", "halo_padding_overhead", "halo_row_fraction",
                "t_sharded_with_halo_ms", "t_sharded_local_only_ms", "t_dense_single_ms",
                "measured_comm_fraction", "measured_structural_efficiency", "note"}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """``scripts/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(f"_jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def jax_domain():
    args = argparse.Namespace(n_sta=16, n_src=64, n_batch=8, thresh=0.3)
    return jax_script("eval_synthetic").build(args)


# -- eval_synthetic ------------------------------------------------------------

def test_build_matches_jax(jax_domain):
    jcfg, jctx, _ = jax_domain
    cfg, ctx, _ = eval_synthetic.build(16, 64, 8, 0.3, "cpu")
    assert cfg.to_dict() == jcfg.to_dict()
    for f in jctx._fields:
        want, got = getattr(jctx, f), getattr(ctx, f)
        if want is None:
            assert got is None, f
            continue
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want)
        assert got.shape == want.shape, f
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f)


def _jax_detectable(tl, cfg):
    """scripts/eval_synthetic.py's ground truth, transcribed from its main."""
    pm = np.asarray(tl.pick_mask)
    pick_sta = np.asarray(tl.pick_sta)[pm]
    ev_mask = np.asarray(tl.ev_mask)
    pe = np.asarray(tl.pick_event)[pm]
    n_picks_per_ev = np.bincount(pe[pe >= 0], minlength=len(ev_mask))
    uniq_sta = np.zeros(len(ev_mask))
    for e in np.unique(pe[pe >= 0]):
        uniq_sta[e] = len(np.unique(pick_sta[pe == e]))
    return ev_mask & (n_picks_per_ev >= cfg.synth.min_pick_arrival) & \
        (uniq_sta >= cfg.synth.min_sta_arrival)


def _jax_score(det_srcs, true_srcs):
    """scripts/eval_synthetic.py's statistics, transcribed from its main."""
    stats = jax_matched(det_srcs, true_srcs, sig_x=25e3, sig_t=10.0)
    prec = stats["n_matched"] / max(stats["n_detected"], 1)
    rec = stats["detection_rate"]
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"n_true": len(true_srcs), "n_detected": stats["n_detected"],
            "n_matched": stats["n_matched"], "precision": round(prec, 3),
            "recall": round(rec, 3), "f1": round(f1, 3),
            "median_epi_err_m": stats.get("residual_xy_mean"),
            "median_t_err_s": stats.get("residual_t_mean")}


def test_detectable_events_and_score_match_jax(jax_domain):
    jcfg, jctx, jtt = jax_domain
    syn = copy.deepcopy(jcfg.synth)
    syn.T = 1800.0
    tl = jax_timeline(jax.random.PRNGKey(1234), syn, jctx.sta_cart, jtt.from_cart,
                      jctx.scale_cart, jctx.offset_cart,
                      (jctx.offset_cart[2], jctx.offset_cart[2] + jctx.scale_cart[2]),
                      n_sta_real=jctx.sta_cart.shape[0])
    ttl = Timeline(*[T(getattr(tl, f)) for f in Timeline._fields])
    want = _jax_detectable(tl, jcfg)
    got = eval_synthetic.detectable_events(ttl, jcfg)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < np.asarray(tl.ev_mask).sum()   # the filter bites

    true_srcs = np.concatenate((np.asarray(tl.ev_pos_cart)[want],
                                np.asarray(tl.ev_time)[want][:, None]), axis=1)
    rng = np.random.default_rng(3)
    # every other true event found with errors, plus two false detections
    det = true_srcs[::2] + np.concatenate((rng.normal(0, 4e3, (len(true_srcs[::2]), 3)),
                                           rng.normal(0, 1.0, (len(true_srcs[::2]), 1))), 1)
    det = np.concatenate((det, [[0.0, 0.0, -5e3, 10.0], [9e4, -9e4, -1e4, 1700.0]]))
    events = [SimpleNamespace(pos_cart=d[:3], time=float(d[3])) for d in det]
    for evs in (events, []):
        w = _jax_score(np.array([[*e.pos_cart, e.time] for e in evs]).reshape(-1, 4),
                       true_srcs)
        g = eval_synthetic.score(evs, true_srcs)
        assert list(g) == list(w)
        for k, v in w.items():
            if v is None or isinstance(v, int):
                assert g[k] == v, k
            else:
                assert g[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``eval_synthetic.main`` for two steps on the CPU with
    ``--save-params``; the evaluation pipeline's query grid cut to 500 nodes
    (the default 10,000-node grid makes the CPU sweep take ~40 s)."""
    build = eval_synthetic.build

    def small_query_grid(*a, **kw):
        cfg, ctx, tt = build(*a, **kw)
        cfg.process.n_query_grid = 500
        return cfg, ctx, tt

    path = tmp_path_factory.mktemp("eval") / "params.pkl"
    mp = pytest.MonkeyPatch()
    mp.setattr(eval_synthetic, "build", small_query_grid)
    out = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(out):
            res = eval_synthetic.main(["--steps", "2", "--n-sta", "16", "--n-src", "64",
                                       "--eval-T", "300", "--json", "--save-params",
                                       str(path), "--device", "cpu"])
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return out.getvalue(), res, path


def test_main_prints_the_jax_json(port_run):
    text, (out, info), _ = port_run
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert set(printed) == EVAL_KEYS and printed == json.loads(json.dumps(out))
    assert printed["steps"] == 2 and len(info["losses"]) == 2
    assert all(np.isfinite(info["losses"]))
    assert re.search(r"^step 0 loss [\d.]+ trgts", text, re.M)
    # the CPU runs the kernel's plain version: no launches
    assert info["launches_train"] == 0 and info["launches_process"] == 0
    assert printed["n_detected"] == len(info["events"])
    assert len(info["true_srcs"]) == printed["n_true"]
    assert info["true_srcs"].shape[1:] == (4,)
    pick_t, pick_sta, pick_ph = info["picks"]
    assert len(pick_t) == len(pick_sta) == len(pick_ph) > 0


@pytest.mark.parametrize("argv,train_seed,timeline_seed",
                         [([], 0, 1234),
                          (["--train-seed", "3", "--timeline-seed", "7"], 3, 7)])
def test_seed_flags_reach_evaluate(monkeypatch, argv, train_seed, timeline_seed):
    """The JAX script's seeds by default; ``--train-seed`` and
    ``--timeline-seed`` pass through to ``evaluate``."""
    seen = {}

    def fake_build(n_sta, n_src, n_batch, thresh, dev):
        seen.update(build=(n_sta, n_src, n_batch, thresh, str(dev)))
        return None, None, None

    def fake_evaluate(cfg, ctx, tt, steps, dev, **kw):
        seen.update(kw, steps=steps)
        return {"steps": steps}, {"model": None}

    monkeypatch.setattr(eval_synthetic, "build", fake_build)
    monkeypatch.setattr(eval_synthetic, "evaluate", fake_evaluate)
    with contextlib.redirect_stdout(io.StringIO()):
        eval_synthetic.main(argv + ["--device", "cpu"])
    assert seen == {"build": (32, 200, 8, 0.3, "cpu"), "steps": 500,
                    "train_seed": train_seed, "timeline_seed": timeline_seed,
                    "eval_T": 1800.0}


def test_saved_params_load_into_the_jax_detector(port_run, jax_domain):
    _, (_, info), path = port_run
    jcfg, jctx, _ = jax_domain
    blob = pickle.loads(path.read_bytes())
    jparams = {"params": jax.tree.map(jnp.asarray, blob["params"])}
    run6 = jax.tree.map(np.shape, pickle.loads(
        (ROOT / "projects/NC_EHZ/run6/params.pkl").read_bytes())["params"]["params"])
    assert jax.tree.map(np.shape, blob["params"]) == run6   # names and shapes

    rng = np.random.default_rng(5)
    n_sta, n_pick = jctx.sta_cart.shape[0], 64
    trv0 = np.asarray(jctx.trv_grids[0])
    tp = np.concatenate((20.0 + trv0[7, :, 0], 20.0 + trv0[7, :, 1],
                         rng.uniform(0, 60, n_pick - 2 * n_sta))).astype(np.float32)
    ip = np.concatenate((np.arange(n_sta), np.arange(n_sta),
                         rng.integers(0, n_sta, n_pick - 2 * n_sta))).astype(np.int32)
    ph = np.concatenate((np.zeros(n_sta), np.ones(n_sta),
                         rng.integers(0, 2, n_pick - 2 * n_sta)))[:, None].astype(np.float32)
    order = np.lexsort((tp, ip))
    tp, ip, ph = tp[order], ip[order], ph[order]
    sta_mask = np.ones(n_sta, bool)
    kw = dict(t_lo=-10.0, t_hi=jcfg.model.t_win + float(trv0.max()) + 10.0)
    feat, fmask = jax_raster(*map(jnp.asarray, (tp, ip, ph, np.ones(n_pick, bool))),
                             jctx.trv_grids[0], 3.0, jnp.asarray(sta_mask), **kw)
    sn, sv = jax_station_graph(jctx.sta_cart, jcfg.graph.k_sta_edges,
                               jnp.asarray(sta_mask))
    jg = JaxGraph(sn, sv, jctx.src_nbr[0], jnp.asarray(sta_mask), jctx.edge_feat[0],
                  jctx.grids_cart[0], jctx.time_ptr_p[0], jctx.time_ptr_s[0],
                  jnp.float32(jctx.dt0), jnp.float32(jctx.dt), jctx.trv_grids[0])
    xq = np.asarray(jctx.grids_cart[0][:9]) + rng.normal(0, 3e3, (9, 3)).astype(np.float32)
    xq_idx = jax_attach(jctx.grids_cart[0], jnp.asarray(xq), k=jcfg.graph.k_spatial_attn)
    t_query = jnp.linspace(-5.0, 5.0, 9)[:, None]
    jy, jx = JaxDetector(src_chunk=16).apply(
        jparams, feat, fmask, jg, jctx.sta_cart, jnp.asarray(xq), xq_idx, t_query,
        method=JaxDetector.forward_detection_only)
    model = info["model"].eval()
    with torch.no_grad():
        y, x = model.forward_detection_only(
            T(feat)[None], T(fmask)[None], GraphBundle(*[T(a) for a in jg]),
            T(jctx.sta_cart), T(xq), T(xq_idx), T(t_query))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(jx), rtol=0, atol=1e-5)


# -- measure_scaling, scaling_model ----------------------------------------------

@pytest.mark.parametrize("n_shards", [4, 8])
def test_cloud_and_partition_stats_match_jax(n_shards):
    want_cloud = jax_script("scaling_model").make_cloud(2048, np.random.default_rng(0))
    got_cloud = scaling_model.make_cloud(2048, np.random.default_rng(0))
    np.testing.assert_array_equal(got_cloud, want_cloud)
    part = jax_partition(want_cloud, np.asarray(jax_source_graph(want_cloud, 15)),
                         n_shards)
    got = measure_scaling.partition_stats(2048, 15, n_shards)
    valid, moved = part.halo_rows_valid, part.halo_rows_moved
    assert got == {"halo_rows_exchanged": valid, "halo_rows_moved_padded": moved,
                   "halo_padding_overhead": round(moved / max(valid, 1), 3),
                   "halo_row_fraction": round(valid / 2048, 4)}
    assert 0 < valid <= moved


def test_efficiency_with_v5e_constants_matches_jax():
    jm = jax_script("scaling_model")
    args = argparse.Namespace(channels=30, n_sta=1000, k_src=15, k_sta=8)
    for sent, n_local in ((0, 4096), (629, 1024), (22673, 65536), (100000, 8192)):
        for wire in (4, 2):
            want = jm.efficiency(sent, n_local, args, wire_bytes=wire)
            got = scaling_model.efficiency(sent, n_local, args, wire, flops=jm.FLOPS,
                                           bw_mem=jm.BW_HBM, bw_link=jm.BW_ICI)
            assert abs(got - want) <= 1e-12
    # the card's constants are the defaults
    assert scaling_model.efficiency(629, 1024, args) == scaling_model.efficiency(
        629, 1024, args, flops=67e12, bw_mem=3.35e12, bw_link=900e9)


def test_halo_sweep_matches_jax():
    argv = ["--halo-sweep", "--sweep-sizes", "2048", "4096", "--n-shards", "4",
            "--pod-n-src", "65536"]
    out = io.StringIO()
    old, sys.argv = sys.argv, ["scaling_model", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jax_script("scaling_model").main()
    finally:
        sys.argv = old
    want = out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = scaling_model.main([*argv, "--device", "cpu"])
    text = out.getvalue()
    pts = re.findall(r"n_local +(\d+): halo/shard +(\d+) \(ratio [\d.]+, exact (\d+)\)",
                     want)
    assert len(pts) == 2
    assert pts == re.findall(r"n_local +(\d+): halo/shard +(\d+) \(ratio [\d.]+, "
                             r"exact (\d+)\)", text)
    assert [(int(a), int(b)) for a, b, _ in pts] == [p[:2] for p in got["points"]]
    slope = float(re.search(r"fitted slope (-?[\d.]+)", want).group(1))
    assert round(got["slope"], 3) == slope
    assert 0 < got["efficiency_f32_wire"] < got["efficiency_bf16_wire"] < 1


def test_measure_scaling_two_gloo_ranks_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = measure_scaling.main(["--n-src", "512", "--ranks", "2", "--reps", "3",
                                    "--json-out", str(tmp_path / "m.json"),
                                    "--device", "cpu"])
    assert SCALING_KEYS <= set(res)
    assert json.loads((tmp_path / "m.json").read_text()) == res
    assert res["max_abs_diff_vs_dense"] <= 1e-6
    assert res["n_shards"] == 2 and res["backend"] == "gloo"
    assert res == {**res, **measure_scaling.partition_stats(512, 15, 2)}
    assert res["t_sharded_with_halo_ms"] > 0 and res["t_dense_single_ms"] > 0
