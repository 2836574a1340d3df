"""The port's day-inference pipeline against the JAX package's, stage by
stage, on the planted-event span of tests/test_pipeline.py with the run6
weights on the tiny synthetic domain.

``n_rand_query = 1`` and ``refine_chunk = 1`` make refinement deterministic
in both packages (offset row 0 of every chunk is the candidate itself).
Association is per source on grid 0 in both, as in the JAX package. The DE
locator draws different random numbers in the two packages, so locations
are compared within 1 km and 0.2 s, not exactly."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.infer.locate import location_uncertainty_batched as jax_gn
from genie_tpu.infer.locate import make_location_objective as jax_objective
from genie_tpu.infer.pipeline import InferencePipeline as JaxPipeline
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.infer.locate import (location_uncertainty_batched,
                                          make_location_objective)
from genie_tpu_torch.infer.pipeline import InferencePipeline
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.params import load_flax_params, load_into
from genie_tpu_torch.train.trainer import build_domain_context

from tests.test_trainer import tiny_config, tiny_domain

ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-4


def _planted_span(ctx):
    """tests/test_pipeline.py:37-58: two events at grid-0 nodes 3 and 17
    (40 s, 120 s) picked at every station, plus 30 noise picks."""
    rng = np.random.default_rng(0)
    n_sta = ctx.sta_cart.shape[0]
    trv = np.asarray(ctx.trv_grids[0])
    pick_t, pick_sta, pick_ph = [], [], []
    for s_idx, t_ev in ((3, 40.0), (17, 120.0)):
        for st in range(n_sta):
            pick_t.append(t_ev + trv[s_idx, st, 0] + rng.normal(0, 0.1))
            pick_sta.append(st)
            pick_ph.append(0)
            pick_t.append(t_ev + trv[s_idx, st, 1] + rng.normal(0, 0.15))
            pick_sta.append(st)
            pick_ph.append(1)
    for _ in range(30):
        pick_t.append(rng.uniform(0, 180))
        pick_sta.append(rng.integers(0, n_sta))
        pick_ph.append(rng.integers(0, 2))
    order = np.argsort(pick_t)
    return (np.array(pick_t, np.float32)[order], np.array(pick_sta, np.int64)[order],
            np.array(pick_ph, np.float32)[order])


@pytest.fixture(scope="module")
def run():
    cfg = tiny_config()
    cfg.process.n_rand_query = 1
    cfg.process.refine_chunk = 1
    cfg.process.n_query_grid = 0      # detection queries = grid 0 in both
    cfg.process.thresh = 0.05         # run6 weights on 16 synthetic stations
    cfg.process.thresh_assoc = 0.1
    cfg.process.min_required_picks = 5
    cfg.process.min_required_sta = 3
    ctx, tt = tiny_domain(cfg)
    tree = load_flax_params(ROOT / "projects/NC_EHZ/run6/params.pkl")
    jpipe = JaxPipeline(JaxDetector(), {"params": jax.tree.map(jnp.asarray, tree)},
                        cfg, ctx, tt.from_cart)
    tctx = build_domain_context(cfg, ctx.sta_lla, ctx.sta_cart, ctx.grids_lla,
                                ctx.grids_cart, ctx.trv_grids, "cpu")
    trv = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    tpipe = InferencePipeline(load_into(Detector(), tree), cfg, tctx, trv.from_cart,
                              device="cpu")
    picks = _planted_span(ctx)
    out = dict(cfg=cfg, ctx=ctx, tt=tt, jpipe=jpipe, tpipe=tpipe, trv=trv, picks=picks)
    out["j_events"] = jpipe.process(*picks, 0.0, 180.0)
    out["t_events"] = tpipe.process(*picks, 0.0, 180.0)
    out["j_sweep"] = jpipe.detection_sweep(*picks, 0.0, 180.0)
    out["t_sweep"] = tpipe.detection_sweep(*picks, 0.0, 180.0)
    return out


def test_sweep_series_matches_jax(run):
    jt, js = run["j_sweep"]
    tt_, ts = run["t_sweep"]
    np.testing.assert_array_equal(tt_, jt)
    assert ts.shape == js.shape
    np.testing.assert_allclose(ts, js, atol=ATOL, rtol=0)
    assert js.max() > run["cfg"].process.thresh


def test_candidates_and_clusters_equal(run):
    jp, tp = run["jpipe"], run["tpipe"]
    jc, jv = jp.extract_candidates(*run["j_sweep"])
    tc, tv = tp.extract_candidates(*run["t_sweep"])
    assert len(jc) > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    jcl, jcv = jp.cluster_candidates(jc, jv)
    tcl, tcv = tp.cluster_candidates(tc, tv)
    np.testing.assert_array_equal(tcl, jcl)
    np.testing.assert_allclose(tcv, jcv, atol=ATOL)
    # refinement with one offset (the incumbent) is deterministic in both
    jr, jrv = jp.refine_sources(*run["picks"], jcl, jcv)
    tr, trv_ = tp.refine_sources(*run["picks"], tcl, tcv)
    np.testing.assert_allclose(tr, jr, atol=1e-3)
    np.testing.assert_allclose(trv_, jrv, atol=ATOL)


def test_association_weights_match_jax_at_fixed_sources(run):
    """Per-source association forward (one query source per window; JAX
    pads it to its src_chunk, only the real row is compared)."""
    jp, tp = run["jpipe"], run["tpipe"]
    pick_t, pick_sta, pick_ph = run["picks"]
    srcs = np.array([[*np.asarray(run["ctx"].grids_cart[0][3]), 40.3],
                     [*np.asarray(run["ctx"].grids_cart[0][17]), 119.8],
                     [10e3, -5e3, -9e3, 80.0]], np.float32)
    wins = [jp._window_picks(pick_t, pick_sta, pick_ph, s[3])[:4] for s in srcs]
    stack = [np.stack([w[i] for w in wins]) for i in range(4)]
    xq = srcs[:, None, :3]
    tq = np.zeros((len(srcs), 1), np.float32)
    if jp._assoc_ps_fn is None:  # built lazily by associate_per_source
        jp.associate_per_source(pick_t, pick_sta, pick_ph, srcs[:1])
    jap, jas = jp._assoc_ps_fn(*map(jnp.asarray, stack), jnp.asarray(xq), jnp.asarray(tq),
                               jp.sta_mask, jp.sta_nbr, jp.sta_nbr_valid, 0)
    tap, tas = tp._assoc_window(*map(torch.from_numpy, stack), torch.from_numpy(xq),
                                torch.from_numpy(tq), 0)
    np.testing.assert_allclose(tap.numpy(), np.asarray(jap), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tas.numpy(), np.asarray(jas), atol=ATOL, rtol=1e-4)
    assert np.asarray(jap).max() > run["cfg"].process.thresh_assoc


def test_process_catalog_matches_jax(run):
    je = sorted(run["j_events"], key=lambda e: e.time)
    te = sorted(run["t_events"], key=lambda e: e.time)
    assert len(je) >= 1
    assert len(te) == len(je)
    for a, b in zip(je, te):
        assert set(b.picks.tolist()) == set(a.picks.tolist())
        assert np.linalg.norm(b.pos_cart - a.pos_cart) < 1e3
        assert abs(b.time - a.time) < 0.2
        assert np.isfinite(b.cov).all()


def test_target_audit_matches_jax(run, capsys):
    """``process_from_sweep(trace=…)`` prints the JAX package's ``[ledger]``
    lines on the same sweep series (the two planted events and a target
    no stage covers) and returns the events of ``process`` without it."""
    g0 = np.asarray(run["ctx"].grids_cart[0])
    trace = np.array([[*g0[3], 40.0], [*g0[17], 120.0], [150e3, 150e3, -5e3, 60.0]])
    jp, tp = run["jpipe"], run["tpipe"]
    capsys.readouterr()
    jp.process_from_sweep(*run["j_sweep"], *run["picks"], trace=trace)
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[ledger]")]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)        # small CPU ops; more threads only contend
    try:
        audited = tp.process_from_sweep(*run["t_sweep"], *run["picks"], trace=trace)
    finally:
        torch.set_num_threads(n_threads)
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[ledger]")]
    plain = run["t_events"]
    assert len(want) == 7 and got == want
    assert "2/3 targets covered; missing [2]" in want[-1]
    assert tp.ledger["dedup"] == [2]
    assert list(tp.stage_seconds) == ["candidates", "refine", "associate", "locate",
                                      "magnitudes"]
    assert len(audited) == len(plain) >= 1
    for a, b in zip(plain, audited):
        assert np.array_equal(a.picks, b.picks) and np.array_equal(a.pos_cart, b.pos_cart)
        assert a.time == b.time


def test_span_association_matches_jax(run):
    """The shared-window ("span") association mode."""
    jp, tp = run["jpipe"], run["tpipe"]
    srcs = np.array([[*np.asarray(run["ctx"].grids_cart[0][3]), 40.0],
                     [*np.asarray(run["ctx"].grids_cart[0][17]), 45.0]])
    je = jp.associate(*run["picks"], srcs, vals=np.array([0.5, 0.4]))
    te = tp.associate(*run["picks"], srcs, vals=np.array([0.5, 0.4]))
    assert len(je) >= 1
    assert [set(e.picks.tolist()) for e in te] == [set(e.picks.tolist()) for e in je]


def _event_arrays(run):
    pick_t, pick_sta, _ = run["picks"]
    evs = run["j_events"]
    L = max(len(e.picks) for e in evs)
    tp = np.zeros((len(evs), L), np.float32)
    ip = np.zeros((len(evs), L), np.int32)
    ph = np.zeros((len(evs), L, 1), np.float32)
    mk = np.zeros((len(evs), L), bool)
    for r, e in enumerate(evs):
        n = len(e.picks)
        tp[r, :n] = pick_t[e.picks] - e.time
        ip[r, :n] = pick_sta[e.picks]
        ph[r, :n, 0] = e.pick_phases
        mk[r, :n] = True
    pos = np.stack([e.pos_cart for e in evs]).astype(np.float32)
    return tp, ip, ph, mk, pos


def test_gauss_newton_covariance_matches_jax(run):
    tp, ip, ph, mk, pos = _event_arrays(run)
    t0 = np.array([0.1, -0.2][:len(pos)] + [0.0] * max(0, len(pos) - 2), np.float32)
    sta = run["ctx"].sta_cart
    want = np.asarray(jax_gn(run["tt"].from_cart, sta, *map(jnp.asarray, (pos, t0, tp, ip,
                                                                         ph, mk))))
    got = location_uncertainty_batched(run["trv"].from_cart, torch.as_tensor(np.array(sta)),
                                       *map(torch.from_numpy, (pos, t0, tp, ip, ph, mk)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_location_objective_matches_jax(run):
    tp, ip, ph, mk, pos = _event_arrays(run)
    rng = np.random.default_rng(4)
    cand = np.concatenate((pos[:, None] + rng.normal(0, 5e3, (len(pos), 32, 3)),
                           rng.normal(0, 1.0, (len(pos), 32, 1))), -1).astype(np.float32)
    sta = run["ctx"].sta_cart
    fn = make_location_objective(run["trv"].from_cart, torch.as_tensor(np.array(sta)),
                                 *map(torch.from_numpy, (tp, ip, ph, mk)))
    got = fn(torch.from_numpy(cand)).numpy()
    for r in range(len(pos)):
        jfn = jax_objective(run["tt"].from_cart, sta, *map(jnp.asarray, (tp[r], ip[r],
                                                                         ph[r], mk[r])))
        np.testing.assert_allclose(got[r], np.asarray(jfn(jnp.asarray(cand[r]))), rtol=1e-5)


def test_sweep_retries_transient_batch_failures(run, monkeypatch):
    tp = run["tpipe"]
    real = tp._sweep_batch
    fails = {"n": 2}

    def flaky(*a, **k):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("injected failure")
        return real(*a, **k)

    monkeypatch.setattr(tp, "_sweep_batch", flaky)
    times, series = tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4,
                                       max_retries=3, retry_wait=0.0)
    assert fails["n"] == 0
    np.testing.assert_allclose(series, run["t_sweep"][1], atol=1e-6)


def test_sweep_checkpoint_resume(run, tmp_path, monkeypatch):
    tp = run["tpipe"]
    ckpt = tmp_path / "sweep.partial.npz"
    real = tp._sweep_batch
    calls = {"n": 0}

    def dies(*a, **k):
        calls["n"] += 1
        if calls["n"] > 6:
            raise RuntimeError("injected crash")
        return real(*a, **k)

    monkeypatch.setattr(tp, "_sweep_batch", dies)
    with pytest.raises(RuntimeError, match="injected crash"):
        tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4,
                           checkpoint_path=ckpt, checkpoint_every=1, max_retries=0)
    assert ckpt.exists() and int(np.load(ckpt)["n_done"]) >= 1
    monkeypatch.setattr(tp, "_sweep_batch", real)
    times, series = tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4,
                                       checkpoint_path=ckpt, checkpoint_every=1)
    np.testing.assert_allclose(series, run["t_sweep"][1], atol=1e-6)
    assert not ckpt.exists()


def test_self_check_featurization_matches_jax(run):
    from genie_tpu.infer.pipeline import self_check_featurization as jax_check
    from genie_tpu_torch.infer.pipeline import self_check_featurization

    for grid in (0, 1):
        want = jax_check(run["ctx"], run["tt"].from_cart, 3.0, grid=grid)
        got = self_check_featurization(run["tpipe"].ctx, 3.0, grid=grid)
        assert got == want == (True, True)


def test_checkpoint_from_another_featurizer_is_rejected(run, tmp_path, monkeypatch):
    """The fingerprint names the featurizer and accumulator layout: a
    partial sweep saved under another featurizer restarts from scratch."""
    tp = run["tpipe"]
    ckpt = tmp_path / "sweep.partial.npz"
    real = tp._sweep_batch
    calls = {"n": 0}

    def dies(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("injected crash")
        return real(*a, **k)

    monkeypatch.setattr(tp, "_sweep_batch", dies)
    with pytest.raises(RuntimeError):
        tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4,
                           checkpoint_path=ckpt, checkpoint_every=1, max_retries=0)
    monkeypatch.setattr(tp, "_sweep_batch", real)
    tp.featurizer = "searchsorted"
    try:
        _, series = tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4,
                                       checkpoint_path=ckpt)
    finally:
        tp.featurizer = "rasterized"
    _, direct = tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4)
    tp.featurizer = "searchsorted"
    try:
        _, fresh = tp.detection_sweep(*run["picks"], 0.0, 180.0, window_batch=4)
    finally:
        tp.featurizer = "rasterized"
    np.testing.assert_allclose(series, fresh, atol=1e-6)
    # the two featurizers differ by bin quantization, so a wrongly resumed
    # (mixed) series would not equal the fresh one
    assert np.abs(direct - fresh).max() > 1e-4
