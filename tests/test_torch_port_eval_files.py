"""The files under ``projects/eval_synthetic/`` that ``chip_smoke.py``'s
``[evaluate]`` reads, against live JAX draws, and the two packages' DE
locators over many draws, on the CPU.

* ``timeline_1234.npz`` equals JAX's live draw exactly (``PRNGKey(1234)``,
  1800 s, as ``scripts/eval_synthetic.py`` draws it: its picks and
  detectable true sources) and its query grid JAX's
  ``build_query_grid(PRNGKey(11))``.
* Each locator run many times on the picks of each event of
  ``catalog_jax.json``: why ``chip_smoke.match_catalog`` does not hold
  catalogs by distance alone (``tests/test_torch_port_eval_trained.py``
  holds that catalog to a live JAX run).
"""

import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from genie_tpu.infer.locate import locate_sources_batched as jax_locate
from genie_tpu.infer.pipeline import build_query_grid as jax_query_grid
from genie_tpu_torch.infer.locate import locate_sources_batched
from genie_tpu_torch.scripts import eval_synthetic

from tests.test_torch_port_eval_trained import (CATALOG, TIMELINE, jax_domain,
                                                jax_eval_timeline)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_committed_timeline_is_the_jax_draw():
    jcfg, jctx, jtt = jax_domain()
    picks, true_srcs = jax_eval_timeline(jcfg, jctx, jtt)
    z = np.load(TIMELINE)
    assert set(z.files) == {"pick_t", "pick_sta", "pick_phase", "true_srcs", "x_query_grid"}
    for name, want in zip(("pick_t", "pick_sta", "pick_phase"), picks):
        assert z[name].dtype == want.dtype, name
        np.testing.assert_array_equal(z[name], want, err_msg=name)
    np.testing.assert_array_equal(z["true_srcs"], true_srcs)
    assert len(true_srcs) >= 5
    grid = jax_query_grid(jax.random.PRNGKey(11), jctx, jcfg.process.n_query_grid)
    np.testing.assert_array_equal(z["x_query_grid"], grid)


N_DRAWS = 64


def test_locators_agree_in_distribution():
    """Why ``chip_smoke.match_catalog`` does not hold catalogs by distance
    alone: each package's DE locator run ``N_DRAWS`` times (one batch, other
    draws) on the picks of each event of the committed JAX catalog
    (``catalog_jax.json``, threshold 0.2, 1800 s). Both reach the same deepest
    minimum (within ``chip_smoke.EVAL_COST``), and the share of draws that
    reach it agrees within 3.5 binomial standard errors (plus one draw); the
    share of draws more than 1 km from the deepest draw's location is
    printed for both."""
    z = np.load(TIMELINE)
    pick_t, pick_sta = z["pick_t"], z["pick_sta"]
    evs = json.loads(CATALOG.read_text())["events"]
    L = max(len(e["picks"]) for e in evs)
    rows = len(evs) * N_DRAWS
    tp, ip = np.zeros((rows, L), np.float32), np.zeros((rows, L), np.int32)
    ph, mk = np.zeros((rows, L, 1), np.float32), np.zeros((rows, L), bool)
    for k, e in enumerate(evs):
        idx, n = np.asarray(e["picks"], np.int64), len(e["picks"])
        sl = slice(k * N_DRAWS, (k + 1) * N_DRAWS)
        tp[sl, :n] = pick_t[idx] - e["time"]
        ip[sl, :n] = pick_sta[idx]
        ph[sl, :n, 0] = e["pick_phases"]
        mk[sl, :n] = True
    jcfg, jctx, jtt = jax_domain()
    cfg, ctx, tt = eval_synthetic.build(32, 200, 8, 0.2, "cpu")
    lo = np.concatenate((ctx.offset_cart.numpy(), [-30.0])).astype(np.float32)
    hi = np.concatenate(((ctx.offset_cart + ctx.scale_cart).numpy(),
                         [30.0])).astype(np.float32)
    trim = cfg.process.trim_fraction
    assert trim == jcfg.process.trim_fraction
    jx, _, jc = jax_locate(jax.random.PRNGKey(5), jtt.from_cart, jctx.sta_cart, tp, ip, ph,
                           mk, lo, hi, trim_fraction=trim)
    with torch.no_grad():
        tx, _, tc = locate_sources_batched(
            torch.Generator().manual_seed(5), tt.from_cart, ctx.sta_cart,
            *map(torch.as_tensor, (tp, ip, ph, mk)), torch.as_tensor(lo),
            torch.as_tensor(hi), trim_fraction=trim)
    sols = {"port": (tx.numpy(), tc.numpy()), "jax": (np.asarray(jx), np.asarray(jc))}
    for k, e in enumerate(evs):
        sl = slice(k * N_DRAWS, (k + 1) * N_DRAWS)
        best = {name: float(c[sl].min()) for name, (_, c) in sols.items()}
        deepest = min(best.values())
        assert abs(best["port"] - best["jax"]) <= chip_smoke.EVAL_COST, (e["time"], best)
        share, far = {}, {}
        for name, (x, c) in sols.items():
            share[name] = float((c[sl] <= deepest + chip_smoke.EVAL_COST).mean())
            x0 = x[sl][np.argmin(c[sl])]
            far[name] = float((np.linalg.norm(x[sl] - x0, axis=1) > 1e3).mean())
        print(f"event t={e['time']:.2f} s, {len(e['picks'])} picks: deepest {deepest:.5f}; "
              f"share at it port {share['port']:.3f} jax {share['jax']:.3f}; "
              f"> 1 km from the deepest draw port {far['port']:.3f} jax {far['jax']:.3f}")
        p = (share["port"] + share["jax"]) / 2
        se = np.sqrt(max(p * (1 - p), 1.0 / N_DRAWS) * 2 / N_DRAWS)
        assert abs(share["port"] - share["jax"]) <= 3.5 * se + 1.0 / N_DRAWS, (
            e["time"], share, se)
