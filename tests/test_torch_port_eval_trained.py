"""The whole ``InferencePipeline.process`` at trained weights at
``scripts/eval_synthetic.py``'s sizes (32 stations, 2 × 200 sources,
threshold 0.2), the port against the JAX package, on the CPU; and the
catalog file that ``chip_smoke.py``'s ``[evaluate]`` holds the card to,
against a live JAX run. The files, under ``projects/eval_synthetic/``:

* ``params.pkl``: the port's 3000-step detector, ``python -m
  genie_tpu_torch.scripts.eval_synthetic --steps 3000 --thresh 0.2
  --save-params`` at the default seeds (train 0, timeline 1234), on an H100.
* ``timeline_1234.npz``: JAX's evaluation timeline (``PRNGKey(1234)``, 1800
  s, as ``scripts/eval_synthetic.py`` draws it): the picks, the detectable
  true sources (x, y, z, t) and JAX's 10,000-node detection query grid
  (held equal to live JAX draws in ``tests/test_torch_port_eval_files.py``).
* ``catalog_jax.json``: JAX's catalog of that timeline at those weights,
  threshold 0.2, with its score, under ``chip_smoke.held_process_config``.

Both packages run with ``held_process_config``: one refinement offset, the
candidate itself, so neither draws refinement offsets (as
``tests/test_torch_port_pipeline.py`` does), and the port is given JAX's
query grid. Their DE locators still draw different numbers, and the trimmed
objective has shallow local minima, kilometres from the deepest, that each
package lands in for some draws
(``tests/test_torch_port_eval_files.py::test_locators_agree_in_distribution``
prints how often). So catalogs are held by
``chip_smoke.match_catalog``, the card's check: the same count; each pair in
time order within 1 km and 0.2 s, or else holding the same picks, with the
port's objective at JAX's location equal to JAX's objective there within
1e-3 s and the port's locator (its own location and 8 more draws) reaching a
minimum no more than 1e-3 s above it; the port's objective equal to JAX's
at JAX's location for every pair with the same picks; and the same
matched-catalog counts.

The live JAX sweep over the whole 1800 s costs minutes on the CPU, so both
packages process the span ``SPAN`` (600 s holding five detectable events)
with all the timeline's picks, and the committed catalog's events at least
``EDGE`` s inside the span are held to the live JAX run's.

``python -m tests.test_torch_port_eval_trained --write`` rewrites the
timeline and the catalog from live JAX runs (the catalog over the whole
1800 s).
"""

import argparse
import copy
import json
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from genie_tpu.infer.locate import make_location_objective as jax_objective
from genie_tpu.infer.pipeline import InferencePipeline as JaxPipeline
from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.synth.generator import synthesize_timeline as jax_timeline
from genie_tpu_torch.infer.pipeline import InferencePipeline
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.params import load_flax_params, load_into
from genie_tpu_torch.scripts import eval_synthetic

from tests.test_torch_port_eval_scaling import _jax_detectable, _jax_score, jax_script

EVAL = chip_smoke.EVAL_DIR
PARAMS, TIMELINE, CATALOG = (EVAL / "params.pkl", EVAL / "timeline_1234.npz",
                             EVAL / "catalog_jax.json")
THRESH = 0.2
EVAL_T = 1800.0
SPAN = (600.0, 1200.0)
EDGE = 30.0


def jax_domain():
    jcfg, jctx, jtt = jax_script("eval_synthetic").build(
        argparse.Namespace(n_sta=32, n_src=200, n_batch=8, thresh=THRESH))
    chip_smoke.held_process_config(jcfg)
    return jcfg, jctx, jtt


def jax_eval_timeline(jcfg, jctx, jtt):
    """``scripts/eval_synthetic.py``'s evaluation timeline and ground truth:
    (pick_t, pick_sta, pick_phase), (n, 4) detectable true sources."""
    syn = copy.deepcopy(jcfg.synth)
    syn.T = EVAL_T
    tl = jax.jit(lambda k: jax_timeline(
        k, syn, jctx.sta_cart, jtt.from_cart, jctx.scale_cart, jctx.offset_cart,
        (jctx.offset_cart[2], jctx.offset_cart[2] + jctx.scale_cart[2]),
        n_sta_real=jctx.sta_cart.shape[0]))(jax.random.PRNGKey(1234))
    pm = np.asarray(tl.pick_mask)
    picks = (np.asarray(tl.pick_t)[pm], np.asarray(tl.pick_sta)[pm],
             np.asarray(tl.pick_phase)[pm].astype(np.float32))
    det = _jax_detectable(tl, jcfg)
    true_srcs = np.concatenate((np.asarray(tl.ev_pos_cart)[det],
                                np.asarray(tl.ev_time)[det][:, None]), axis=1)
    return picks, true_srcs


def jax_pipeline(jcfg, jctx, jtt, x_query_grid=None):
    tree = load_flax_params(PARAMS)
    return JaxPipeline(JaxDetector(src_chunk=16), {"params": jax.tree.map(jnp.asarray, tree)},
                       jcfg, jctx, jtt.from_cart, x_query_grid=x_query_grid)


def jax_catalog(jpipe, events, picks):
    """JAX's events as ``chip_smoke.catalog_event`` dicts with JAX's DE
    objective at each location under ``"cost"``."""
    out = []
    for ev in events:
        e = chip_smoke.catalog_event(ev)
        idx = np.asarray(e["picks"], np.int64)
        fn = jax_objective(jpipe.trv, jpipe.ctx.sta_cart,
                           jnp.asarray(picks[0][idx] - e["time"], jnp.float32),
                           jnp.asarray(picks[1][idx], jnp.int32),
                           jnp.asarray(np.asarray(e["pick_phases"], np.float32)[:, None]),
                           jnp.ones(len(idx), bool), jpipe.cfg.process.trim_fraction)
        e["cost"] = float(fn(jnp.asarray([[*e["pos_cart"], 0.0]], jnp.float32))[0])
        out.append(e)
    return out


def ev4(events):
    return np.array([[*e["pos_cart"], e["time"]] for e in events],
                    np.float64).reshape(-1, 4)


def in_span(events, lo, hi):
    return [e for e in events if lo <= e["time"] < hi]


@pytest.fixture(scope="module")
def runs():
    z = np.load(TIMELINE)
    picks = (z["pick_t"], z["pick_sta"], z["pick_phase"])
    true_srcs = z["true_srcs"]
    jcfg, jctx, jtt = jax_domain()
    jpipe = jax_pipeline(jcfg, jctx, jtt, z["x_query_grid"])
    j_events = jax_catalog(jpipe, jpipe.process(*picks, *SPAN), picks)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg, ctx, tt = eval_synthetic.build(32, 200, 8, THRESH, "cpu")
        chip_smoke.held_process_config(cfg)
        model = load_into(Detector(src_chunk=16), load_flax_params(PARAMS))
        tpipe = InferencePipeline(model, cfg, ctx, tt.from_cart, device="cpu",
                                  x_query_grid=z["x_query_grid"])
        t_events = [chip_smoke.catalog_event(e) for e in tpipe.process(*picks, *SPAN)]
    finally:
        torch.set_num_threads(n)
    return dict(picks=picks, true_srcs=true_srcs, j_events=j_events, t_events=t_events,
                tpipe=tpipe)


def test_process_at_trained_weights_matches_jax(runs):
    r = runs
    true = r["true_srcs"][(r["true_srcs"][:, 3] >= SPAN[0]) & (r["true_srcs"][:, 3] < SPAN[1])]
    assert len(true) >= 2 and len(r["j_events"]) >= 2   # the span holds events, found
    match = chip_smoke.match_catalog(r["t_events"], r["j_events"], r["tpipe"], r["picks"])
    print(match)
    assert match["ok"], match
    want = _jax_score(ev4(r["j_events"]), true)
    got = eval_synthetic.score([SimpleNamespace(pos_cart=np.asarray(e["pos_cart"]),
                                                time=e["time"]) for e in r["t_events"]], true)
    for k in ("n_true", "n_detected", "n_matched"):
        assert got[k] == want[k], (k, got, want)
    assert want["n_matched"] >= 2


def test_committed_catalog_is_the_live_jax_run(runs):
    r = runs
    cat = json.loads(CATALOG.read_text())
    assert cat["thresh"] == THRESH and cat["t_end"] == EVAL_T
    lo, hi = SPAN[0] + EDGE, SPAN[1] - EDGE
    inner = in_span(cat["events"], lo, hi)
    assert len(inner) >= 2
    match = chip_smoke.match_catalog(inner, in_span(r["j_events"], lo, hi), r["tpipe"],
                                     r["picks"])
    assert match["ok"], match
    # its score is the JAX script's statistics of its events
    assert cat["score"] == _jax_score(ev4(cat["events"]), r["true_srcs"])


def write():
    """Write the timeline and the catalog from live JAX runs."""
    jcfg, jctx, jtt = jax_domain()
    picks, true_srcs = jax_eval_timeline(jcfg, jctx, jtt)
    jpipe = jax_pipeline(jcfg, jctx, jtt)
    np.savez_compressed(TIMELINE, pick_t=picks[0], pick_sta=picks[1], pick_phase=picks[2],
                        true_srcs=true_srcs, x_query_grid=np.asarray(jpipe.x_query))
    events = jax_catalog(jpipe, jpipe.process(*picks, 0.0, EVAL_T), picks)
    cat = {"thresh": THRESH, "t_end": EVAL_T, "events": events,
           "score": _jax_score(ev4(events), true_srcs)}
    CATALOG.write_text(json.dumps(cat) + "\n")
    print(json.dumps(cat["score"]))


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write()
