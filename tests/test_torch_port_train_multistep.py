"""Training over many steps, the port against the JAX package, on the CPU:
K = 10 steps from JAX's ``init_train_state`` weights (``Detector(src_chunk
=16)``, key 0), carried into the port with ``params.load_into``, on the same
ten JAX batches (keys split from ``PRNGKey(3)``) of
``scripts/eval_synthetic.py``'s domain cut to 16 stations × 64 sources and 2
windows per batch, through both ``make_train_step_from_batch``.

Tolerances: step 0's loss and its four parts within 1e-5 relative (the same
weights); every later step's within 1e-3 relative; the weights after K
steps with at least 99 % of entries within 1e-2·lr and every entry within
2·K·lr (Adam turns a near-zero gradient of opposite sign into a 2·lr
difference per step). The worst leaf is printed.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.train.trainer import generate_batch as jax_generate_batch
from genie_tpu.train.trainer import init_train_state as jax_init_train_state
from genie_tpu.train.trainer import \
    make_train_step_from_batch as jax_make_train_step_from_batch
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.params import flatten_tree, load_into, to_flax
from genie_tpu_torch.scripts import eval_synthetic
from genie_tpu_torch.synth.generator import WindowBatch
from genie_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step_from_batch

from tests.test_torch_port_eval_scaling import T, jax_script

K_STEPS = 10
LOSS_KEYS = ("loss", "loss_grid", "loss_query", "loss_p", "loss_s")


@pytest.fixture(scope="module")
def training_runs():
    """K steps of both packages from JAX's initial weights on the same JAX
    batches (16 stations × 64 sources, 2 windows per batch)."""
    jcfg, jctx, jtt = jax_script("eval_synthetic").build(
        argparse.Namespace(n_sta=16, n_src=64, n_batch=2, thresh=0.3))
    jmodel = JaxDetector(src_chunk=16)
    jstate = jax_init_train_state(jmodel, jcfg, jctx, jtt.from_cart, jax.random.PRNGKey(0))
    init_tree = jax.tree.map(np.asarray, jstate.params["params"])
    draw = jax.jit(jax.vmap(lambda k: jax_generate_batch(k, jcfg, jctx, jtt.from_cart)))
    jwbs = draw(jax.random.split(jax.random.PRNGKey(3), K_STEPS))
    jstep, _ = jax_make_train_step_from_batch(jmodel, jcfg, jctx, jtt.from_cart)
    jmetrics = []
    for i in range(K_STEPS):
        jstate, m = jstep(jstate, jax.tree.map(lambda a: a[i], jwbs))
        jmetrics.append({k: float(m[k]) for k in LOSS_KEYS})

    cfg, ctx, tt = eval_synthetic.build(16, 64, 2, 0.3, "cpu")
    model = load_into(Detector(src_chunk=16), init_tree)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    step = make_train_step_from_batch(cfg, ctx, tt.from_cart)
    metrics = []
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for i in range(K_STEPS):
            state, m = step(state, WindowBatch(*[T(a[i]) for a in jwbs]))
            metrics.append({k: float(m[k]) for k in LOSS_KEYS})
    finally:
        torch.set_num_threads(n)
    return dict(cfg=cfg, init=flatten_tree(init_tree), jmetrics=jmetrics, metrics=metrics,
                jweights=flatten_tree(jax.tree.map(np.asarray, jstate.params["params"])),
                weights=flatten_tree(to_flax(state.model)))


def test_multi_step_losses_match_jax(training_runs):
    r = training_runs
    for i, (got, want) in enumerate(zip(r["metrics"], r["jmetrics"])):
        rtol = 1e-5 if i == 0 else 1e-3
        for k in LOSS_KEYS:
            assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-12), (i, k, got[k],
                                                                            want[k])
    # the batches hold positives and the loss moves
    assert max(m["loss_p"] for m in r["jmetrics"]) > 0
    assert r["jmetrics"][-1]["loss"] != r["jmetrics"][0]["loss"]


def test_multi_step_weights_match_jax(training_runs):
    r = training_runs
    lr = r["cfg"].train.lr
    got, want, init = r["weights"], r["jweights"], r["init"]
    assert set(got) == set(want)
    diffs = {k: np.abs(got[k] - want[k]).ravel() for k in want}
    every = np.concatenate(list(diffs.values()))
    worst = max(diffs, key=lambda k: diffs[k].max())
    share = float((every <= 1e-2 * lr).mean())
    print(f"worst leaf {worst}: {diffs[worst].max():.3g} (lr {lr}); "
          f"{share:.5f} of {every.size} entries within 1e-2·lr")
    assert share >= 0.99, (share, worst, float(diffs[worst].max()))
    assert float(every.max()) <= 2 * K_STEPS * lr, (worst, float(diffs[worst].max()))
    # the weights moved by many lr
    moved = max(float(np.abs(want[k] - init[k]).max()) for k in want)
    assert moved > 5 * lr
