"""The port's training batches at ``scripts/eval_synthetic.py``'s sizes
(32 stations, 2 × 200 sources, batch 8) against the JAX package's, on the
CPU: twelve statistics of a batch, each batch's mean over its 8 windows
taken as one sample (a batch's windows share one timeline, so they are not
independent samples), 256 batches per side from seeds fixed here (JAX keys
split from ``PRNGKey(7)``, port seeds 50000 + i). Each mean is held within
3.5 standard errors of the difference: with twelve statistics, 3 standard
errors would trip on about 3 % of seed choices by chance.

``python -m tests.test_torch_port_eval_quality N`` prints the z values at N
batches per side.
"""

import argparse
import sys

import jax
import numpy as np
import pytest
import torch

from genie_tpu.train.trainer import generate_batch as jax_generate_batch
from genie_tpu_torch.scripts import eval_synthetic
from genie_tpu_torch.train.trainer import generate_batch

from tests.test_torch_port_eval_scaling import jax_script

N_BATCHES = 256
Z_MAX = 3.5
STATS = ("picks per window", "active share", "grid label max", "query label max",
         "lbl_query mass", "lbl_grid mass", "P assoc positive share",
         "S assoc positive share", "mask occupancy", "sta_mask share", "nonzero feat",
         "tq_sample spread")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def batch_stats(b):
    """(n_batches, 12): each batch's mean over its windows of :data:`STATS`.
    ``b`` maps WindowBatch field names to numpy arrays with leading axes
    (batch, window)."""
    pm = b["pick_mask"]
    lq, lg, la = b["lbl_query"], b["lbl_grid"], b["lbl_assoc"]
    n_valid = np.maximum(pm.sum(-1) * la.shape[2], 1)           # per window
    valid = pm[:, :, None, :]
    per_window = np.stack((
        pm.sum(-1),
        lq.max(axis=(-1, -2)) > 0.5,
        lg.max(axis=(-1, -2)),
        lq.max(axis=(-1, -2)),
        lq.sum(axis=(-1, -2)),
        lg.sum(axis=(-1, -2)),
        ((la[..., 0] > 0.5) & valid).sum(axis=(-1, -2)) / n_valid,
        ((la[..., 1] > 0.5) & valid).sum(axis=(-1, -2)) / n_valid,
        b["mask"].mean(axis=(-1, -2, -3)),
        b["sta_mask"].mean(-1),
        (b["feat"] != 0).mean(axis=(-1, -2, -3)),
        b["tq_sample"].std(-1),
    ), axis=-1).astype(np.float64)
    return per_window.mean(axis=1)


FIELDS = ("pick_mask", "lbl_query", "lbl_grid", "lbl_assoc", "mask", "sta_mask", "feat",
          "tq_sample")


def jax_batch_stats(n_batches, chunk=32):
    """JAX batches at the evaluation sizes, keys split from PRNGKey(7)."""
    jcfg, jctx, jtt = jax_script("eval_synthetic").build(
        argparse.Namespace(n_sta=32, n_src=200, n_batch=8, thresh=0.3))
    draw = jax.jit(jax.vmap(lambda k: jax_generate_batch(k, jcfg, jctx, jtt.from_cart)))
    keys = jax.random.split(jax.random.PRNGKey(7), n_batches)
    out = []
    for i in range(0, n_batches, chunk):
        wb = draw(keys[i:i + chunk])
        out.append(batch_stats({f: np.asarray(getattr(wb, f)) for f in FIELDS}))
    return np.concatenate(out)


def port_batch_stats(n_batches):
    """The port's batches at the evaluation sizes, seeds 50000 + i."""
    cfg, ctx, tt = eval_synthetic.build(32, 200, 8, 0.3, "cpu")
    gen = torch.Generator()
    out = []
    for i in range(n_batches):
        wb = generate_batch(gen.manual_seed(50000 + i), cfg, ctx, tt.from_cart)
        out.append(batch_stats({f: getattr(wb, f).numpy()[None] for f in FIELDS}))
    return np.concatenate(out)


def z_values(port, jax_):
    """(12,) z of the port's mean against JAX's, batches as samples."""
    se = np.sqrt(port.var(0, ddof=1) / len(port) + jax_.var(0, ddof=1) / len(jax_))
    return (port.mean(0) - jax_.mean(0)) / se


def test_generator_at_eval_sizes_matches_jax():
    port, jax_ = port_batch_stats(N_BATCHES), jax_batch_stats(N_BATCHES)
    z = z_values(port, jax_)
    report = {n: (round(float(a), 5), round(float(b), 5), round(float(v), 2))
              for n, a, b, v in zip(STATS, port.mean(0), jax_.mean(0), z)}
    assert np.all(np.abs(z) <= Z_MAX), report
    # the statistics see something: events, picks and positive targets occur
    assert 0.2 < port[:, 1].mean() < 0.8 and port[:, 0].mean() > 5
    assert port[:, 6].mean() > 0 and port[:, 7].mean() > 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else N_BATCHES
    torch.set_num_threads(2)
    port, jax_ = port_batch_stats(n), jax_batch_stats(n)
    for name, a, b, v in zip(STATS, port.mean(0), jax_.mean(0), z_values(port, jax_)):
        print(f"{name:24s} port {a:.6g}  jax {b:.6g}  z {v:+.2f}")
