"""GraphDD training through the port (``genie_tpu_torch/relocation/
graphdd.py``) on the clusters of tests/test_graphdd.py: the relocation
must improve locations as the JAX package's does, and the memory input
must train. The parity of the pieces with the JAX package is held by
tests/test_torch_port_graphdd.py."""

import numpy as np
import jax
import pytest
import torch

from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.relocation import graphdd as tg

from tests.test_graphdd import make_cluster


@pytest.fixture(scope="module")
def cluster():
    tt, sta, true_pos, true_t, init_pos, init_t, obs, mask = make_cluster()
    ptt = HomogeneousTravelTime(Projection.from_center((40.0, -124.0)))
    return dict(ptt=ptt, sta=sta, true_pos=true_pos, init_pos=init_pos, init_t=init_t,
                obs=obs, mask=mask)


def test_graphdd_relocation_improves_locations(cluster):
    """tests/test_graphdd.py's relocation case through the port, from the
    port's own flax-default initialisation, in 600 steps where the JAX test
    takes 1200 (the port reaches 0.22-0.35 of the initial median error by
    then on these graphs, for two init seeds)."""
    c = cluster
    seed = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 2**31 - 1))
    graphs = tg.make_relocation_graphs(seed, c["init_pos"], c["init_t"], c["obs"],
                                       c["mask"], c["sta"], n_graphs=3, graph_size=24,
                                       k_src=6, k_sta=5, max_pair_dist=20e3, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # a graph of 24 × 14 runs fastest on one thread
    try:
        model, loss = tg.train_graphdd(torch.Generator().manual_seed(1),
                                       tg.GNNLocation(n_rounds=3), c["ptt"].from_cart,
                                       c["sta"], graphs, n_steps=600, lr=3e-3,
                                       device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(loss)
    g = graphs[0]
    new_pos, new_t, sta_corr = tg.relocate(model, c["ptt"].from_cart, c["sta"], g)
    rows = np.array([np.argmin(np.linalg.norm(c["init_pos"] - p, axis=1))
                     for p in g.src_pos.numpy()])
    err_before = np.linalg.norm(g.src_pos.numpy() - c["true_pos"][rows], axis=1)
    err_after = np.linalg.norm(new_pos.numpy() - c["true_pos"][rows], axis=1)
    assert np.median(err_after) < 0.7 * np.median(err_before)
    assert torch.isfinite(sta_corr).all() and torch.isfinite(new_t).all()


def test_train_graphdd_with_memory_runs(cluster):
    c = cluster
    graphs = tg.make_relocation_graphs(7, c["init_pos"], c["init_t"], c["obs"], c["mask"],
                                       c["sta"], n_graphs=2, graph_size=24, k_src=6,
                                       k_sta=5, max_pair_dist=20e3, device="cpu")
    model, loss = tg.train_graphdd(torch.Generator().manual_seed(3),
                                   tg.GNNLocation(n_rounds=2, use_memory=True),
                                   c["ptt"].from_cart, c["sta"], graphs, n_steps=20,
                                   lr=2e-3, device="cpu")
    assert np.isfinite(loss)
    with pytest.raises(ValueError):
        tg.train_graphdd(None, tg.GNNLocation(n_rounds=2), c["ptt"].from_cart, c["sta"],
                         graphs, n_steps=1, device="cpu")
    with pytest.raises(ValueError):
        tg.relocate(model, c["ptt"].from_cart, c["sta"], graphs[0])
