"""The port's GraphDD relocation (``genie_tpu_torch/relocation/graphdd.py``)
against ``genie_tpu/relocation/graphdd.py`` on the clusters of
tests/test_graphdd.py.

Tolerances: residuals 1e-5 s and partials 1e-7 s/m; graphs built from the
same integer seed exactly, station neighbour rows as sets (top-k tie
order); forward Δx 1e-3 m, Δt and station statics 1e-5 s at JAX's init
weights carried across with ``params.transplant``; the loss and each of its
parts 1e-5 relative and every gradient leaf within 1e-4 × its own max
|g|, at JAX's init (zero biases) and after five JAX steps (there two
PReLU slopes, named at ``_F32_LIMITED``, within 1e-3 × their own);
parameters after those five steps (clipping and Adam) within 1e-4 × the
largest |value| of all leaves."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.relocation import graphdd as jg
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models.init import init_graphdd
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.params import flatten_tree, load_into, to_flax, transplant
from genie_tpu_torch.relocation import graphdd as tg

from tests.test_graphdd import make_cluster


def T(a):
    return torch.as_tensor(np.asarray(a))


def to_port(graph):
    """A JAX ``RelocGraph`` as the port's, field for field."""
    return tg.RelocGraph(*[None if v is None else T(v) for v in graph])


@pytest.fixture(scope="module")
def cluster():
    tt, sta, true_pos, true_t, init_pos, init_t, obs, mask = make_cluster()
    ptt = HomogeneousTravelTime(Projection.from_center((40.0, -124.0)))
    return dict(tt=tt, ptt=ptt, sta=sta, true_pos=true_pos, true_t=true_t,
                init_pos=init_pos, init_t=init_t, obs=obs, mask=mask)


def _jax_graphs(c, key=0, **kw):
    return jg.make_relocation_graphs(
        jax.random.PRNGKey(key), jnp.asarray(c["init_pos"]), jnp.asarray(c["init_t"]),
        jnp.asarray(c["obs"]), jnp.asarray(c["mask"]), jnp.asarray(c["sta"]), **kw)


# -- graph builders -------------------------------------------------------------

def test_build_catalog_data_matches_jax(cluster):
    c = cluster
    args = (c["init_pos"], c["init_t"], c["obs"], c["mask"])
    r_j, p_j = jg.build_catalog_data(c["tt"].from_cart, jnp.asarray(c["sta"]),
                                     *map(jnp.asarray, args))
    r, p = tg.build_catalog_data(c["ptt"].from_cart, T(c["sta"]), *map(T, args))
    assert p.shape == (24, 14, 2, 3)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), atol=1e-7, rtol=0)


def test_pruning_helpers_match_jax():
    rng = np.random.default_rng(5)
    resid = rng.normal(0, 1.5, (20, 9, 2)).astype(np.float32)
    mask = (rng.random((20, 9, 2)) < 0.8).astype(np.float32)
    trv = rng.uniform(0.5, 30.0, (20, 9, 2)).astype(np.float32)
    for t in (None, trv):
        want = jg.prune_picks(jnp.asarray(resid), jnp.asarray(mask),
                              trv=None if t is None else jnp.asarray(t))
        got = tg.prune_picks(T(resid), T(mask), trv=None if t is None else T(t))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = rng.uniform(-80e3, 80e3, (20, 3)).astype(np.float32)
    smask = rng.random(20) < 0.9
    want = jg.drop_isolated_sources(jnp.asarray(pos), jnp.asarray(smask), jnp.asarray(mask),
                                    min_picks=14, max_nn_dist=50e3)
    got = tg.drop_isolated_sources(T(pos), T(smask), T(mask), min_picks=14,
                                   max_nn_dist=50e3)
    assert 0 < int(got.sum()) < 20
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pick_budget_selection_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        cnt = rng.integers(0, 30, int(rng.integers(1, 16)))
        budget = int(rng.integers(1, 200))
        np.testing.assert_array_equal(tg.select_sources_by_pick_budget(cnt, budget),
                                      jg.select_sources_by_pick_budget(cnt, budget))


@pytest.mark.parametrize("case", ["default", "tiers"])
def test_make_relocation_graphs_matches_jax(cluster, case):
    """Graphs from the integer that JAX draws from its key: every field
    identical, the station neighbour rows equal as sets."""
    c = dict(cluster)
    kw = dict(n_graphs=3, graph_size=24, k_src=6, k_sta=5, max_pair_dist=20e3)
    key = 0
    if case == "tiers":
        c.update(zip(("tt", "sta", "true_pos", "true_t", "init_pos", "init_t", "obs",
                      "mask"), make_cluster(n_ev=40, n_sta=20)))
        c["mask"][:, -4:, :] = 0.0
        kw.update(n_graphs=2, k_src=5, n_seed=4, sta_budget=16)
        key = 2
    want = _jax_graphs(c, key, **kw)
    seed = int(jax.random.randint(jax.random.PRNGKey(key), (), 0, 2**31 - 1))
    got = tg.make_relocation_graphs(seed, c["init_pos"], c["init_t"], c["obs"],
                                    c["mask"], c["sta"], device="cpu", **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in tg.RelocGraph._fields:
            a, b = getattr(g, name), getattr(w, name)
            if b is None:
                assert a is None, name
            elif name == "sta_nbr":
                assert a.shape == b.shape
                for ra, rb in zip(a.numpy(), np.asarray(b)):
                    assert set(ra.tolist()) == set(rb.tolist())
            else:
                assert a.dtype == {np.dtype(np.float32): torch.float32,
                                   np.dtype(np.int32): torch.int32,
                                   np.dtype(bool): torch.bool}[np.asarray(b).dtype], name
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_attachments_match_jax(cluster, tmp_path):
    c = cluster
    jgraph = _jax_graphs(c, n_graphs=1, graph_size=24, k_src=6, k_sta=5,
                         max_pair_dist=20e3)[0]
    g = to_port(jgraph)
    ids = np.asarray(jgraph.node_ids)[np.asarray(jgraph.src_mask)]
    sta_names = np.array([f"S{i:02d}" for i in range(len(c["sta"]))])
    s0, s1 = (int(v) for v in np.asarray(jgraph.sta_sel)[:2])
    (tmp_path / "dt.cc").write_text(
        f"# {ids[0] + 1} {ids[1] + 1} 0.0\n{sta_names[s0]} 0.25 1.0 P\n"
        f"{sta_names[s1]} 0.40 0.5 S\n# {ids[2] + 1} 999 0.0\n{sta_names[s0]} 0.1 1.0 P\n"
        f"# {ids[3] + 1} {ids[4] + 1} 0.0\n{sta_names[s1]} -0.3 0.8 S\n")
    dt_j = jg.load_dtcc(tmp_path / "dt.cc", sta_names)
    dt = tg.load_dtcc(tmp_path / "dt.cc", sta_names)
    for k in dt_j:
        np.testing.assert_array_equal(dt[k], dt_j[k], err_msg=k)
    with pytest.raises(ValueError):
        tg.load_dtcc(tmp_path / "dt.cc", sta_names[:1])
    pairs = ((jg.attach_dtcc(jgraph, dt_j, n_dt=8), tg.attach_dtcc(g, dt, n_dt=8)),
             (jg.attach_reference(jgraph, ids[:5], c["true_pos"][ids[:5]],
                                  c["true_t"][ids[:5]]),
              tg.attach_reference(g, T(ids[:5]), c["true_pos"][ids[:5]],
                                  c["true_t"][ids[:5]])))
    for w, a in pairs:
        for name in tg.RelocGraph._fields:
            if getattr(w, name) is not None:
                np.testing.assert_array_equal(getattr(a, name).numpy(),
                                              np.asarray(getattr(w, name)), err_msg=name)
    assert int(pairs[0][1].dt_mask.sum()) == 3 and int(pairs[1][1].ref_mask.sum()) == 5


# -- model, loss, training ------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(cluster):
    """A JAX graph, its dt.cc and reference variants, and JAX's init
    weights of a 2-round GNNLocation, with and without memory."""
    c = cluster
    jgraph = _jax_graphs(c, n_graphs=2, graph_size=24, k_src=6, k_sta=5,
                         max_pair_dist=20e3)[0]
    ids = np.asarray(jgraph.node_ids)[np.asarray(jgraph.src_mask)]
    sc = jnp.asarray(c["sta"])[jgraph.sta_sel]
    s0 = int(np.asarray(jgraph.sta_sel)[0])
    dtcc = {"src_a": ids[[0, 2]].astype(np.int64), "src_b": ids[[1, 3]].astype(np.int64),
            "sta": np.array([s0, s0]), "ph": np.array([0, 1]), "w": np.array([1.0, 0.5]),
            "dt": np.array([0.25, -0.4])}
    variants = {"plain": jgraph, "dtcc": jg.attach_dtcc(jgraph, dtcc, n_dt=4),
                "reference": jg.attach_reference(jgraph, ids[:6], c["true_pos"][ids[:6]],
                                                 c["true_t"][ids[:6]])}
    resid, partials = jg.build_catalog_data(c["tt"].from_cart, sc, jgraph.src_pos,
                                            jgraph.src_time, jgraph.obs_time,
                                            jgraph.obs_mask)
    inits = {}
    for mem in (False, True):
        memory = (jnp.asarray(np.random.default_rng(1).normal(0, 0.3, (24, 4)),
                              jnp.float32) if mem else None)
        feat, pm = jg.make_feature_tensor(jgraph, sc, resid, partials, memory=memory)
        model = jg.GNNLocation(n_rounds=2)
        params = model.init(jax.random.PRNGKey(1), feat, jgraph.src_nbr, jgraph.sta_nbr,
                            pm, jgraph.src_pos, sc, memory=memory)
        inits[mem] = (model, params, memory, feat, pm, sc)
    model = inits[False][0]
    loss_j = jg.make_dd_loss(model, c["tt"].from_cart, jnp.asarray(c["sta"]))
    grad_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))
    return dict(variants=variants, inits=inits, grad_j=grad_j)


def _port_model(params, memory: bool):
    return load_into(tg.GNNLocation(n_rounds=2, use_memory=memory),
                     jax.tree.map(np.asarray, params["params"]))


@pytest.mark.parametrize("memory", [False, True])
def test_forward_matches_jax(setup, memory):
    model, params, mem, feat, pm, sc = setup["inits"][memory]
    g = setup["variants"]["plain"]
    want = jax.jit(model.apply)(params, feat, g.src_nbr, g.sta_nbr, pm, g.src_pos, sc,
                                memory=mem)
    port = _port_model(params, memory)
    with torch.no_grad():
        got = port(T(feat), T(g.src_nbr), T(g.sta_nbr), T(pm), T(g.src_pos), T(sc),
                   memory=None if mem is None else T(mem))
    for a, b, tol in zip(got, want, (1e-3, 1e-5, 1e-5)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)
    assert float(np.abs(np.asarray(want[0])).max()) > 1.0


@pytest.fixture(scope="module")
def trained(setup, cluster):
    """JAX's weights and last loss after five training steps from JAX's
    init over two graphs (the plain one twice)."""
    return jg.train_graphdd(jax.random.PRNGKey(1), jg.GNNLocation(n_rounds=2),
                            cluster["tt"].from_cart, jnp.asarray(cluster["sta"]),
                            [setup["variants"]["plain"]] * 2, n_steps=5)


# After five steps two PReLU slopes' gradients are sums over every cell
# that cancel to 1e-5 / 2e-5 of the largest |g|, and f32 resolves them
# only to about 2e-4 of themselves. Against float64 gradients from the JAX
# package, read_src/fc1/PReLU_0/a ("plain") is 1.4e-8 off in JAX's own f32
# and 6.0e-9 in the port's (2.6e-4 of its 3.3e-5 apart from JAX's f32);
# _DDConv_1/PReLU_1/a ("dtcc") is 2.0e-10 off in the port's f32, 1.7e-4 of
# its 1.2e-6. These two are held to 1e-3 × their own max |g| there; every
# leaf at init weights, where a tie-rule fault would show, to 1e-4.
_F32_LIMITED = {"read_src/fc1/PReLU_0/a", "_DDConv_1/PReLU_1/a"}


@pytest.mark.parametrize("weights", ["init", "trained"])
@pytest.mark.parametrize("variant", ["plain", "dtcc", "reference"])
def test_loss_and_gradients_match_jax(setup, cluster, trained, weights, variant):
    model, params, *_ = setup["inits"][False]
    if weights == "trained":
        params = trained[0]
    jgraph = setup["variants"][variant]
    (total_j, (parts_j, _, _)), grads_j = setup["grad_j"](params, jgraph)
    port = _port_model(params, False)
    loss = tg.make_dd_loss(port, cluster["ptt"].from_cart, T(cluster["sta"]))
    total, (parts, _, _) = loss(to_port(jgraph))
    total.backward()
    np.testing.assert_allclose(float(total), float(total_j), rtol=1e-5)
    for k in parts_j:
        np.testing.assert_allclose(float(parts[k]), float(parts_j[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert (float(parts_j["dtcc"]) > 0) == (variant == "dtcc")
    assert (float(parts_j["cal"]) > 0) == (variant == "reference")
    got = flatten_tree(to_flax({n: p.grad for n, p in port.named_parameters()}))
    want = flatten_tree(jax.tree.map(np.asarray, grads_j["params"]))
    assert set(got) == set(want) and len(want) == 88
    own = {k: float(np.abs(v).max()) for k, v in want.items()}
    rtol = {k: 1e-3 if weights == "trained" and k in _F32_LIMITED else 1e-4 for k in want}
    bad = {k: (float(np.abs(got[k] - want[k]).max()), own[k]) for k in want
           if float(np.abs(got[k] - want[k]).max()) > rtol[k] * own[k]}
    assert max(own.values()) > 0 and not bad, bad


@pytest.mark.parametrize("norm", [0.3, 1.0, 7.5])
def test_clip_by_global_norm_matches_optax(norm):
    import optax

    rng = np.random.default_rng(int(norm * 10))
    tree = {f"p{i}": rng.normal(size=s).astype(np.float32)
            for i, s in enumerate([(4, 3), (5,), (), (2, 2, 2)])}
    scale = norm / np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                               for v in tree.values()))
    tree = {k: np.array(v * scale, np.float32) for k, v in tree.items()}
    want, _ = optax.clip_by_global_norm(1.0).update(tree, optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in tree.values()]
    for p, v in zip(params, tree.values()):
        p.grad = T(v).clone()
    got = tg.clip_by_global_norm_(params, 1.0)
    np.testing.assert_allclose(float(got), norm, rtol=1e-5)
    for p, k in zip(params, tree):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)


def test_train_graphdd_five_steps_match_jax(setup, cluster, trained):
    """Five steps over two graphs from JAX's init weights (the gradient
    clipping and Adam): every parameter within 1e-4 × the largest |value|
    of all leaves."""
    model, params, *_ = setup["inits"][False]
    want, loss_j = trained
    jgraphs = [setup["variants"]["plain"]] * 2
    port = _port_model(params, False)
    port, loss = tg.train_graphdd(None, port, cluster["ptt"].from_cart, cluster["sta"],
                                  [to_port(g) for g in jgraphs], n_steps=5, device="cpu",
                                  keep_weights=True)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-4)
    got, want = flatten_tree(to_flax(port)), flatten_tree(jax.tree.map(np.asarray,
                                                                       want["params"]))
    start = flatten_tree(jax.tree.map(np.asarray, params["params"]))
    assert max(float(np.abs(want[k] - start[k]).max()) for k in want) > 1e-3
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k


def test_transplant_round_trip_full_width(setup):
    """JAX's default ``GNNLocation()`` tree: 163 leaves, 72,811 parameters,
    strict ``load_into`` and ``to_flax`` back, value for value."""
    *_, feat, pm, sc = setup["inits"][False]
    g = setup["variants"]["plain"]
    params = jg.GNNLocation().init(jax.random.PRNGKey(3), feat, g.src_nbr, g.sta_nbr, pm,
                                   g.src_pos, sc)
    flat = flatten_tree(jax.tree.map(np.asarray, params["params"]))
    assert len(flat) == 163 and sum(v.size for v in flat.values()) == 72811
    assert flat["embed_inpt/Dense_0/kernel"].shape == (20, 10)
    port = load_into(tg.GNNLocation(), jax.tree.map(np.asarray, params["params"]))
    assert sum(p.numel() for p in port.parameters()) == 72811
    back = flatten_tree(to_flax(port))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert set(transplant(params["params"])) == set(port.state_dict())


def test_init_graphdd_flax_defaults():
    model = init_graphdd(tg.GNNLocation(), torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith(".a"):
            assert float(p) == 0.25
        elif name.endswith(".bias"):
            assert not p.detach().any(), name
        else:
            s = 1.0 / np.sqrt(p.shape[1])
            assert float(p.detach().abs().max()) <= 2.0 * s / 0.87962566103423978 + 1e-6
