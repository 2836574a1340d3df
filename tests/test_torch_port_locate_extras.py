"""The port's single-event locators and the legacy MLP travel time against
the JAX package: the particle swarm step for step on the draws
``jax.random`` makes (with and without the station hull), the PSO locator
with its hull and depth line-search on a planted deep event, single-event
DE and its Gauss-Newton covariance, and ``LegacyTravelTimes`` on JAX's
``m.init`` weights (full, relative and dropout paths; the weight round
trip)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tpu.geometry import Projection as JProjection
from genie_tpu.infer import locate as J
from genie_tpu.models.travel_time import HomogeneousTravelTime as JHomogeneous
from genie_tpu.models.travel_time import LegacyTravelTimes as JLegacy
from genie_tpu.utils import hull_halfspaces as jhull_halfspaces
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.infer import locate as T
from genie_tpu_torch.models.init import init_legacy_travel_times
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime, LegacyTravelTimes
from genie_tpu_torch.params import flatten_tree, load_into, to_flax
from genie_tpu_torch.utils import hull_halfspaces

LO = np.array([-80e3, -80e3, -40e3, -10.0], np.float32)
HI = np.array([80e3, 80e3, 2e3, 30.0], np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread runs them fastest, and with
    several test workers on the machine more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _travel_times():
    proj = (40.0, -124.0)
    return (JHomogeneous(JProjection.from_center(proj)),
            HomogeneousTravelTime(Projection.from_center(proj)))


def _deep_event():
    """tests/test_infer_components.py:387-404: 16 surface stations, a source
    at 22 km depth, P picks at every station, origin time 2 s."""
    rng = np.random.default_rng(7)
    jtt, _ = _travel_times()
    sta = rng.uniform(-50e3, 50e3, (16, 3)).astype(np.float32)
    sta[:, 2] = 0.0
    true_pos = np.array([5e3, -8e3, -22e3], np.float32)
    trv = np.asarray(jtt.from_cart(jnp.asarray(sta), jnp.asarray(true_pos[None])))[0]
    tp = (2.0 + trv[:, 0]).astype(np.float32)
    ip = np.arange(16, dtype=np.int32)
    ph = np.zeros((16, 1), np.float32)
    return sta, tp, ip, ph, np.ones(16, bool), true_pos, 2.0


def _planted_event():
    """tests/test_infer_components.py:172-200: 20 stations, P at all, S at
    every second one, origin time 4 s."""
    rng = np.random.default_rng(3)
    jtt, _ = _travel_times()
    sta = rng.uniform(-60e3, 60e3, (20, 3)).astype(np.float32)
    sta[:, 2] = 0.0
    true_pos = np.array([12e3, -20e3, -9e3], np.float32)
    trv = np.asarray(jtt.from_cart(jnp.asarray(sta), jnp.asarray(true_pos[None])))[0]
    tp, ip, ph = [], [], []
    for s in range(20):
        tp.append(4.0 + trv[s, 0]); ip.append(s); ph.append(0)
        if s % 2 == 0:
            tp.append(4.0 + trv[s, 1]); ip.append(s); ph.append(1)
    return (sta, np.array(tp, np.float32), np.array(ip, np.int32),
            np.array(ph, np.float32)[:, None], np.ones(len(tp), bool), true_pos, 4.0)


def _jax_draws(key, popsize, d, n_iter, hull):
    """The draws of JAX ``pso_minimize`` (locate.py:195-197, 210-225), in its
    key order."""
    k0, k1, key = jax.random.split(key, 3)
    init = (jax.random.uniform(k0, (popsize, d)), jax.random.normal(k1, (popsize, d)))
    steps = []
    for k in jax.random.split(key, n_iter):
        ka, kb, kc, kd = jax.random.split(k, 4)
        r = [jax.random.uniform(ka, (popsize, d)), jax.random.uniform(kb, (popsize, d))]
        if hull:
            r += [jax.random.uniform(kc, (popsize, d)), jax.random.normal(kd, (popsize, d))]
        steps.append([torch.from_numpy(np.array(a)) for a in r])
    return [torch.from_numpy(np.array(a)) for a in init], steps


@pytest.mark.parametrize("hull", [False, True])
def test_pso_steps_match_jax_on_its_draws(hull):
    """Five iterations at popsize 16 of the location objective: after every
    step the swarm's best and its cost within 1e-5 relative of a JAX run of
    the same length (the hull: that of the stations)."""
    sta, tp, ip, ph, mk, _, _ = _planted_event()
    jtt, ttt = _travel_times()
    jobj = J.make_location_objective(jtt.from_cart, jnp.asarray(sta), jnp.asarray(tp),
                                     jnp.asarray(ip), jnp.asarray(ph), jnp.asarray(mk))
    tobj_b = T.make_location_objective(
        ttt.from_cart, torch.from_numpy(sta), torch.from_numpy(tp)[None],
        torch.from_numpy(ip)[None], torch.from_numpy(ph)[None], torch.from_numpy(mk)[None])

    def tobj(c):
        return tobj_b(c[None])[0]

    A, b = hull_halfspaces(sta[:, :2])
    jA, jb = jhull_halfspaces(sta[:, :2])
    np.testing.assert_array_equal(A, jA)
    hull_t = (torch.as_tensor(A, dtype=torch.float32),
              torch.as_tensor(b, dtype=torch.float32)) if hull else None
    hull_j = dict(hull_A=jnp.asarray(A, jnp.float32),
                  hull_b=jnp.asarray(b, jnp.float32)) if hull else {}
    key = jax.random.PRNGKey(5)
    (u0, n0), steps = _jax_draws(key, 16, 4, 5, hull)
    lo, hi = torch.from_numpy(LO), torch.from_numpy(HI)
    state = T.pso_init(tobj, lo, hi, u0, n0, hull_t)
    for i, r in enumerate(steps):
        state = T.pso_step(tobj, state, lo, hi, *r, hull=hull_t)
        jx, jc = J.pso_minimize(jobj, jnp.asarray(LO), jnp.asarray(HI), key, popsize=16,
                                n_iter=i + 1, **hull_j)
        np.testing.assert_allclose(state.gbest.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-5 * np.abs(HI).max(), err_msg=f"step {i}")
        np.testing.assert_allclose(float(state.gbest_c), float(jc), rtol=1e-5)
    if hull:
        assert (state.gbest[:2].numpy() @ A.T + b <= 1e-6).all()


def test_pso_minimize_keeps_the_hull():
    """tests/test_infer_components.py:362-381: a target outside a square
    hull; the free swarm reaches it, the hull-bounded one stays inside."""
    pts = np.array([[0.0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    A, b = hull_halfspaces(pts)
    target = torch.tensor([25.0, 5.0])

    def obj(x):
        return torch.linalg.norm(x - target[None], dim=1)

    lo, hi = torch.tensor([-5.0, -5.0]), torch.tensor([30.0, 30.0])
    x_free, _ = T.pso_minimize(obj, lo, hi, torch.Generator().manual_seed(0),
                               popsize=64, n_iter=60)
    x_hull, _ = T.pso_minimize(obj, lo, hi, torch.Generator().manual_seed(0),
                               popsize=64, n_iter=60, hull_A=A, hull_b=b)
    assert float(x_free[0]) > 20.0
    assert ((x_hull.numpy() @ A.T + b) <= 1e-3).all()


def test_locate_source_pso_finds_the_deep_event():
    """The planted deep event of tests/test_infer_components.py:387-404
    through the station hull and the depth line-search: within its 5 km
    (epicentre) and 1 s, and inside the hull."""
    sta, tp, ip, ph, mk, true_pos, t0 = _deep_event()
    _, ttt = _travel_times()
    pos, t_org, cost = T.locate_source_pso(
        torch.Generator().manual_seed(2), ttt.from_cart, sta, tp, ip, ph, mk, LO, HI,
        popsize=128, n_iter=150, hull_points=sta, device="cpu")
    assert np.linalg.norm(pos.numpy()[:2] - true_pos[:2]) < 5e3
    assert abs(float(t_org) - t0) < 1.0
    A, b = hull_halfspaces(sta[:, :2])
    assert (pos.numpy()[:2] @ A.T + b <= 1e-6).all()
    assert np.isfinite(float(cost))


def test_locate_source_and_uncertainty_match_jax():
    """Single-event DE on the event of tests/test_infer_components.py:172-200
    within that test's 3 km and 0.5 s; the port's cost equals JAX's
    objective at the port's solution within 1e-5; the covariance at one
    solution within 1e-4 of its largest entry."""
    sta, tp, ip, ph, mk, true_pos, t0 = _planted_event()
    jtt, ttt = _travel_times()
    pos, t_org, cost = T.locate_source(torch.Generator().manual_seed(0), ttt.from_cart,
                                       sta, tp, ip, ph, mk, LO, HI, popsize=96,
                                       n_iter=120, device="cpu")
    assert pos.shape == (3,) and t_org.shape == () and cost.shape == ()
    assert np.linalg.norm(pos.numpy() - true_pos) < 3e3
    assert abs(float(t_org) - t0) < 0.5
    jobj = J.make_location_objective(jtt.from_cart, jnp.asarray(sta), jnp.asarray(tp),
                                     jnp.asarray(ip), jnp.asarray(ph), jnp.asarray(mk))
    x = np.concatenate((pos.numpy(), [float(t_org)]))[None].astype(np.float32)
    np.testing.assert_allclose(float(cost), float(jobj(jnp.asarray(x))[0]), rtol=1e-5,
                               atol=1e-6)
    cov = T.location_uncertainty(ttt.from_cart, sta, pos, t_org, tp, ip, ph, mk,
                                 device="cpu").numpy()
    jcov = np.asarray(J.location_uncertainty(jtt.from_cart, jnp.asarray(sta),
                                             jnp.asarray(pos.numpy()),
                                             float(t_org), jnp.asarray(tp),
                                             jnp.asarray(ip), jnp.asarray(ph),
                                             jnp.asarray(mk)))
    assert cov.shape == (4, 4) and np.isfinite(cov).all()
    np.testing.assert_allclose(cov, jcov, rtol=0, atol=1e-4 * np.abs(jcov).max())


def test_single_event_entry_points_raise_without_cuda(monkeypatch):
    sta, tp, ip, ph, mk, _, _ = _planted_event()
    _, ttt = _travel_times()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.locate_source(torch.Generator(), ttt.from_cart, sta, tp, ip, ph, mk, LO, HI)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.locate_source_pso(torch.Generator(), ttt.from_cart, sta, tp, ip, ph, mk, LO, HI)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.location_uncertainty(ttt.from_cart, sta, np.zeros(3), 0.0, tp, ip, ph, mk)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LegacyTravelTimes()


@pytest.fixture(scope="module")
def legacy():
    """JAX ``LegacyTravelTimes`` at its ``m.init`` weights and the port's
    module loaded with them; 40 sources × 12 stations in a 200 km box."""
    rng = np.random.default_rng(11)
    sta = rng.uniform(-100e3, 100e3, (12, 3)).astype(np.float32)
    src = rng.uniform(-100e3, 100e3, (40, 3)).astype(np.float32)
    src[:, 2] = rng.uniform(-30e3, 0.0, 40)
    jm = JLegacy()
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(sta), jnp.asarray(src))
    tree = jax.tree.map(np.asarray, params["params"])
    tm = load_into(LegacyTravelTimes(device="cpu"), tree)
    return jm, params, tree, tm, sta, src


@pytest.mark.parametrize("relative", [False, True])
def test_legacy_travel_times_match_jax(legacy, relative):
    jm, params, _, tm, sta, src = legacy
    jt, jmask = jm.apply(params, jnp.asarray(sta), jnp.asarray(src), relative=relative)
    with torch.no_grad():
        t, m = tm(torch.from_numpy(sta), torch.from_numpy(src), relative=relative)
    assert t.shape == (40, 12, 2) and m.shape == (40, 12, 2)
    jt, jmask = np.asarray(jt), np.asarray(jmask)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-5 * np.abs(jt).max())
    np.testing.assert_allclose(m.numpy(), jmask, rtol=1e-5, atol=1e-6)


def test_legacy_travel_times_dropout_and_weight_round_trip(legacy):
    """``train`` with drop_p 1 is the relative path, with drop_p 0 the full
    path (JAX's too); the flax tree survives ``to_flax`` exactly; the
    flax-default init has JAX's leaf shapes and zero biases."""
    jm, params, tree, tm, sta, src = legacy
    s, x = torch.from_numpy(sta), torch.from_numpy(src)
    with torch.no_grad():
        full = tm(s, x)
        rel = tm(s, x, relative=True)
        for p, want in ((1.0, rel), (0.0, full)):
            got = tm(s, x, train=True, drop_p=p, generator=torch.Generator().manual_seed(0))
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    jt1, _ = jm.apply(params, jnp.asarray(sta), jnp.asarray(src), train=True, drop_p=1.0,
                      rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(rel[0].numpy(), np.asarray(jt1), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jt1).max()))
    with pytest.raises(ValueError):
        tm(s, x, train=True)
    back = flatten_tree(to_flax(tm))
    flat = flatten_tree(tree)
    assert sorted(back) == sorted(flat) and len(flat) == 32
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fresh = init_legacy_travel_times(LegacyTravelTimes(device="cpu"),
                                     torch.Generator().manual_seed(0))
    fresh_flat = flatten_tree(to_flax(fresh))
    for k, v in flat.items():
        assert fresh_flat[k].shape == v.shape, k
        if k.endswith("bias"):
            assert not fresh_flat[k].any(), k
