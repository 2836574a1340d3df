"""The port's PINN training against the JAX package: the importance
sampler, the five-term loss with its eikonal gradient and the parameter
gradients through it (a second derivative), Adam after global-norm
clipping, optax's cosine schedule, the steps of ``scripts/nc_pinn.py``
(bank, velocity prior, R²) and the artifact, read by JAX ``make_trv``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genie_tpu.config import Config as JConfig
from genie_tpu.geometry import Projection as JProjection
from genie_tpu.models import travel_time_pinn as J
from genie_tpu.workflow import make_trv as jmake_trv
from genie_tpu_torch import workflow as twf
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.io import save_pinn
from genie_tpu_torch.models import travel_time_pinn as T
from genie_tpu_torch.models.init import init_pinn
from genie_tpu_torch.params import (_load_pickle, _weight_tree, flatten_tree,
                                    load_into, load_pinn, to_flax)
from genie_tpu_torch.train.optim import cosine_decay_schedule

PINN = "projects/NC_EHZ/Grids/pinn_nc.pkl"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These are small CPU ops: one intra-op thread runs them fastest, and
    with several test workers on the machine more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
PROFILE = (np.array([-40e3, -20e3, -5e3, 0.0, 5e3], np.float32),
           np.array([7884, 6739, 5225, 4610, 4528], np.float32),
           np.array([4430, 3788, 2935, 2590, 2544], np.float32))


def _jax_init(scales):
    return J.TravelTimesPN().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3)), jnp.zeros((1, 3)),
        scales.conversion_factor, scales.v_mean, scales.t_scale,
        method=J.TravelTimesPN.init_all)


def _case(weights):
    """(JAX params, port model, JAX scales, port scales) at JAX's init
    weights or at ``pinn_nc.pkl``'s."""
    if weights == "init":
        kw = dict(center=[761.5, 2802.0, -24632.0], x_scale=504000.0, t_scale=138.65,
                  v_mean=[6366.0, 3577.9])
        sj = J.scales_from_domain(**kw)
        params = jax.tree.map(np.asarray, _jax_init(sj))
        st = T.scales_from_domain(**kw)
    else:
        blob = _load_pickle(PINN)
        sj = J.ScaleParams(**{k: jnp.asarray(v) for k, v in blob["scales"].items()})
        st = T.ScaleParams(**{k: torch.as_tensor(np.asarray(v, np.float32))
                              for k, v in blob["scales"].items()})
        params = {"params": _weight_tree(blob)}
    model = load_into(T.TravelTimesPN(), params["params"])
    return params, model, sj, st


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    sta = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    sta[:, 2] = rng.uniform(0.0, 0.01, n)
    src = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    src[:, 2] = rng.uniform(-0.08, 0.005, n)
    d = np.linalg.norm(sta - src, axis=1, keepdims=True)
    t = np.concatenate((d * 504000.0 / 6000.0, d * 504000.0 / 3400.0), 1) / 138.65
    return sta, src, (t * rng.uniform(0.9, 1.1, t.shape)).astype(np.float32)


def _priors(scales_j):
    L, tau = float(scales_j.x_scale), float(scales_j.t_scale)
    zc = float(scales_j.center[2])
    depths, vp, vs = PROFILE

    def vj(src_n):
        z = src_n[:, 2] * L + zc
        return jnp.stack((jnp.interp(z, depths, vp), jnp.interp(z, depths, vs)), 1) * tau / L

    def vt(src_n):
        z = src_n[:, 2] * L + zc
        prof = [torch.as_tensor(a) for a in PROFILE]
        return torch.stack((T.interp(z, prof[0], prof[1]), T.interp(z, prof[0], prof[2])),
                           1) * tau / L

    return vj, vt


def test_importance_sample_volume_equals_jax():
    rng = np.random.default_rng(2)
    Tp = rng.uniform(0.0, 30.0, (21, 23, 19)).astype(np.float32)
    Ts = (Tp * 1.75).astype(np.float32)
    args = (Tp, Ts, np.array([-10e3, -11e3, -9e3]), 1000.0, np.array([500.0, -2e3, 0.0]),
            1001)
    want = J.importance_sample_volume(np.random.default_rng(7), *args)
    got = T.importance_sample_volume(np.random.default_rng(7), *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_interp_clamps_like_numpy():
    xp = torch.tensor([-3.0, -1.0, 0.0, 2.0])
    fp = torch.tensor([1.0, 4.0, -2.0, 5.0])
    x = torch.tensor([-9.0, -3.0, -2.0, -1.0, 0.5, 2.0, 7.0])
    np.testing.assert_allclose(T.interp(x, xp, fp).numpy(),
                               np.interp(x.numpy(), xp.numpy(), fp.numpy()), rtol=1e-6)


@pytest.mark.parametrize("weights", ["init", "pinn_nc"])
@pytest.mark.parametrize("prior", [False, True])
def test_loss_eikonal_and_gradients_match_jax(weights, prior):
    params, model, sj, st = _case(weights)
    vj, vt = _priors(sj)
    sta, src, t = _batch(256)
    (tot_j, parts_j), g_j = jax.jit(jax.value_and_grad(
        J.make_pinn_loss(J.TravelTimesPN(), sj, v_init_fn=vj if prior else None),
        has_aux=True))(params, sta, src, t)
    tot_t, parts_t = T.make_pinn_loss(model, st, v_init_fn=vt if prior else None)(
        *(torch.as_tensor(a) for a in (sta, src, t)))
    tot_t.backward()
    for k, v in (("total", tot_j), *parts_j.items()):
        got = float((tot_t if k == "total" else parts_t[k]).detach())
        assert abs(got - float(v)) <= 1e-5 * abs(float(v)), (k, got, float(v))

    def t_raw(x, s):
        return J.TravelTimesPN().apply(params, s[None], x[None], sj.conversion_factor,
                                       sj.v_mean, method=J.TravelTimesPN.time_norm)[0]

    eik_j = np.asarray(jax.jit(jax.vmap(jax.jacrev(t_raw)))(src, sta))
    eik_t, _ = T.eikonal_gradient(model, torch.as_tensor(sta), torch.as_tensor(src),
                                  st.conversion_factor, st.v_mean, create_graph=False)
    assert eik_t.shape == eik_j.shape == (256, 2, 3)
    assert np.abs(eik_t.numpy() - eik_j).max() <= 1e-5 * np.abs(eik_j).max()

    gj = flatten_tree(jax.tree.map(np.asarray, g_j)["params"])
    gt = flatten_tree(to_flax({n: p.grad for n, p in model.named_parameters()}))
    assert sorted(gt) == sorted(gj) and len(gj) == 35
    for k in gj:
        assert np.abs(gt[k] - gj[k]).max() <= 1e-4 * np.abs(gj[k]).max(), k


def test_train_pinn_five_steps_match_jax():
    """Five Adam steps after clipping on one fixed batch, from the same
    weights (JAX's ``train_pinn`` initialises from ``PRNGKey(0)``)."""
    params, model, sj, st = _case("init")
    vj, vt = _priors(sj)
    sta, src, t = _batch(128, seed=3)
    want = J.train_pinn(jax.random.PRNGKey(5), J.TravelTimesPN(), sj,
                        lambda key, n: (sta, src, t), n_steps=5, batch=128, lr=3e-3,
                        v_init_fn=vj)
    batch = tuple(torch.as_tensor(a) for a in (sta, src, t))
    got, hist = T.train_pinn(None, model, st, lambda g, n: batch, n_steps=5, batch=128,
                             lr=3e-3, v_init_fn=vt, keep_weights=True, device="cpu")
    assert set(hist) == {"total", "data", "pde", "bound", "sign"}
    assert all(v.shape == (5,) for v in hist.values())
    w = flatten_tree(jax.tree.map(np.asarray, want)["params"])
    g = flatten_tree(to_flax(got))
    largest = max(np.abs(v).max() for v in w.values())
    moved = max(np.abs(w[k] - flatten_tree(params["params"])[k]).max() for k in w)
    assert moved > 1e-3
    for k in w:
        assert np.abs(g[k] - w[k]).max() <= 1e-4 * largest, k


def test_cosine_schedule_matches_optax():
    want = optax.cosine_decay_schedule(1e-3, 40000, alpha=0.02)
    got = cosine_decay_schedule(1e-3, 40000, alpha=0.02)
    for count in (0, 1, 20000, 39999, 40000, 50000):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)
    with pytest.raises(ValueError):
        cosine_decay_schedule(1e-3, 0)


def test_init_pinn_is_flax_default():
    model = init_pinn(T.TravelTimesPN(), torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert (p == 0).all(), name
        elif name.endswith(".a"):
            assert float(p) == 0.25
    w = model.fc1_2.weight.detach()
    assert abs(float(w.std()) - 50 ** -0.5) < 0.02 and float(w.abs().max()) <= 2.0 * 50 ** -0.5 / 0.8796 + 1e-6


def test_pinn_learns_homogeneous_medium():
    """Twin of tests/test_pinn.py::test_pinn_learns_homogeneous_medium: short
    training on exact homogeneous times brings predictions near t = d/v."""
    v_true, L = 5000.0, 100e3
    scales = T.scales_from_domain([0.0, 0.0, -20e3], L, L / 3000.0, [v_true, v_true / 1.8])
    tau = float(scales.t_scale)

    def sample_fn(gen, n):
        sta = torch.rand((n, 3), generator=gen) - 0.5
        sta[:, 2] = 0.0
        src = torch.rand((n, 3), generator=gen) - 0.5
        d = torch.linalg.norm((sta - src) * L, dim=-1, keepdim=True)
        return sta, src, torch.cat((d / v_true, d / (v_true / 1.8)), 1) / tau

    model, hist = T.train_pinn(torch.Generator().manual_seed(0), T.TravelTimesPN(), scales,
                               sample_fn, n_steps=300, batch=512, lr=2e-3, device="cpu")
    assert torch.isfinite(hist["total"]).all()
    tt = T.TravelTimePN(model.requires_grad_(False), scales)
    rng = np.random.default_rng(0)
    sta = rng.uniform(-0.4 * L, 0.4 * L, (10, 3)).astype(np.float32)
    sta[:, 2] = 0.0
    src = rng.uniform(-0.4 * L, 0.4 * L, (20, 3)).astype(np.float32)
    src[:, 2] -= 20e3
    c = scales.center.numpy()
    got = tt.from_cart(torch.as_tensor(sta + c), torch.as_tensor(src + c)).numpy()
    d = np.linalg.norm(src[:, None] - sta[None, :], axis=-1)
    for ph, v in ((0, v_true), (1, v_true / 1.8)):
        want = d / v
        assert np.median(np.abs(got[:, :, ph] - want) / np.maximum(want, 1.0)) < 0.10


def _tables(tmp_path, n_sta=4):
    cfg = Config()
    cfg.region.lat_range, cfg.region.lon_range = (39.9, 40.1), (-124.1, -123.9)
    cfg.region.degree_padding, cfg.region.depth_range = 0.02, (-12e3, 1e3)
    cfg.travel_time.dx = 1500.0
    proj = Projection.from_center(cfg.region.center)
    rng = np.random.default_rng(4)
    sta_lla = np.stack((rng.uniform(39.92, 40.08, n_sta), rng.uniform(-124.08, -123.92, n_sta),
                        rng.uniform(0.0, 900.0, n_sta)), axis=1)
    twf.build_fmm_tables(cfg, proj, sta_lla, tmp_path, verbose=False)
    files = [tmp_path / f"travel_time_grid_station_{j}.npz" for j in range(n_sta)]
    return cfg, proj.to_cart_np(sta_lla).astype(np.float32), files


def test_nc_pinn_steps_match_the_script(tmp_path):
    """``pinn_sample_bank``, ``pinn_velocity_prior`` and ``pinn_velocity_r2``
    against ``scripts/nc_pinn.py``'s own statements (:63-117, :166-176),
    transcribed here with the JAX package's sampler and R²."""
    cfg, sta_cart, files = _tables(tmp_path)
    per_sta, every = 300, 3
    bank = twf.pinn_sample_bank(cfg, sta_cart, files, np.random.default_rng(0),
                                per_sta=per_sta, holdout_every=every)

    rng = np.random.default_rng(0)                      # nc_pinn.py:63-104
    z0 = np.load(files[0])
    origin, h = z0["origin"], float(z0["h"])
    extent = np.asarray(z0["Tp"].shape) * h
    center = origin + extent / 2
    L = float(extent.max())
    srcs, stas, ts, v_srcs, v_ts, h_srcs, h_ts = [], [], [], [], [], [], []
    t_max = 0.0
    for j, f in enumerate(files):
        z = np.load(f)
        t_max = max(t_max, float(z["Ts"].max()))
        held = j % every == 0
        n = 4096 if held else per_sta + 2048
        src, t = J.importance_sample_volume(rng, z["Tp"], z["Ts"], z["origin"],
                                            float(z["h"]), sta_cart[j], n)
        if held:
            h_srcs.append(src)
            h_ts.append(t)
        else:
            srcs.append(src[:per_sta])
            ts.append(t[:per_sta])
            stas.append(np.broadcast_to(sta_cart[j], (per_sta, 3)))
            v_srcs.append(src[per_sta:])
            v_ts.append(t[per_sta:])
    sj = J.scales_from_domain(center, L, t_max, [float(np.mean(cfg.velocity.vp)),
                                                 float(np.mean(cfg.velocity.vs))])
    tau = float(sj.t_scale)
    np.testing.assert_array_equal(bank.sta, ((np.concatenate(stas) - center) / L)
                                  .astype(np.float32))
    np.testing.assert_array_equal(bank.src, ((np.concatenate(srcs) - center) / L)
                                  .astype(np.float32))
    np.testing.assert_array_equal(bank.t, (np.concatenate(ts) / tau).astype(np.float32))
    np.testing.assert_array_equal(bank.val[1], np.concatenate(v_srcs))
    np.testing.assert_array_equal(bank.val[2], np.concatenate(v_ts))
    np.testing.assert_array_equal(bank.cross_val[1], np.concatenate(h_srcs))
    np.testing.assert_array_equal(bank.cross_val[2], np.concatenate(h_ts))
    assert len(bank.cross_val[0]) == 2 * 4096 and len(bank.val[0]) == 2 * 2048
    for k in ("center", "x_scale", "t_scale", "v_mean"):
        np.testing.assert_array_equal(getattr(bank.scales, k).numpy(), np.asarray(getattr(sj, k)))

    depths = jnp.asarray(cfg.velocity.depths, jnp.float32)   # nc_pinn.py:108-117
    vp_prof = jnp.asarray(cfg.velocity.vp, jnp.float32)
    vs_prof = jnp.asarray(cfg.velocity.vs, jnp.float32)

    def v_init_fn(src_n):
        z_phys = src_n[:, 2] * L + center[2]
        return jnp.stack((jnp.interp(z_phys, depths, vp_prof),
                          jnp.interp(z_phys, depths, vs_prof)), axis=1) * tau / L

    src_n = bank.src[:500]
    np.testing.assert_allclose(twf.pinn_velocity_prior(cfg, bank.scales)(
        torch.as_tensor(src_n)).numpy(), np.asarray(v_init_fn(src_n)), rtol=1e-6)

    params = jax.tree.map(np.asarray, _jax_init(sj))         # nc_pinn.py:166-176
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    src_r2 = rng_j.uniform(-0.5, 0.5, (20000, 3)).astype(np.float32)
    zn = (origin[2] - center[2]) / L, (origin[2] + extent[2] - center[2]) / L
    src_r2[:, 2] = rng_j.uniform(zn[0], zn[1], 20000).astype(np.float32)
    z_phys = src_r2[:, 2] * L + center[2]
    v_true = np.stack((np.interp(z_phys, cfg.velocity.depths, cfg.velocity.vp),
                       np.interp(z_phys, cfg.velocity.depths, cfg.velocity.vs)), axis=1)
    want = J.velocity_r2(J.TravelTimesPN(), params, sj, src_r2, v_true)
    got = twf.pinn_velocity_r2(load_into(T.TravelTimesPN(), params["params"]), cfg, bank,
                               rng_t)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_artifact_read_by_jax_make_trv(tmp_path):
    """A PINN written by the port (``io.save_pinn``) after a few training
    steps from its own tables: JAX ``make_trv`` and the port's
    ``load_pinn`` read it, and give the in-memory model's times."""
    cfg, sta_cart, files = _tables(tmp_path)
    bank = twf.pinn_sample_bank(cfg, sta_cart, files, np.random.default_rng(0),
                                per_sta=500, holdout_every=4)
    model, _ = T.train_pinn(torch.Generator().manual_seed(1), T.TravelTimesPN(), bank.scales,
                            twf.pinn_bank_sampler(bank, "cpu"), n_steps=20, batch=256,
                            lr=cosine_decay_schedule(1e-3, 40000, 0.02),
                            v_init_fn=twf.pinn_velocity_prior(cfg, bank.scales),
                            device="cpu")
    trv = T.TravelTimePN(model.requires_grad_(False), bank.scales)
    metrics = {"val": twf.pinn_error_stats(trv, *bank.val),
               "cross_val": twf.pinn_error_stats(trv, *bank.cross_val),
               "velocity_r2": np.asarray(twf.pinn_velocity_r2(
                   model, cfg, bank, np.random.default_rng(2))).tolist()}
    assert all(np.isfinite(v) for m in ("val", "cross_val") for v in metrics[m].values())
    path = save_pinn(tmp_path / "Grids" / "pinn.pkl", model, bank.scales, metrics)
    assert not list((tmp_path / "Grids").glob(".tmp*"))

    jcfg = JConfig()
    jtrv = jmake_trv(jcfg, JProjection.from_center(cfg.region.center), path)
    assert isinstance(jtrv, J.TravelTimePN)
    src = np.concatenate((bank.val[1][:40], bank.cross_val[1][:40]))
    want = np.asarray(jtrv.from_cart(jnp.asarray(sta_cart), jnp.asarray(src)))
    with torch.no_grad():
        got = trv.from_cart(torch.as_tensor(sta_cart), torch.as_tensor(src)).numpy()
        back = load_pinn(path, device="cpu").from_cart(torch.as_tensor(sta_cart),
                                                        torch.as_tensor(src)).numpy()
    assert want.shape == got.shape == (80, len(sta_cart), 2)
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(back, got)
    assert _load_pickle(path)["metrics"] == metrics
