"""The port's calibration fits (``fit_corrections``, ``fit_magnitude_model``),
the DE relocation benchmark and the two calibration artifacts against the
JAX package, on the inputs of tests/test_calibration.py.

Tolerances: corrections and the fit loss after 50 Adam steps 1e-5 s;
magnitude parameters after 50 steps 1e-5; the DE benchmark by the JAX
test's own assertions (the draws of ``jax.random`` and ``torch.Generator``
differ); ``nanmedian`` 1e-6 relative; the artifacts written by the port,
read by the port's loaders and by the reading steps of
``scripts/nc_process.py``: corrected times within 1e-6 s, inverted
magnitudes within 1e-6 relative (the two packages' softplus round
differently)."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genie_tpu.calibration import corrections as jc
from genie_tpu.geometry import Projection as JaxProjection
from genie_tpu.models import magnitude as jm
from genie_tpu.models.travel_time import HomogeneousTravelTime as JaxHomogeneous
from genie_tpu_torch import io as tio
from genie_tpu_torch.calibration import corrections as tc
from genie_tpu_torch.calibration.magnitude_scale import fit_magnitude_distance_params
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.models import magnitude as tm
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.params import flatten_tree, load_corrections, load_magnitude_model


def T(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def corrections_case():
    """tests/test_calibration.py::test_fit_corrections_recovers_station_bias's
    inputs."""
    rng = np.random.default_rng(1)
    jtt = JaxHomogeneous(JaxProjection.from_center((40.0, -124.0)))
    tt = HomogeneousTravelTime(Projection.from_center((40.0, -124.0)))
    n_sta, n_grid, n_ev = 8, 30, 60
    sta = rng.uniform(-50e3, 50e3, (n_sta, 3)).astype(np.float32)
    grid = rng.uniform(-60e3, 60e3, (n_grid, 3)).astype(np.float32)
    src = rng.uniform(-40e3, 40e3, (n_ev, 3)).astype(np.float32)
    true_bias = rng.normal(0, 0.5, (1, n_sta, 2)).astype(np.float32)
    obs = np.asarray(jtt.from_cart(jnp.asarray(sta), jnp.asarray(src))) + true_bias
    mask = (rng.random(obs.shape) < 0.9).astype(np.float32)
    return jtt, tt, sta, grid, src, obs, mask


def test_fit_corrections_matches_jax(corrections_case):
    jtt, tt, sta, grid, src, obs, mask = corrections_case
    kw = dict(n_steps=50, w_smooth=0.1, w_norm=1e-4)
    want, loss_j = jc.fit_corrections(jax.random.PRNGKey(0), jtt.from_cart,
                                      jnp.asarray(sta), grid, jnp.asarray(src),
                                      jnp.asarray(obs), jnp.asarray(mask), **kw)
    got, loss = tc.fit_corrections(tt.from_cart, sta, grid, src, obs, mask, device="cpu",
                                   **kw)
    assert got.shape == (30, 8, 2) and float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss, loss_j, atol=1e-5, rtol=0)


def test_fit_corrections_recovers_station_bias(corrections_case):
    """The JAX test's own criterion on the port's 400-step fit."""
    _, tt, sta, grid, src, obs, mask = corrections_case
    coefs, _ = tc.fit_corrections(tt.from_cart, sta, grid, src, obs, np.ones_like(mask),
                                  n_steps=400, w_smooth=0.1, w_norm=1e-4, device="cpu")
    corr = tc.TravelTimeCorrection(tt.from_cart, grid, coefs)
    with torch.no_grad():
        base = tt.from_cart(T(sta), T(src)).numpy()
        pred = corr.from_cart(T(sta), T(src)).numpy()
    assert np.abs(pred - obs).mean() < 0.35 * np.abs(base - obs).mean()


class _RecordInt32:
    """Stands in for ``jnp`` inside ``genie_tpu.models.magnitude`` and keeps
    every array it converts to int32 (sta_idx, phase, then the pair
    indices)."""

    def __init__(self):
        self.recorded = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, a, *args, **kwargs):
        if (args[0] if args else kwargs.get("dtype")) is jnp.int32:
            self.recorded.append(np.asarray(a))
        return jnp.asarray(a, *args, **kwargs)


def _magnitude_case(grouped: bool):
    """test_magnitude_fit_and_invert's inputs; ``grouped`` puts ten
    observations on each of 30 events, so the station-pair loss has pairs."""
    rng = np.random.default_rng(2)
    n_sta, n_grid, n_obs = 10, 20, 300
    sta = rng.uniform(-50e3, 50e3, (n_sta, 3)).astype(np.float32)
    sta[:, 2] = 0.0
    grid = rng.uniform(-60e3, 60e3, (n_grid, 3)).astype(np.float32)
    ev = rng.uniform(-40e3, 40e3, (n_obs, 3)).astype(np.float32)
    ev[:, 2] = rng.uniform(-20e3, -2e3, n_obs)
    sta_idx = rng.integers(0, n_sta, n_obs)
    phase = rng.integers(0, 2, n_obs)
    mag = rng.uniform(0.5, 5.0, n_obs).astype(np.float32)
    if grouped:
        ev = np.repeat(ev[:30], 10, axis=0)
        mag = np.repeat(mag[:30], 10)
    d_epi = np.linalg.norm(ev[:, :2] - sta[sta_idx, :2], axis=1)
    log_amp = (1.0 * mag - 1.5 * np.log10(d_epi + 1.0)
               + rng.normal(0, 0.05, n_obs)).astype(np.float32)
    return sta, grid, ev, sta_idx, phase, log_amp, mag


@pytest.mark.parametrize("grouped", [False, True])
def test_fit_magnitude_model_matches_jax(grouped, monkeypatch):
    args = _magnitude_case(grouped)
    kw = dict(n_steps=50)
    if grouped:
        kw.update(max_pairs=400, w_bias_reg=3.0)
    spy = _RecordInt32()
    monkeypatch.setattr(jm, "jnp", spy)
    _, params = jm.fit_magnitude_model(jax.random.PRNGKey(0), *args, **kw)
    monkeypatch.undo()
    model = tm.fit_magnitude_model(*args, device="cpu", **kw)
    pi, pj = tm.same_event_pairs(args[2], args[3], args[4], kw.get("max_pairs", 200_000))
    assert len(spy.recorded) == 4
    np.testing.assert_array_equal(pi, spy.recorded[2])
    np.testing.assert_array_equal(pj, spy.recorded[3])
    assert len(pi) == (400 if grouped else 0)
    want = flatten_tree(jax.tree.map(np.asarray, params["params"]))
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert float(np.abs(want["bias"]).max()) > 0.1


def test_fit_magnitude_model_inverts():
    """The JAX test's criterion on the port's 800-step fit."""
    sta, grid, ev, sta_idx, phase, log_amp, mag = _magnitude_case(False)
    model = tm.fit_magnitude_model(sta, grid, ev, sta_idx, phase, log_amp, mag,
                                   n_steps=800, device="cpu")
    with torch.no_grad():
        inv = model(T(ev), T(sta), T(grid), T(sta_idx), T(phase), log_amp=T(log_amp))
    assert np.median(np.abs(inv.numpy() - mag)) < 0.25


def test_nanmedian_matches_jax_on_even_counts():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    x[0, :2] = np.nan          # six values left: even
    x[1, :3] = np.nan          # five: odd
    x[2, :] = np.nan           # none
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1))
    got = tc.nanmedian(T(x), dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # torch.nanmedian takes the lower middle value of an even count
    assert np.isnan(got[2]) and got[0] > float(torch.nanmedian(T(x[0])))


def test_relocation_benchmark_improves_matched_events():
    """tests/test_calibration.py::test_relocation_benchmark_improves_matched_
    events through the port, with its assertions."""
    rng = np.random.default_rng(0)
    n_sta, n_ev = 14, 6
    sta = rng.uniform(-60e3, 60e3, (n_sta, 3)).astype(np.float32)
    sta[:, 2] = 0.0

    def trv(sta_cart, src_cart):
        d = torch.linalg.norm(src_cart[..., :, None, :] - sta_cart[None], dim=-1)
        return torch.stack((d / 6000.0, d / 3464.0), dim=-1)

    target = np.concatenate(
        (rng.uniform(-40e3, 40e3, (n_ev, 2)), rng.uniform(-15e3, -5e3, (n_ev, 1)),
         rng.uniform(0, 1000, (n_ev, 1))), axis=1).astype(np.float32)
    init = target + np.concatenate(
        (rng.normal(0, 5e3, (n_ev, 3)), rng.normal(0, 1.0, (n_ev, 1))),
        axis=1).astype(np.float32)
    pick_t, pick_sta, pick_ph, pick_ev = [], [], [], []
    tt = trv(T(sta), T(target[:, :3])).numpy()
    for e in range(n_ev):
        for s in range(n_sta):
            for p in (0, 1):
                pick_t.append(target[e, 3] + tt[e, s, p] + rng.normal(0, 0.05))
                pick_sta.append(s)
                pick_ph.append(p)
                pick_ev.append(e)
    out = tc.relocation_benchmark(
        torch.Generator().manual_seed(0), trv, sta, init, target,
        np.array(pick_t, np.float32), np.array(pick_sta), np.array(pick_ph, np.float32),
        np.array(pick_ev), bounds_lo=[-70e3, -70e3, -30e3, -30.0],
        bounds_hi=[70e3, 70e3, 0.0, 86400.0 + 30.0], grid_cart=target[:2, :3],
        max_picks=32, device="cpu")
    assert out["srcs_relocated"].shape == (n_ev, 4)
    assert out["relocated"]["horizontal_m"] < 0.5 * out["initial"]["horizontal_m"]
    assert out["relocated"]["time_s"] < out["initial"]["time_s"] + 0.1
    assert "bias_initial" in out
    assert np.all(np.asarray(out["bias_relocated"][:2])
                  <= np.asarray(out["bias_initial"][:2]) + 1e3)


def test_calibration_artifacts_round_trip(corrections_case, tmp_path):
    """The corrections npz and the magnitude pickle written by the port,
    read back by the port's loaders and by the JAX reading steps of
    scripts/nc_process.py (``np.load`` into ``TravelTimeCorrection``;
    ``pickle.loads`` into ``MagnitudeModel.apply``)."""
    jtt, tt, sta, grid, src, obs, mask = corrections_case
    coefs, loss = tc.fit_corrections(tt.from_cart, sta, grid, src, obs, mask, n_steps=20,
                                     device="cpu")
    path = tio.save_corrections(tmp_path / "corrections.npz", grid, coefs,
                                {"n_events": 60, "fit_loss": loss})
    z = np.load(path)
    jcorr = jc.TravelTimeCorrection(jtt.from_cart, jnp.asarray(z["grid_cart"]),
                                    jnp.asarray(z["coefs"]))
    want = np.asarray(jcorr.from_cart(jnp.asarray(sta), jnp.asarray(src)))
    with torch.no_grad():
        got = load_corrections(path, tt.from_cart, device="cpu").from_cart(T(sta), T(src))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert "fit_loss" in str(z["stats"])

    sta_m, grid_m, ev, sta_idx, phase, log_amp, mag = _magnitude_case(True)
    model = tm.fit_magnitude_model(sta_m, grid_m, ev, sta_idx, phase, log_amp, mag,
                                   n_steps=20, w_bias_reg=3.0, device="cpu")
    d_epi = np.linalg.norm(ev[:, :2] - sta_m[sta_idx, :2], axis=1)
    dist = fit_magnitude_distance_params(mag, d_epi)
    path = tio.save_magnitude_model(tmp_path / "mag.pkl", model, grid_m, dist,
                                    vald={"n_events": 3})
    mm = pickle.loads(path.read_bytes())
    jmodel = jm.MagnitudeModel(n_sta=mm["n_sta"], n_grid=len(mm["grid_cart"]),
                               k=mm.get("k", 1))
    want = np.asarray(jmodel.apply(mm["params"], jnp.asarray(ev), jnp.asarray(sta_m),
                                   jnp.asarray(mm["grid_cart"]),
                                   jnp.asarray(sta_idx, jnp.int32),
                                   jnp.asarray(phase, jnp.int32),
                                   log_amp=jnp.asarray(log_amp)))
    loaded = load_magnitude_model(path, device="cpu")
    with torch.no_grad():
        got = loaded["model"](T(ev), T(sta_m), T(loaded["grid_cart"]), T(sta_idx),
                              T(phase), log_amp=T(log_amp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert loaded["dist_model"]["kind"] == dist["kind"] and mm["vald"] == {"n_events": 3}
    assert loaded["n_sta"] == 10 and loaded["k"] == 1
