"""The port's training path against the JAX package's, with the run6 weights
on the tiny domain of tests/test_trainer.py: the ``FusedRound`` backward, the
loss and its gradients on one JAX-generated batch, one Adam step resumed
from run6's optimizer state, the checkpoint format both ways, the flax
initialisation, the dataset-mode step and ``workflow.train`` with its
restart.

Tolerances: the backward against autograd atol 1e-5 (float32) plus
``gradcheck`` in float64; the loss and its four parts rtol 1e-4; every
gradient leaf within 1e-4 × the largest |g| of all leaves (a leaf whose own
gradient is near zero is held to that scale); parameters after one Adam
step atol 1e-6; JAX outputs on port-written weights atol 2e-4 (the chain
tolerance of tests/test_torch_port_detector.py)."""

import pickle
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from genie_tpu.models.detector import Detector as JaxDetector
from genie_tpu.train.trainer import generate_batch as jax_generate_batch
from genie_tpu.train.trainer import loss_fn as jax_loss_fn
from genie_tpu.train.trainer import window_forward as jax_window_forward
from genie_tpu_torch.config import Config
from genie_tpu_torch.geometry import Projection
from genie_tpu_torch.io import load_checkpoint, save_checkpoint
from genie_tpu_torch.models.detector import Detector
from genie_tpu_torch.models.init import init_detector
from genie_tpu_torch.models.travel_time import HomogeneousTravelTime
from genie_tpu_torch.ops.fused_round import (FusedRound, fused_round_backward_plain,
                                             fused_round_plain)
from genie_tpu_torch.params import (flatten_tree, load_adam_state, load_flax_params,
                                    load_into, to_flax, transplant)
from genie_tpu_torch.synth.generator import WindowBatch
from genie_tpu_torch.train.trainer import (TrainState, adam_state, build_domain_context,
                                           build_training_dataset, load_training_batch,
                                           loss_fn, make_optimizer, make_train_step,
                                           make_train_step_from_batch, set_adam_state,
                                           step_seed, window_forward)
from genie_tpu_torch.workflow import train

from tests.test_trainer import tiny_config, tiny_domain

ROOT = Path(__file__).resolve().parent.parent
RUN6 = ROOT / "projects/NC_EHZ/run6/params.pkl"


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config()
    jcfg.train.positive_boost = 100.0
    jcfg.train.sensitivity_weight = 2e-6
    jctx, jtt = tiny_domain(jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    ctx = build_domain_context(cfg, np.asarray(jctx.sta_lla), np.asarray(jctx.sta_cart),
                               np.asarray(jctx.grids_lla), np.asarray(jctx.grids_cart),
                               np.asarray(jctx.trv_grids), "cpu")
    tt = HomogeneousTravelTime(Projection.from_center(cfg.region.center))
    tree = load_flax_params(RUN6)
    # key 9: both windows hold an active event (grid labels 0.97 and 0.09)
    jwb = jax.jit(lambda k: jax_generate_batch(k, jcfg, jctx, jtt.from_cart))(
        jax.random.PRNGKey(9))
    wb = WindowBatch(*[T(a) for a in jwb])
    return dict(jcfg=jcfg, jctx=jctx, jtt=jtt, cfg=cfg, ctx=ctx, tt=tt, tree=tree,
                jwb=jwb, wb=wb)


# -- FusedRound ---------------------------------------------------------------

def _round_inputs(rows, n, cx, cz, m, h, k, dtype, z_is_x, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, dtype=dtype) * scale).requires_grad_()

    x = rnd(rows, n, cx)
    z = x if z_is_x else rnd(rows, n, cz)
    mask = (torch.rand((rows, n, m), generator=g) > 0.5).to(dtype)
    nbr = torch.randint(0, n, (n, k), generator=g, dtype=torch.int32)
    w = torch.rand((n, k), generator=g, dtype=dtype)
    w = w / w.sum(1, keepdim=True)
    d = cx + cz + m
    params = [rnd(h, d, scale=0.3), rnd(h), rnd(h, d, scale=0.3), rnd(h)]
    slopes = torch.tensor([0.25, 0.1], dtype=dtype, requires_grad=True)
    return (x, z, rnd(rows, n, cz), mask, nbr, w, *params, slopes)


@pytest.mark.parametrize("form", ["round1", "round2", "assoc"])
def test_fused_round_backward_matches_autograd(form):
    """The three round forms of the trunk (z = x in round 1)."""
    cx, cz, m, h, z_is_x = {"round1": (30, 30, 4, 30, True),
                            "round2": (60, 30, 4, 15, False),
                            "assoc": (30, 30, 5, 30, False)}[form]
    args = _round_inputs(3, 24, cx, cz, m, h, 8, torch.float32, z_is_x)
    leaves = [a for i, a in enumerate(args) if i not in (3, 4, 5)
              and not (z_is_x and i == 1)]
    g_out = torch.randn(3, 24, 2 * h, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(FusedRound.apply(*args), leaves, g_out)
    want = torch.autograd.grad(fused_round_plain(*args), leaves, g_out)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # the plain backward alone, with nothing asked of it
    none = fused_round_backward_plain(g_out, *[a.detach() for a in args],
                                      needs=(False,) * 8)
    assert all(v is None for v in none)
    # without a gradient the forward is the plain twin's, value for value
    with torch.no_grad():
        np.testing.assert_array_equal(FusedRound.apply(*args).numpy(),
                                      fused_round_plain(*args).numpy())


def test_fused_round_gradcheck_float64():
    args = _round_inputs(2, 5, 3, 3, 2, 2, 3, torch.float64, False, seed=3)
    diff = [0, 1, 2, 6, 7, 8, 9, 10]

    def fn(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return FusedRound.apply(*full)

    assert torch.autograd.gradcheck(fn, tuple(args[i] for i in diff))


# -- loss and gradients against JAX -------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_and_grads(setup):
    s = setup
    jm = JaxDetector(src_chunk=5)
    params = {"params": jax.tree.map(jnp.asarray, s["tree"])}

    def loss(p):
        return jax_loss_fn(jm, p, s["jctx"], s["jcfg"], s["jwb"], s["jtt"].from_cart)

    (total, (parts, trgts, preds)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return (float(total), np.asarray(parts), np.asarray(trgts), np.asarray(preds),
            jax.tree.map(np.asarray, grads["params"]))


@pytest.mark.parametrize("sequential", [True, False])
def test_loss_and_gradients_match_jax(setup, jax_loss_and_grads, sequential):
    """One JAX-generated batch through both packages' loss (positive boost
    100, the sensitivity term on), value and gradient."""
    s = setup
    total_j, parts_j, trgts_j, preds_j, grads_j = jax_loss_and_grads
    cfg = Config.from_dict(s["cfg"].to_dict())
    cfg.train.sequential_windows = sequential
    model = load_into(Detector(src_chunk=5), s["tree"])
    total, (parts, trgts, preds) = loss_fn(model, s["ctx"], cfg, s["wb"],
                                           s["tt"].from_cart, backward=True)
    assert total.grad_fn is None
    np.testing.assert_allclose(float(total), total_j, rtol=1e-4)
    np.testing.assert_allclose(parts.numpy(), parts_j, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(trgts.numpy(), trgts_j, rtol=1e-5)
    np.testing.assert_allclose(preds.numpy(), preds_j, rtol=1e-4, atol=2e-4)
    assert parts_j[2] > 0 and trgts_j[2] > 1.5       # both windows hold positives
    # the sensitivity term is on and counts
    cfg0 = Config.from_dict(cfg.to_dict())
    cfg0.train.sensitivity_weight = 0.0
    with torch.no_grad():
        base, _ = loss_fn(model, s["ctx"], cfg0, s["wb"], s["tt"].from_cart)
    assert float(total) > float(base)
    got = flatten_tree(to_flax({n: p.grad for n, p in model.named_parameters()}))
    want = flatten_tree(grads_j)
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert scale > 0
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_loss_and_gradients_match_jax_at_init_weights(setup):
    """The same batch at flax-default weights (``init_detector``, seed 4):
    zero biases put exact zeros into PReLUs and into the sensitivity term's
    clip, so every gradient leaf holds only if the port takes JAX's
    derivative at those ties."""
    s = setup
    model = init_detector(Detector(src_chunk=5), torch.Generator().manual_seed(4))
    params = {"params": jax.tree.map(jnp.asarray, to_flax(model))}

    def loss(p):
        return jax_loss_fn(JaxDetector(src_chunk=5), p, s["jctx"], s["jcfg"], s["jwb"],
                           s["jtt"].from_cart)

    (total_j, _), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    total, _ = loss_fn(model, s["ctx"], s["cfg"], s["wb"], s["tt"].from_cart,
                       backward=True)
    np.testing.assert_allclose(float(total), float(total_j), rtol=1e-4)
    got = flatten_tree(to_flax({n: p.grad for n, p in model.named_parameters()}))
    want = flatten_tree(jax.tree.map(np.asarray, grads_j["params"]))
    assert set(got) == set(want) and len(want) == 151
    scale = max(float(np.abs(v).max()) for v in want.values())
    bad = {k: float(np.abs(got[k] - want[k]).max()) for k in want
           if float(np.abs(got[k] - want[k]).max()) > 1e-4 * scale}
    assert not bad, (bad, scale)


# -- Adam, checkpoints, weights ------------------------------------------------

def _loader_with_optax(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_adam_step_from_run6_matches_optax(setup):
    """One Adam step (lr 5e-4) from run6's opt_state (count 20000) on the
    same gradients: optax.adam vs torch.optim.Adam."""
    blob = _loader_with_optax(RUN6)
    params, opt_state = blob["params"], blob["opt_state"]
    assert int(opt_state[0].count) == 20000
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(np.shape(a)))
                         .astype(np.float32), params)
    opt = optax.adam(5e-4)
    updates, new_state = opt.update(grads, opt_state, params)
    want = flatten_tree(jax.tree.map(np.asarray, optax.apply_updates(params, updates))
                        ["params"])

    cfg = Config()
    cfg.train.lr = 5e-4
    model = load_into(Detector(), load_flax_params(RUN6))
    optimizer = make_optimizer(model, cfg)
    adam = load_adam_state(RUN6)
    assert adam["count"] == 20000
    set_adam_state(optimizer, model, adam)
    g_sd = transplant(jax.tree.map(np.asarray, grads["params"]))
    for n, p in model.named_parameters():
        p.grad = g_sd[n].reshape(p.shape).clone()
    optimizer.step()
    got = flatten_tree(to_flax(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    st = adam_state(optimizer, model)
    assert st["count"] == 20001
    mu_want = flatten_tree(jax.tree.map(np.asarray, new_state[0].mu["params"]))
    mu_got = flatten_tree(to_flax(st["mu"]))
    for k in mu_want:
        np.testing.assert_allclose(mu_got[k], mu_want[k], atol=1e-9, rtol=1e-5)


def test_to_flax_inverts_transplant(setup):
    tree = setup["tree"]
    back = flatten_tree(to_flax(transplant(tree)))
    flat = flatten_tree(tree)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and back[k].dtype == np.float32, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_checkpoint_weights_load_in_jax(setup, tmp_path):
    """A port checkpoint (fresh flax-default weights, an Adam state) read by
    pickle in the JAX package: the same window outputs as the port's."""
    s = setup
    model = init_detector(Detector(src_chunk=5), torch.Generator().manual_seed(4))
    optimizer = make_optimizer(model, s["cfg"])
    model.zero_grad()
    loss_fn(model, s["ctx"], s["cfg"], s["wb"], s["tt"].from_cart, backward=True)
    optimizer.step()
    path = save_checkpoint(tmp_path / "ckpt.pkl", model, optimizer, step=7, cfg=s["cfg"])
    blob = _loader_with_optax(path)
    assert blob["step"] == 7 and blob["config"]["train"]["lr"] == s["cfg"].train.lr
    assert int(blob["opt_state"]["count"]) == 1
    params = {"params": jax.tree.map(jnp.asarray, blob["params"]["params"])}
    jwb0 = jax.tree.map(lambda a: a[0], s["jwb"])
    jout = jax_window_forward(JaxDetector(src_chunk=5), params, s["jctx"], s["jcfg"],
                              jwb0, s["jtt"].from_cart)
    with torch.no_grad():
        out = window_forward(model, s["ctx"], s["cfg"], WindowBatch(*[t[:1] for t in s["wb"]]),
                             s["tt"].from_cart)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=2e-4, rtol=1e-4)
    assert float(np.abs(np.asarray(jout[2])).max()) > 1e-3
    # and the port reads it back: weights and Adam state
    model2 = Detector(src_chunk=5)
    opt2 = make_optimizer(model2, s["cfg"])
    assert load_checkpoint(path, model2, opt2) == 7
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
    st, st2 = adam_state(optimizer, model), adam_state(opt2, model2)
    assert st2["count"] == 1
    for n in st["nu"]:
        np.testing.assert_array_equal(st["nu"][n].numpy(), st2["nu"][n].numpy())


def test_init_detector_statistics():
    model = init_detector(Detector(), torch.Generator().manual_seed(0))
    pooled = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear):
            w = mod.weight.detach().numpy()
            s = 1.0 / np.sqrt(w.shape[1])
            assert np.abs(w).max() <= 2.0 * s / 0.87962566103423978 + 1e-6, name
            if w.size >= 400:
                assert abs(w.std() / s - 1.0) < 0.10, (name, w.std() / s)
            pooled.append((w / s).ravel())
            assert (mod.bias.detach().numpy() == 0).all(), name
    pooled = np.concatenate(pooled)
    assert abs(pooled.std() - 1.0) < 0.02 and abs(pooled.mean()) < 0.02
    slopes = [p for n, p in model.named_parameters() if n.endswith(".a")]
    assert len(slopes) == 43 and all(float(a.detach()) == 0.25 for a in slopes)


# -- train steps and workflow.train ---------------------------------------------

def test_train_step_from_batch_matches_generated_step(setup, tmp_path):
    """Dataset mode: one step on a batch written to disk and read back takes
    the parameters where the step that generates that batch from the same
    seed takes them."""
    s = setup
    cfg = Config.from_dict(s["cfg"].to_dict())
    cfg.train.sensitivity_weight = 0.0
    build_training_dataset(cfg, s["ctx"], s["tt"].from_cart, tmp_path, 1, seed=5)
    wb = load_training_batch(tmp_path / "training_batch_0.npz", "cpu")
    runs = []
    for make, arg in ((make_train_step, torch.Generator().manual_seed(step_seed(5, 0))),
                      (make_train_step_from_batch, wb)):
        step_fn = make(cfg, s["ctx"], s["tt"].from_cart)
        model = load_into(Detector(src_chunk=5), s["tree"])
        state, metrics = step_fn(TrainState(model, make_optimizer(model, cfg), 0), arg)
        assert state.step == 1 and np.isfinite(float(metrics["loss"]))
        assert set(step_fn.stage_seconds) == {"generate", "forward_backward", "optimizer"}
        runs.append((state.model, metrics))
    (ma, met_a), (mb, met_b) = runs
    np.testing.assert_allclose(float(met_b["loss"]), float(met_a["loss"]), rtol=1e-6)
    ref = load_into(Detector(src_chunk=5), s["tree"]).state_dict()
    moved = 0.0
    for (n, p), q in zip(ma.state_dict().items(), mb.state_dict().values()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), atol=1e-7, err_msg=n)
        moved = max(moved, float((p - ref[n]).abs().max()))
    assert moved > 0.0

def test_workflow_train_restarts(setup, tmp_path):
    """Two steps, then a restart from the checkpoint for a third: the log,
    the checkpoint's step, the profile of step 1, and the resumed run ends
    where an uninterrupted three-step run does."""
    s = setup
    cfg = Config.from_dict(s["cfg"].to_dict())
    cfg.train.sensitivity_weight = 0.0
    cfg.train.checkpoint_every = 1
    a, b = tmp_path / "a", tmp_path / "b"
    _, state, hist = train(cfg, s["ctx"], s["tt"], a, n_steps=2, log_every=1, seed=3,
                           profile_at=1)
    assert state.step == 2 and len(hist) == 2
    assert all(np.isfinite(m["loss"]) for m, _ in hist)
    lines = (a / f"{cfg.region.name}_output_ver_1.txt").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "1"] and "trgts" in lines[0]
    assert list((a / "profile").glob("step_1.json"))
    model_r, state_r, hist_r = train(cfg, s["ctx"], s["tt"], a, n_steps=3, log_every=1,
                                     seed=3, restart=True)
    assert len(hist_r) == 1 and state_r.step == 3
    assert adam_state(state_r.optimizer, model_r)["count"] == 3
    model_f, state_f, hist_f = train(cfg, s["ctx"], s["tt"], b, n_steps=3, log_every=10,
                                     seed=3)
    np.testing.assert_allclose(hist_r[0][0]["loss"], hist_f[2][0]["loss"], rtol=1e-5)
    for (n, p), q in zip(model_r.state_dict().items(), model_f.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=1e-6, err_msg=n)
    blob = _loader_with_optax(b / "ckpt.pkl")
    assert blob["step"] == 3
