"""Training: on-device synthetic windows → detector forward → masked MSE →
Adam, and the per-project domain tables shared with inference.

Port of ``genie_tpu/train/trainer.py``:

* ``DomainContext`` / ``build_domain_context``: tables built once per
  project, as torch tensors on the device, with the generator's optional
  inputs (observed station subnetworks, rasterized surface, reference
  sources, the Cholesky factor of the correlated-noise covariance);
* :func:`loss_fn`: the weighted masked MSE on the four outputs (grid
  detection, query detection, P and S association), each term normalized
  by its weights, with ``positive_boost`` and the optional sensitivity
  regularizer (``torch.func.vmap(torch.func.jacfwd(…))`` of the travel
  time, detached);
* :func:`make_train_step` / :func:`make_train_step_from_batch` with
  ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, optax.adam's
  update rule; :func:`init_train_state` with flax's default initialisation
  (``models/init.py``); the dataset mode :func:`build_training_dataset` /
  :func:`load_training_batch`, which reads batches the JAX package wrote.

Windows differ in grid and station subset, and the fused-round kernel takes
one station table per launch, so each window runs its own forward (a
leading window axis of 1). ``sequential_windows=True`` (run6) is gradient
accumulation: one window's forward and backward at a time, each adding the
gradient of ``(w · losses_i + s · sens_i)/B``, which is the gradient of JAX's
``lax.map(checkpoint(one))`` with one window's activation memory.
``False`` keeps all B windows in one autograd graph and takes one backward,
the memory profile of JAX's ``vmap``.

Data parallelism (``mesh=``, a :class:`~genie_tpu_torch.parallel.mesh.Mesh`;
``__graft_entry__.py``'s step with the window axis sharded): each rank takes
its block of the batch's windows and runs :func:`loss_fn` on them, whose
``/B`` is over its local windows; one ``all_reduce`` of a flat bucket (the
gradients, the loss and its parts, trgts/preds) then averages the
gradients, so each rank holds the one-process gradient of all B windows and
Adam steps identically everywhere. An explicit all-reduce rather than DDP:
the model runs once per window, and DDP's hooks would fire on each.
"""

from __future__ import annotations

import copy
import os
import time
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from genie_tpu_torch.config import Config
from genie_tpu_torch.graphs.build import (
    build_edge_feat,
    build_pair_table,
    build_query_attachment,
    build_source_graph,
    build_time_pointers,
)
from genie_tpu_torch.models.detector import GraphBundle, PickSet, QuerySet
from genie_tpu_torch.models.init import init_detector
from genie_tpu_torch.ops.fused_round import relu
from genie_tpu_torch.synth.generator import WindowBatch, make_windows, synthesize_timeline


class DomainContext(NamedTuple):
    """Static per-project tensors (one device)."""

    sta_cart: torch.Tensor      # (n_sta, 3)
    sta_lla: torch.Tensor       # (n_sta, 3)
    grids_cart: torch.Tensor    # (n_grids, n_src, 3)
    grids_lla: torch.Tensor     # (n_grids, n_src, 3)
    trv_grids: torch.Tensor     # (n_grids, n_src, n_sta, 2)
    time_ptr_p: torch.Tensor    # (n_grids, n_sta, n_dt, k_time) int32
    time_ptr_s: torch.Tensor
    dt0: float
    dt: float
    edge_feat: torch.Tensor     # (n_grids, n_src, n_sta, 3)
    src_nbr: torch.Tensor       # (n_grids, n_src, k_spc) int32
    scale_cart: torch.Tensor    # (3,) cart sampling box scale
    offset_cart: torch.Tensor   # (3,) cart sampling box offset
    # observed per-day station sets (n_subnet, n_sta) bool, or None: sampled
    # as training subsets with probability 1/2 (ref fixed_subnetworks)
    subnetworks: Any = None
    # rasterized topography (elev (nx, ny), lo (2,), h (2,)), or None:
    # clamps synthetic event depths (ref train_GENIE_model.py:581-584)
    surface: Any = None
    # (n_ref, 3) reference-catalog cart positions for density sampling, or None
    ref_srcs_cart: Any = None
    # (n_sta, n_sta) Cholesky factor of the station-distance covariance for
    # correlated travel-time noise, or None
    corr_chol: Any = None


def _corr_chol(cfg: Config, sta_cart, device=None):
    """Cholesky factor of the squared-exponential station-distance
    covariance (ref train_GENIE_model.py:366-376), float64 on the host."""
    sta = (sta_cart.detach().cpu().numpy() if isinstance(sta_cart, torch.Tensor)
           else np.asarray(sta_cart)).astype(np.float64)
    d = np.linalg.norm(sta[:, None] - sta[None], axis=-1)
    ell = float(cfg.synth.corr_noise_params[4])
    cov = np.exp(-0.5 * (d / ell) ** 2) + 1e-6 * np.eye(len(d))
    return torch.as_tensor(np.linalg.cholesky(cov), dtype=torch.float32, device=device)


def build_domain_context(cfg: Config, sta_lla, sta_cart, grids_lla, grids_cart,
                         trv_grids, device, subnetworks=None, surface=None,
                         ref_srcs_cart=None) -> DomainContext:
    """kNN graphs, time pointers and bipartite edge features of every grid,
    on ``device`` (inputs are numpy arrays or tensors), plus the
    generator's optional inputs."""
    device = torch.device(device)

    def dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.array(a, np.float32), device=device)

    sta_cart, sta_lla = dev(sta_cart), dev(sta_lla)
    grids_cart, grids_lla, trv_grids = dev(grids_cart), dev(grids_lla), dev(trv_grids)
    max_t = float(trv_grids.max())
    scale, _ = cfg.region.scale_offset(extend=True)
    ptr_p, ptr_s, src_nbrs, efeats = [], [], [], []
    dt0 = dt = None
    for g in range(grids_cart.shape[0]):
        p, s, dt0, dt, _ = build_time_pointers(
            trv_grids[g], dt=1.0, k=cfg.graph.k_time_edges, win=cfg.model.t_win,
            max_t=max_t)
        ptr_p.append(p)
        ptr_s.append(s)
        src_nbrs.append(build_source_graph(grids_cart[g], cfg.graph.k_spc_edges))
        efeats.append(build_edge_feat(grids_lla[g], sta_lla, scale))
    flat = grids_cart.reshape(-1, 3)
    cart_min = flat.amin(dim=0)
    cart_max = flat.amax(dim=0)
    return DomainContext(
        sta_cart=sta_cart, sta_lla=sta_lla, grids_cart=grids_cart,
        grids_lla=grids_lla, trv_grids=trv_grids,
        time_ptr_p=torch.stack(ptr_p), time_ptr_s=torch.stack(ptr_s),
        dt0=dt0, dt=dt, edge_feat=torch.stack(efeats),
        src_nbr=torch.stack(src_nbrs), scale_cart=cart_max - cart_min,
        offset_cart=cart_min,
        subnetworks=(None if subnetworks is None else
                     torch.as_tensor(np.asarray(subnetworks, bool), device=device)),
        surface=(None if surface is None else tuple(dev(a) for a in surface)),
        ref_srcs_cart=None if ref_srcs_cart is None else dev(ref_srcs_cart),
        corr_chol=(_corr_chol(cfg, sta_cart, device)
                   if cfg.synth.use_correlated_noise else None))


# -- data ---------------------------------------------------------------------

def generate_batch(gen, cfg: Config, ctx: DomainContext, trv_from_cart) -> WindowBatch:
    """One timeline and its ``n_batch`` windows on ``gen``'s device (no
    gradient is recorded)."""
    with torch.no_grad():
        tl = synthesize_timeline(
            gen, cfg.synth, ctx.sta_cart, trv_from_cart, ctx.scale_cart,
            ctx.offset_cart, (ctx.offset_cart[2], ctx.offset_cart[2] + ctx.scale_cart[2]),
            n_sta_real=ctx.sta_cart.shape[0], surface=ctx.surface,
            ref_srcs_cart=ctx.ref_srcs_cart, corr_chol=ctx.corr_chol)
        return make_windows(
            gen, cfg.synth, cfg.train, cfg.graph, tl, ctx.sta_cart, ctx.grids_cart,
            ctx.trv_grids, ctx.scale_cart, ctx.offset_cart, t_win=cfg.model.t_win,
            subnetworks=ctx.subnetworks)


def step_seed(seed: int, i: int, rank: int | None = None) -> int:
    """The generator seed of batch (or step) ``i`` of a run seeded ``seed``;
    under data parallelism, of that step on ``rank``."""
    entropy = [seed, i] if rank is None else [seed, i, rank]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def build_training_dataset(cfg: Config, ctx: DomainContext, trv_from_cart, out_dir,
                           n_batches: int, seed: int = 0, job: int = 0,
                           n_jobs: int = 1):
    """Pre-materialize training batches to disk (the reference's
    ``build_training_data`` job-array mode, train_GENIE_model.py:1411-1504):
    job ``job`` of ``n_jobs`` writes batches ``job, job + n_jobs, …``, one
    npz per :class:`WindowBatch`, each published atomically (temp file +
    ``os.replace``) so a killed job never leaves a truncated file. Batch i
    comes from a generator seeded by (seed, i) on the context's device, so
    a rerun rewrites nothing and an existing file is kept."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=ctx.sta_cart.device)
    written = []
    for i in range(job, n_batches, n_jobs):
        path = out_dir / f"training_batch_{i}.npz"
        if not path.exists():
            wb = generate_batch(gen.manual_seed(step_seed(seed, i)), cfg, ctx,
                                trv_from_cart)
            tmp = path.with_name(f".tmp_{os.getpid()}_" + path.name)
            np.savez_compressed(tmp, **{f: getattr(wb, f).cpu().numpy()
                                        for f in wb._fields})
            os.replace(tmp, path)
        written.append(path)
    return written


def load_training_batch(path, device) -> WindowBatch:
    """A batch written by :func:`build_training_dataset` of either package."""
    z = np.load(path)
    return WindowBatch(**{f: torch.as_tensor(z[f], device=torch.device(device))
                          for f in WindowBatch._fields})


# -- forward and loss ---------------------------------------------------------

def _take(t, g):
    return t.index_select(0, g.reshape(1).long())[0]


def window_forward(model, ctx: DomainContext, cfg: Config, wb_i: WindowBatch,
                   trv_from_cart):
    """Forward one window; ``wb_i`` is a :class:`WindowBatch` slice with a
    leading window axis of 1. Returns (y, x, arv_p, arv_s), each with that
    axis."""
    g = wb_i.grid_idx[0]
    graph = GraphBundle(
        sta_nbr=wb_i.sta_nbr[0], sta_nbr_valid=wb_i.sta_nbr_valid[0],
        src_nbr=_take(ctx.src_nbr, g), sta_mask=wb_i.sta_mask[0],
        edge_feat=_take(ctx.edge_feat, g), src_pos=_take(ctx.grids_cart, g),
        time_ptr_p=_take(ctx.time_ptr_p, g), time_ptr_s=_take(ctx.time_ptr_s, g),
        dt0=torch.tensor(ctx.dt0, dtype=torch.float32, device=g.device),
        dt=torch.tensor(ctx.dt, dtype=torch.float32, device=g.device),
        trv=_take(ctx.trv_grids, g))
    pair_idx, pair_valid = build_pair_table(wb_i.tpick, wb_i.ipick, wb_i.pick_mask,
                                            k_pair=cfg.graph.k_pick_pairs)
    picks = PickSet(wb_i.tpick, wb_i.ipick, wb_i.phase, wb_i.pick_mask, pair_idx,
                    pair_valid)
    k = cfg.graph.k_spatial_attn
    n_t = wb_i.lbl_grid.shape[-1]
    t_query = torch.linspace(-cfg.model.t_win / 2, cfg.model.t_win / 2, n_t,
                             device=g.device)[:, None]
    with torch.no_grad():
        trv_qsrc = trv_from_cart(ctx.sta_cart, wb_i.x_qsrc)
    queries = QuerySet(
        x_query=wb_i.x_query,
        x_query_idx=build_query_attachment(graph.src_pos, wb_i.x_query, k=k),
        t_query=t_query, x_qsrc=wb_i.x_qsrc,
        x_qsrc_idx=build_query_attachment(graph.src_pos, wb_i.x_qsrc, k=k),
        tq_sample=wb_i.tq_sample, trv_qsrc=trv_qsrc)
    return model(wb_i.feat, wb_i.mask, graph, ctx.sta_cart, picks, queries)


def _sensitivity(cfg: Config, ctx: DomainContext, wb_i: WindowBatch, arv_p, arv_s,
                 trv_from_cart):
    """Gauss-Newton location-uncertainty penalty (ref train_GENIE_model.py:
    1792-1829): association scores as pick weights, travel-time partials
    (detached) as the Jacobian, Tikhonov damping."""
    def t_of_x(xs):
        return trv_from_cart(ctx.sta_cart, xs[None])[0]               # (n_sta, 2)

    part = torch.func.vmap(torch.func.jacfwd(t_of_x))(wb_i.x_qsrc[0]).detach()
    ip = wb_i.ipick[0].long()
    pm_col = wb_i.pick_mask[0][None, :, None].to(arv_p.dtype)
    jp = relu(arv_p)[..., None] * part[:, ip, 0, :] * pm_col
    js = relu(arv_s)[..., None] * part[:, ip, 1, :] * pm_col
    J = torch.cat((jp, js), dim=1)                                     # (n_q, 2 n_pick, 3)
    G = torch.einsum("qpi,qpj->qij", J, J) / cfg.train.sensitivity_sig_d ** 2
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1)
    eps = 1e-6 * (tr / 3.0 + 1.0)
    cov = torch.linalg.inv(G + eps[:, None, None] * torch.eye(3, device=G.device))
    sigma = torch.sqrt(relu(torch.diagonal(cov, dim1=1, dim2=2)).sum(-1))
    ok = (tr > 1e-8).to(sigma.dtype)
    return ((sigma / 1e4) ** 2 * ok).sum() / torch.clamp_min(ok.sum(), 1.0)


def _window_loss(model, ctx: DomainContext, cfg: Config, wb_i: WindowBatch,
                 trv_from_cart):
    """(losses (4,), trgts (4,), preds (4,), l_sens) of one window."""
    y, x, arv_p, arv_s = window_forward(model, ctx, cfg, wb_i, trv_from_cart)
    y, x, arv_p, arv_s = y[0, ..., 0], x[0, ..., 0], arv_p[0, ..., 0], arv_s[0, ..., 0]
    lbl_grid, lbl_query, lbl_assoc = wb_i.lbl_grid[0], wb_i.lbl_query[0], wb_i.lbl_assoc[0]
    # positive-cell up-weighting: boost b reweights cell i by (1 + b·lbl_i),
    # normalized; b = 0 is the reference loss
    b = cfg.train.positive_boost

    def wmse(pred, lbl):
        w_cell = 1.0 + b * lbl
        return ((pred - lbl) ** 2 * w_cell).sum() / w_cell.sum()

    pm = wb_i.pick_mask[0][None, :].to(y.dtype)
    denom = torch.clamp_min(pm.sum() * arv_p.shape[0], 1.0)
    losses = torch.stack((
        wmse(y, lbl_grid), wmse(x, lbl_query),
        (((arv_p - lbl_assoc[..., 0]) ** 2) * pm).sum() / denom,
        (((arv_s - lbl_assoc[..., 1]) ** 2) * pm).sum() / denom))
    # "trgts/preds" training-health diagnostics (ref Code/README.md:35):
    # per-output label and prediction maxima
    trgts = torch.stack((lbl_grid.max(), lbl_query.max(), lbl_assoc[..., 0].max(),
                         lbl_assoc[..., 1].max()))
    preds = torch.stack((y.max(), x.max(), arv_p.max(), arv_s.max())).detach()
    l_sens = (_sensitivity(cfg, ctx, wb_i, arv_p, arv_s, trv_from_cart)
              if cfg.train.sensitivity_weight > 0 else y.new_zeros(()))
    return losses, trgts, preds, l_sens


def loss_fn(model, ctx: DomainContext, cfg: Config, wb: WindowBatch, trv_from_cart,
            backward: bool = False):
    """Weighted masked MSE over the four outputs, averaged over windows:
    ``total = w · mean_i(losses_i) + sensitivity_weight · mean_i(sens_i)``.
    Returns ``(total, (losses (4,), trgts (4,), preds (4,)))``, trgts/preds
    summed over windows. With ``backward`` the gradient of ``total`` is
    accumulated into the parameters' ``.grad`` (per window when
    ``sequential_windows``, see the module docstring) and ``total`` comes
    back detached."""
    B = wb.feat.shape[0]
    w = torch.tensor(cfg.train.loss_weights, dtype=torch.float32,
                     device=wb.feat.device)
    total = losses_sum = trgts_sum = preds_sum = 0.0
    for i in range(B):
        wb_i = WindowBatch(*[t[i:i + 1] for t in wb])
        losses, trgts, preds, l_sens = _window_loss(model, ctx, cfg, wb_i, trv_from_cart)
        part = ((w * losses).sum() + cfg.train.sensitivity_weight * l_sens) / B
        if backward and cfg.train.sequential_windows:
            part.backward()
            part, losses = part.detach(), losses.detach()
        total = total + part
        losses_sum = losses_sum + losses
        trgts_sum = trgts_sum + trgts
        preds_sum = preds_sum + preds
    if backward and not cfg.train.sequential_windows:
        total.backward()
        total, losses_sum = total.detach(), losses_sum.detach()
    return total, (losses_sum / B, trgts_sum, preds_sum)


# -- optimizer and steps ------------------------------------------------------

class TrainState(NamedTuple):
    """The model (its parameters), its Adam optimizer (the optimizer state)
    and the number of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def make_optimizer(model, cfg: Config) -> torch.optim.Adam:
    """optax.adam(lr)'s update rule: b1 0.9, b2 0.999, eps 1e-8 outside the
    square root."""
    return torch.optim.Adam(model.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def adam_state(optimizer, model) -> dict:
    """``{'count', 'mu', 'nu'}`` of a torch Adam under the model's parameter
    names (zeros and count 0 before the first step)."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if "step" in st:
            count = int(st["step"])
        mu[name] = st["exp_avg"].detach() if "exp_avg" in st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"].detach() if "exp_avg_sq" in st else torch.zeros_like(p)
    return {"count": count, "mu": mu, "nu": nu}


def set_adam_state(optimizer, model, state: dict):
    """Load ``{'count', 'mu', 'nu'}`` (``params.load_adam_state``) into a
    torch Adam over ``model``'s parameters."""
    missing = sorted(n for n, _ in model.named_parameters()
                     if n not in state["mu"] or n not in state["nu"])
    if missing:
        raise KeyError(f"Adam state lacks {missing}")
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(state["count"]), dtype=torch.float32),
            "exp_avg": state["mu"][name].to(p).clone().reshape(p.shape),
            "exp_avg_sq": state["nu"][name].to(p).clone().reshape(p.shape)}


def _metrics(total, parts, trgts, preds):
    return {"loss": total, "loss_grid": parts[0], "loss_query": parts[1],
            "loss_p": parts[2], "loss_s": parts[3], "trgts": trgts, "preds": preds}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _all_reduce_step(model, mesh, total, parts, trgts, preds):
    """Average the gradients, the loss and its parts over the ranks and sum
    trgts/preds, in one ``all_reduce`` of a flat bucket."""
    from genie_tpu_torch.parallel.mesh import all_reduce_

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    pieces = [g.reshape(-1) for g in grads] + [
        total.reshape(1), parts.reshape(-1), trgts.reshape(-1), preds.reshape(-1)]
    bucket = all_reduce_(torch.cat(pieces), mesh)
    n_mean = bucket.numel() - trgts.numel() - preds.numel()
    bucket[:n_mean] /= mesh.size
    out = list(torch.split(bucket, [t.numel() for t in pieces]))
    for g, flat in zip(grads, out):
        g.copy_(flat.view_as(g))
    total, parts, trgts, preds = out[len(grads):]
    return total[0], parts, trgts, preds


def _make_step(cfg, ctx, trv_from_cart, batch_fn, mesh=None):
    from torch.profiler import record_function

    dev = ctx.sta_cart.device

    def train_step(state: TrainState, arg):
        t0 = time.perf_counter()
        with record_function("generate"):
            wb = batch_fn(arg)
        _sync(dev)
        t1 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("forward_backward"):
            total, (parts, trgts, preds) = loss_fn(state.model, ctx, cfg, wb,
                                                   trv_from_cart, backward=True)
        if mesh is not None:
            with record_function("all_reduce"):
                total, parts, trgts, preds = _all_reduce_step(
                    state.model, mesh, total, parts, trgts, preds)
        _sync(dev)
        t2 = time.perf_counter()
        with record_function("optimizer"):
            state.optimizer.step()
        _sync(dev)
        train_step.stage_seconds = {"generate": t1 - t0, "forward_backward": t2 - t1,
                                    "optimizer": time.perf_counter() - t2}
        return (TrainState(state.model, state.optimizer, state.step + 1),
                _metrics(total, parts, trgts, preds))

    train_step.stage_seconds = {}
    return train_step


def make_train_step(cfg: Config, ctx: DomainContext, trv_from_cart, mesh=None):
    """``train_step(state, generator) -> (state, metrics)``: generate a batch
    on the generator's device, accumulate the loss gradient into
    ``state.model``, take one step of ``state.optimizer``. The seconds of the
    three stages land in ``train_step.stage_seconds``; the device is
    synchronized at each stage boundary, which costs a host-bound step next
    to nothing. With ``mesh`` each rank draws its ``n_batch / size`` windows
    from its own generator (seeded by the caller, ``step_seed(seed, i,
    rank)``: the law of one batch split over the ranks, drawn by other
    streams) and the gradients are averaged over the ranks (module
    docstring); the state's model must be the same on every rank."""
    if mesh is not None:
        if cfg.train.n_batch % mesh.size:
            raise ValueError(f"make_train_step: {cfg.train.n_batch} windows do not "
                             f"divide over {mesh.size} ranks")
        cfg = copy.deepcopy(cfg)
        cfg.train.n_batch //= mesh.size
    return _make_step(cfg, ctx, trv_from_cart,
                      lambda gen: generate_batch(gen, cfg, ctx, trv_from_cart), mesh)


def make_train_step_from_batch(cfg: Config, ctx: DomainContext, trv_from_cart,
                               mesh=None):
    """``train_step(state, wb) -> (state, metrics)`` on a pre-built
    :class:`WindowBatch` (dataset mode). With ``mesh`` every rank is given
    the whole batch, takes its block of windows (``shard_leading_axis``)
    and the gradients are averaged over the ranks."""
    if mesh is None:
        return _make_step(cfg, ctx, trv_from_cart, lambda wb: wb)
    from genie_tpu_torch.parallel.mesh import shard_leading_axis

    def local_windows(wb):
        if wb.feat.shape[0] % mesh.size:
            raise ValueError(f"{wb.feat.shape[0]} windows do not divide over "
                             f"{mesh.size} ranks")
        return shard_leading_axis(wb, mesh)

    return _make_step(cfg, ctx, trv_from_cart, local_windows, mesh)


def init_train_state(model, cfg: Config, generator: torch.Generator) -> TrainState:
    """Flax-default weights (``models/init.py``) from ``generator`` and a
    fresh Adam, at step 0."""
    init_detector(model, generator)
    return TrainState(model, make_optimizer(model, cfg), 0)
