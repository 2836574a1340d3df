"""Source location by batched differential evolution, and the Gauss-Newton
location covariance.

Port of ``genie_tpu/infer/locate.py`` (``_de_minimize_impl`` :23-60,
``make_location_objective`` :64-94, ``locate_sources_batched`` :130-163,
``location_uncertainty_batched`` :165-180 and :303-316). The JAX package
``vmap``s one DE per event; here the event axis is written out, so a whole
bucket of events is one population tensor ``(n_ev, pop, 4)``. Random draws
come from a seeded ``torch.Generator`` and differ from ``jax.random``'s. The
particle-swarm locator is not ported yet.
"""

from __future__ import annotations

import torch


def make_location_objective(trv_from_cart, sta_cart, tpick, ipick, phase,
                            pick_mask, trim_fraction: float = 0.2,
                            sig_t: float = 1.0):
    """Trimmed-residual objective for a batch of events. tpick/ipick/
    pick_mask (n_ev, L), phase (n_ev, L, 1); candidates (n_ev, pop, 4) =
    (x, y, z, t0) → costs (n_ev, pop). The kept count follows each event's
    valid pick count, so padded pick arrays trim like exact-length ones."""
    n_pick = tpick.shape[1]
    n_valid = pick_mask.sum(dim=1)
    n_keep = n_valid - torch.floor(trim_fraction * n_valid).to(n_valid.dtype)
    ip = ipick.long()
    ph = phase[..., 0].long()
    rank = torch.arange(n_pick, device=tpick.device)

    def objective(cand):
        n_ev, pop = cand.shape[:2]
        trv = trv_from_cart(sta_cart, cand[..., :3])         # (n_ev, pop, n_sta, 2)
        idx = ip[:, None, :, None].expand(n_ev, pop, n_pick, 2)
        t_theory = torch.gather(trv, 2, idx)                  # (n_ev, pop, L, 2)
        t_ph = torch.gather(t_theory, 3,
                            ph[:, None, :, None].expand(n_ev, pop, n_pick, 1))[..., 0]
        res = (tpick[:, None, :] - (t_ph + cand[..., 3:4])).abs() / sig_t
        res = torch.where(pick_mask[:, None, :], res, torch.full_like(res, float("inf")))
        res_sorted = torch.sort(res, dim=2).values
        keep = rank[None, None, :] < n_keep[:, None, None]
        vals = torch.where(keep & torch.isfinite(res_sorted), res_sorted,
                           torch.zeros_like(res_sorted))
        return vals.sum(dim=2) / torch.clamp_min(n_keep, 1)[:, None]

    return objective


def de_minimize_batched(fn, bounds_lo, bounds_hi, n_ev: int, generator,
                        popsize: int = 64, n_iter: int = 100,
                        f_weight: float = 0.6, cr: float = 0.9):
    """Vectorized differential evolution (rand/1/bin) for ``n_ev``
    independent problems at once. ``fn`` maps (n_ev, pop, d) → (n_ev, pop).
    Returns (x_best (n_ev, d), cost_best (n_ev,))."""
    dev = bounds_lo.device
    d = bounds_lo.shape[0]
    g = generator

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev)

    def take(pop, i):
        return torch.gather(pop, 1, i[..., None].expand(n_ev, popsize, d))

    pop = bounds_lo + (bounds_hi - bounds_lo) * rand(n_ev, popsize, d)
    cost = fn(pop)
    dims = torch.arange(d, device=dev)
    for _ in range(n_iter):
        a, b, c = (randint(popsize, n_ev, popsize) for _ in range(3))
        mutant = take(pop, a) + f_weight * (take(pop, b) - take(pop, c))
        mutant = torch.minimum(torch.maximum(mutant, bounds_lo), bounds_hi)
        cross = rand(n_ev, popsize, d) < cr
        cross = cross | (dims == randint(d, n_ev, popsize)[..., None])
        trial = torch.where(cross, mutant, pop)
        c_trial = fn(trial)
        better = c_trial < cost
        pop = torch.where(better[..., None], trial, pop)
        cost = torch.where(better, c_trial, cost)
    ib = torch.argmin(cost, dim=1)
    rows = torch.arange(n_ev, device=dev)
    return pop[rows, ib], cost[rows, ib]


def locate_sources_batched(generator, trv_from_cart, sta_cart, tpick, ipick,
                           phase, pick_mask, bounds_lo, bounds_hi,
                           popsize: int = 128, n_iter: int = 150,
                           trim_fraction: float = 0.2):
    """DE-locate a batch of events: tpick/ipick/pick_mask (n_ev, L), phase
    (n_ev, L, 1). Returns (pos (n_ev, 3), t0 (n_ev,), cost (n_ev,))."""
    obj = make_location_objective(trv_from_cart, sta_cart, tpick, ipick, phase,
                                  pick_mask, trim_fraction)
    x, c = de_minimize_batched(obj, bounds_lo, bounds_hi, tpick.shape[0],
                               generator, popsize=popsize, n_iter=n_iter)
    return x[:, :3], x[:, 3], c


def location_uncertainty_batched(trv_from_cart, sta_cart, pos, t0, tpick,
                                 ipick, phase, pick_mask, sig_t: float = 1.0):
    """Gauss-Newton covariance ``pinv(JᵀJ + 1e-8·I)`` of each located event
    from travel-time partials (``torch.func.jacfwd``). Returns (n_ev, 4, 4).
    The pseudo-inverse cutoff is the JAX default, 10·max(m, n)·eps(f32)."""
    ip = ipick.long()
    ph = phase[..., 0].long()

    def resid(x, tp, ip_e, ph_e):
        trv = trv_from_cart(sta_cart, x[None, :3])[0]         # (n_sta, 2)
        t_ph = torch.gather(trv[ip_e], 1, ph_e[:, None])[:, 0]
        return (tp - (t_ph + x[3])) / sig_t

    x = torch.cat((pos, t0[:, None]), dim=1)
    J = torch.func.vmap(torch.func.jacfwd(resid))(x, tpick, ip, ph)   # (n_ev, L, 4)
    J = J * pick_mask[..., None]
    JtJ = J.transpose(1, 2) @ J
    eye = torch.eye(4, dtype=JtJ.dtype, device=JtJ.device)
    rtol = 10.0 * 4 * torch.finfo(torch.float32).eps
    return torch.linalg.pinv(JtJ + 1e-8 * eye, rtol=rtol)
