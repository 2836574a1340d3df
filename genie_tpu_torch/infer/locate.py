"""Source location by differential evolution or a particle swarm, and the
Gauss-Newton location covariance.

Port of ``genie_tpu/infer/locate.py``: ``_de_minimize_impl`` (:23-60),
``make_location_objective`` (:64-94), ``locate_source`` (:105-127),
``locate_sources_batched`` (:130-163), ``location_uncertainty_batched``
(:165-180), ``pso_minimize`` (:183-244), ``locate_source_pso`` (:247-277)
and ``location_uncertainty`` (:283-316). The JAX package ``vmap``s one DE
per event; here the event axis is written out, so a whole bucket of events
is one population tensor ``(n_ev, pop, 4)`` and a single event is a bucket
of one. Random draws come from a seeded ``torch.Generator`` and differ from
``jax.random``'s; the swarm's step takes its draws as arguments
(:func:`pso_init`, :func:`pso_step`), so it can be fed any draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genie_tpu_torch.device import resolve_device


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


def _single_event(device, sta_cart, tpick, ipick, phase, pick_mask):
    """One event's picks as a bucket of one on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return (dev, torch.as_tensor(sta_cart, **f32), torch.as_tensor(tpick, **f32)[None],
            torch.as_tensor(ipick, device=dev)[None], torch.as_tensor(phase, **f32)[None],
            torch.as_tensor(pick_mask, device=dev).bool()[None])


def locate_source(generator, trv_from_cart, sta_cart, tpick, ipick, phase, pick_mask,
                  bounds_lo, bounds_hi, popsize: int = 128, n_iter: int = 150,
                  trim_fraction: float = 0.2, device=None):
    """DE-locate one event: tpick/ipick/pick_mask (L,), phase (L, 1), bounds
    (4,) over (x, y, z, t0). :func:`locate_sources_batched` with one event,
    on ``device`` (default ``cuda``; ``generator`` must lie there). Returns
    (pos (3,), t0, cost)."""
    dev, sta, tp, ip, ph, pm = _single_event(device, sta_cart, tpick, ipick, phase,
                                             pick_mask)
    lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=dev)
              for b in (bounds_lo, bounds_hi))
    pos, t0, cost = locate_sources_batched(generator, trv_from_cart, sta, tp, ip, ph, pm,
                                           lo, hi, popsize=popsize, n_iter=n_iter,
                                           trim_fraction=trim_fraction)
    return pos[0], t0[0], cost[0]


def location_uncertainty(trv_from_cart, sta_cart, pos, t0, tpick, ipick, phase,
                         pick_mask, sig_t: float = 1.0, device=None):
    """Gauss-Newton covariance (4, 4) of one located event:
    :func:`location_uncertainty_batched` with one event, on ``device``
    (default ``cuda``)."""
    dev, sta, tp, ip, ph, pm = _single_event(device, sta_cart, tpick, ipick, phase,
                                             pick_mask)
    f32 = dict(dtype=torch.float32, device=dev)
    cov = location_uncertainty_batched(
        trv_from_cart, sta, torch.as_tensor(pos, **f32)[None],
        torch.as_tensor(t0, **f32).reshape(1), tp, ip, ph, pm, sig_t=sig_t)
    return cov[0]


class SwarmState(NamedTuple):
    """Particles, velocities, each particle's best and the swarm's best."""

    pos: torch.Tensor       # (pop, d)
    vel: torch.Tensor       # (pop, d)
    pbest: torch.Tensor     # (pop, d)
    pbest_c: torch.Tensor   # (pop,)
    gbest: torch.Tensor     # (d,)
    gbest_c: torch.Tensor   # ()


def _outside(pos, hull):
    """True for particles outside the half-spaces ``hull = (A, b)`` of the
    first ``A.shape[1]`` coordinates (JAX's test, with its 1e-6 slack)."""
    a, b = hull
    return ((pos[:, :a.shape[1]] @ a.T + b[None]) > 1e-6).any(dim=1)


def pso_init(fn, bounds_lo, bounds_hi, u0, n0, hull=None) -> SwarmState:
    """The swarm before the first step, from uniform draws ``u0`` and normal
    draws ``n0`` (both (pop, d)). Particles outside the hull get cost inf, so
    they never seed a best."""
    span = bounds_hi - bounds_lo
    pos = bounds_lo + span * u0
    vel = 0.1 * span * n0
    cost = fn(pos)
    if hull is not None:
        cost = torch.where(_outside(pos, hull), torch.full_like(cost, float("inf")), cost)
    ib = torch.argmin(cost)
    return SwarmState(pos, vel, pos, cost, pos[ib], cost[ib])


def pso_step(fn, state: SwarmState, bounds_lo, bounds_hi, r1, r2, u_new=None,
             n_new=None, hull=None, w: float = 0.7, c1: float = 1.5,
             c2: float = 1.5) -> SwarmState:
    """One move of the swarm from uniform draws ``r1``, ``r2`` (pop, d). With
    ``hull``, particles that leave it restart at ``bounds_lo + span·u_new``
    with velocity ``0.1·span·n_new``; one that is still outside keeps moving
    but never enters a best."""
    pos, vel, pbest, pbest_c, gbest, _ = state
    vel = w * vel + c1 * r1 * (pbest - pos) + c2 * r2 * (gbest[None] - pos)
    pos = torch.minimum(torch.maximum(pos + vel, bounds_lo), bounds_hi)
    if hull is not None:
        span = bounds_hi - bounds_lo
        out = _outside(pos, hull)[:, None]
        pos = torch.where(out, bounds_lo + span * u_new, pos)
        vel = torch.where(out, 0.1 * span * n_new, vel)
    cost = fn(pos)
    if hull is not None:
        cost = torch.where(_outside(pos, hull), torch.full_like(cost, float("inf")), cost)
    better = cost < pbest_c
    pbest = torch.where(better[:, None], pos, pbest)
    pbest_c = torch.where(better, cost, pbest_c)
    ib = torch.argmin(pbest_c)
    return SwarmState(pos, vel, pbest, pbest_c, pbest[ib], pbest_c[ib])


def pso_minimize(fn, bounds_lo, bounds_hi, generator, popsize: int = 64,
                 n_iter: int = 100, w: float = 0.7, c1: float = 1.5, c2: float = 1.5,
                 hull_A=None, hull_b=None):
    """Vectorized particle swarm (the reference's
    ``MLE_particle_swarm_location_with_hull``): ``fn`` maps (pop, d) →
    (pop,). With ``hull_A``/``hull_b`` (the half-spaces of
    ``utils.hull_halfspaces``) particles that leave the hull are re-drawn
    uniformly in the bounds; otherwise the bounds clip. Draws come from
    ``generator`` on the bounds' device in JAX's order: the initial
    positions and velocities, then per step r1, r2 and, with a hull, the
    re-draws. Returns (x_best (d,), cost_best)."""
    dev = bounds_lo.device
    shape = (popsize, bounds_lo.shape[0])
    hull = None
    if hull_A is not None:
        hull = (torch.as_tensor(hull_A, dtype=torch.float32, device=dev),
                torch.as_tensor(hull_b, dtype=torch.float32, device=dev))

    def rand():
        return torch.rand(shape, generator=generator, device=dev)

    def randn():
        return torch.randn(shape, generator=generator, device=dev)

    state = pso_init(fn, bounds_lo, bounds_hi, rand(), randn(), hull)
    for _ in range(n_iter):
        r1, r2 = rand(), rand()
        u_new, n_new = (rand(), randn()) if hull is not None else (None, None)
        state = pso_step(fn, state, bounds_lo, bounds_hi, r1, r2, u_new, n_new, hull,
                         w=w, c1=c1, c2=c2)
    return state.gbest, state.gbest_c


def locate_source_pso(generator, trv_from_cart, sta_cart, tpick, ipick, phase,
                      pick_mask, bounds_lo, bounds_hi, popsize: int = 128,
                      n_iter: int = 120, trim_fraction: float = 0.2, hull_points=None,
                      n_depth: int = 64, device=None):
    """Particle-swarm location of one event with the reference's hull
    handling and final depth line-search: ``hull_points`` (e.g. the
    stations) bound the epicentre to their convex hull; at the swarm's best
    epicentre ``n_depth`` depths (a ``linspace`` of the depth bounds plus
    N(0, dz) jitter, the generator's next draw) are tried and the better of
    those and the swarm's best kept. Inputs as :func:`locate_source`;
    returns (pos (3,), t0, cost)."""
    dev, sta, tp, ip, ph, pm = _single_event(device, sta_cart, tpick, ipick, phase,
                                             pick_mask)
    lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=dev)
              for b in (bounds_lo, bounds_hi))
    obj_b = make_location_objective(trv_from_cart, sta, tp, ip, ph, pm, trim_fraction)

    def obj(cand):
        return obj_b(cand[None])[0]

    hull_A = hull_b = None
    if hull_points is not None:
        from genie_tpu_torch.utils import hull_halfspaces

        pts = hull_points.cpu().numpy() if torch.is_tensor(hull_points) else hull_points
        hull_A, hull_b = hull_halfspaces(np.asarray(pts)[:, :2])   # epicentral hull
    x, c = pso_minimize(obj, lo, hi, generator, popsize=popsize, n_iter=n_iter,
                        hull_A=hull_A, hull_b=hull_b)
    dz = (hi[2] - lo[2]) / n_depth
    zq = torch.linspace(float(lo[2]), float(hi[2]), n_depth, device=dev) \
        + dz * torch.randn(n_depth, generator=generator, device=dev)
    zq = torch.minimum(torch.maximum(zq, lo[2]), hi[2])
    cand = x[None].repeat(n_depth, 1)
    cand[:, 2] = zq
    cz = obj(cand)
    iz = torch.argmin(cz)
    x = torch.where(cz[iz] < c, cand[iz], x)
    c = torch.minimum(cz[iz], c)
    return x[:3], x[3], c
