"""Synthetic training data on the device, and the window featurizers.

Port of ``genie_tpu/synth/generator.py``: a T-second timeline of events and
picks (:func:`synthesize_timeline`, every mechanism of the JAX generator:
smooth time-varying rates, Poisson event counts, reference-catalog density,
shallow sources, aftershocks, the topography clamp, moveout truncation,
``s_extra``, correlated or per-event biased arrival noise, stable
association labels, missed picks, coda, false picks with the clean-interval
carve-out and network-wide spikes, phase flips), then ``n_batch`` training
windows cut from it (:func:`make_windows`).

Everything is torch on one device with static shapes: ``max_events``
events, ``2·max_events·n_sta`` true and as many coda slots, ``n_false_max``
false slots, ``max_picks`` picks per window. Randomness comes from an
explicit ``torch.Generator`` on that device, so the draws differ from
``jax.random``'s and the two generators agree in distribution. Gamma and
beta variates are built from uniforms and normals (the shapes the generator
uses are 1, 1.5, (2, 5) and (1, 5)), since ``torch._standard_gamma`` takes
no generator.

:func:`make_windows` is split in two so that each half can be held to the
JAX package: :func:`draw_windows` makes the random draws (window times with
preferential sampling, grid indices, station subsets with
``fixed_subnetworks``, query points with their exact and focused rows,
association query sources), and :func:`window_from_draws` computes the rest
deterministically from the timeline and those draws, which are exactly what
a :class:`WindowBatch` records. The JAX function's ``interior_mask_fn``
hook, which no caller sets, is not carried.

The featurizers (:func:`featurize_window`, :func:`featurize_window_rasterized`,
``genie_tpu/synth/generator.py:326-424``) take pick arrays with a leading
window axis ``B`` and one shared ``trv_grid`` (n_src, n_sta, 2); both return
``(feat, mask)`` of shape (B, n_src, n_sta, 4): nearest-any-pick vs
theoretical P, vs S; nearest same-phase pick vs P, vs S.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genie_tpu_torch.ops.knn import knn_graph

# label time slices per window, over [-t_win/2, t_win/2]
N_T = 9


class Timeline(NamedTuple):
    """One T-second synthetic timeline of events and picks (padded)."""

    ev_pos_cart: torch.Tensor   # (E, 3)
    ev_time: torch.Tensor       # (E,)
    ev_mag: torch.Tensor        # (E,)
    ev_mask: torch.Tensor       # (E,) bool
    pick_t: torch.Tensor        # (N,) absolute pick times
    pick_sta: torch.Tensor      # (N,) int32
    pick_phase: torch.Tensor    # (N,) int32 0/1 (after flips)
    pick_event: torch.Tensor    # (N,) int32 event id, -1 = false pick
    pick_assoc_ok: torch.Tensor  # (N,) bool, eligible for a positive assoc label
    pick_mask: torch.Tensor     # (N,) bool


class WindowBatch(NamedTuple):
    """Per-window tensors (leading axis n_batch) feeding the Detector."""

    feat: torch.Tensor          # (B, n_src, n_sta, 4)
    mask: torch.Tensor          # (B, n_src, n_sta, 4)
    sta_mask: torch.Tensor      # (B, n_sta) bool, per-window station subset
    sta_nbr: torch.Tensor       # (B, n_sta, k_sta) int32
    sta_nbr_valid: torch.Tensor  # (B, n_sta, k_sta) bool
    grid_idx: torch.Tensor      # (B,) int32, which spatial grid
    t_sample: torch.Tensor      # (B,)
    tpick: torch.Tensor         # (B, n_pick) window-relative pick times
    ipick: torch.Tensor         # (B, n_pick) int32
    phase: torch.Tensor         # (B, n_pick, 1)
    pick_mask: torch.Tensor     # (B, n_pick) bool
    x_query: torch.Tensor       # (B, n_q, 3) cart
    x_qsrc: torch.Tensor        # (B, n_qsrc, 3) cart
    tq_sample: torch.Tensor     # (B, n_qsrc)
    lbl_grid: torch.Tensor      # (B, n_src, n_t)
    lbl_query: torch.Tensor     # (B, n_q, n_t)
    lbl_assoc: torch.Tensor     # (B, n_qsrc, n_pick, 2)


# -- random variates from a generator ---------------------------------------

def _rand(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _exponential(gen, shape):
    return -torch.log1p(-_rand(gen, shape))


def _gamma(gen, shape, alpha: float):
    """Gamma(alpha, 1) for alpha a positive multiple of 1/2: a sum of
    exponentials plus, for the half, N²/2."""
    n_exp, half = int(alpha), (2 * alpha) % 2 == 1
    if float(n_exp + 0.5 * half) != float(alpha) or alpha <= 0:
        raise ValueError(f"_gamma: shape {alpha} is not a positive multiple of 1/2")
    out = torch.zeros(shape, device=gen.device)
    for _ in range(n_exp):
        out = out + _exponential(gen, shape)
    if half:
        out = out + 0.5 * _randn(gen, shape) ** 2
    return out


def _beta(gen, shape, a: float, b: float):
    x = _gamma(gen, shape, a)
    return x / (x + _gamma(gen, shape, b))


def _laplace(gen, shape):
    u = _rand(gen, shape) - 0.5
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def _randint(gen, shape, high):
    """Uniform integers in [0, high); ``high`` may be a device tensor."""
    return torch.clamp((_rand(gen, shape) * high).long(), max=high - 1)


def _uniform_choice(gen, allowed, n: int):
    """``n`` indices drawn uniformly among the True entries of ``allowed``
    (..., E) → (..., n); arbitrary where none is True."""
    u = _rand(gen, (*allowed.shape[:-1], n, allowed.shape[-1]))
    return torch.where(allowed[..., None, :], u, -1.0).argmax(dim=-1)


# -- rate processes ----------------------------------------------------------

def smooth_rate_from_noise(noise, tscale_bins: float):
    """|noise ⊛ Gaussian|, normalized to mean 1 (the reference's fftconvolve
    rate construction, :505-538), for a given white-noise draw."""
    n_bins = noise.shape[-1]
    half = n_bins // 2
    t = torch.arange(-half, n_bins - half, device=noise.device, dtype=torch.float32)
    kern = torch.fft.fftshift(torch.exp(-0.5 * (t / max(tscale_bins, 1.0)) ** 2))
    sm = torch.fft.ifft(torch.fft.fft(noise) * torch.fft.fft(kern)).real.abs()
    return sm / torch.clamp_min(sm.mean(), 1e-9)


def smooth_rate(gen, n_bins: int, tscale_bins: float):
    """Positive smooth random process of ``n_bins`` bins, mean 1."""
    return smooth_rate_from_noise(_randn(gen, (n_bins,)), tscale_bins)


def times_from_rate(rate, u, u_bin, T: float):
    """Inverse-CDF times from a binned rate for given uniforms: ``u`` picks
    the bin, ``u_bin`` the position inside it."""
    cdf = torch.cumsum(rate, 0) / rate.sum()
    idx = torch.searchsorted(cdf, u.contiguous())
    dt_bin = T / rate.shape[0]
    return idx * dt_bin + u_bin * dt_bin


def _sample_times_from_rate(gen, rate, n: int, T: float):
    """Inverse-CDF sampling of n times from a binned rate process."""
    return times_from_rate(rate, _rand(gen, (n,)), _rand(gen, (n,)), T)


def surface_elevation(surface, xy):
    """Bilinear surface elevation (cart z) at ``xy`` (..., 2). ``surface`` =
    (elev (nx, ny), lo (2,), h (2,)), a rasterized topography grid in
    projected coordinates."""
    elev, lo, h = surface
    nx, ny = elev.shape
    fx = torch.clamp((xy[..., 0] - lo[0]) / h[0], 0.0, nx - 1.001)
    fy = torch.clamp((xy[..., 1] - lo[1]) / h[1], 0.0, ny - 1.001)
    i0 = torch.floor(fx).long()
    j0 = torch.floor(fy).long()
    wx = fx - i0
    wy = fy - j0
    return ((1 - wx) * (1 - wy) * elev[i0, j0] + wx * (1 - wy) * elev[i0 + 1, j0]
            + (1 - wx) * wy * elev[i0, j0 + 1] + wx * wy * elev[i0 + 1, j0 + 1])


# -- timeline ----------------------------------------------------------------

def synthesize_timeline(gen, cfg, sta_cart, trv_from_cart, scale_cart, offset_cart,
                        depth_range, n_sta_real: int, surface=None,
                        ref_srcs_cart=None, corr_chol=None) -> Timeline:
    """One timeline on ``gen``'s device. ``trv_from_cart(sta_cart, src_cart)
    -> (n_ev, n_sta, 2)``; scale/offset define the (padded) Cartesian
    sampling box; ``surface`` (elev, lo, h) clamps event depths below the
    local surface; ``ref_srcs_cart`` (n_ref, 3) feeds the reference-density
    option; ``corr_chol`` (n_sta, n_sta) colours the correlated noise."""
    E = cfg.max_events
    n_sta = sta_cart.shape[0]
    T = cfg.T
    dev = gen.device
    n_bins = int(round(cfg.T / cfg.dt_rate))
    lo_z, hi_z = (float(d) for d in depth_range)

    # --- events -----------------------------------------------------------
    rate = smooth_rate(gen, n_bins, cfg.tscale / cfg.dt_rate)
    lam = cfg.max_rate_events * _rand(gen, (1,), 0.25, 1.0)
    n_ev = torch.clamp(torch.poisson(lam, generator=gen), max=E).long()[0]
    ev_mask = torch.arange(E, device=dev) < n_ev
    ev_time = _sample_times_from_rate(gen, rate, E, T)
    ev_pos = _rand(gen, (E, 3)) * scale_cart + offset_cart
    if ref_srcs_cart is not None and cfg.use_reference_spatial_density:
        # blurred reference-catalog draws replace a fraction of positions
        # (ref :551-557); out-of-range depths resample uniformly
        idx = _randint(gen, (E,), ref_srcs_cart.shape[0])
        cand = ref_srcs_cart[idx] + cfg.spatial_sigma * _randn(gen, (E, 3))
        z_bad = (cand[:, 2] < lo_z) | (cand[:, 2] > hi_z)
        z_uni = _rand(gen, (E,)) * (hi_z - lo_z) + lo_z
        cand = torch.cat((cand[:, :2], torch.where(z_bad, z_uni, cand[:, 2])[:, None]), 1)
        take = _rand(gen, (E,)) < cfg.frac_reference_catalog
        ev_pos = torch.where(take[:, None], cand, ev_pos)
    if cfg.use_shallow_sources:
        g = _gamma(gen, (E,), 1.5) * 6e3
        ev_pos = torch.cat((ev_pos[:, :2], torch.clamp(hi_z - g, lo_z, hi_z)[:, None]), 1)
    ev_mag = _rand(gen, (E,), -1.0, 7.0)

    if cfg.use_aftershocks:
        # ~10% of events relocate near an earlier event (:567-579)
        is_aft = (_rand(gen, (E,)) < 0.1) & ev_mask
        parent = _randint(gen, (E,), torch.clamp_min(n_ev, 1))
        sign = torch.where(_rand(gen, (E, 3)) < 0.5, -1.0, 1.0)
        off = _gamma(gen, (E, 3), 1.0) * 2e3 * sign
        ev_pos = torch.where(is_aft[:, None], ev_pos[parent] + off, ev_pos)
        ev_time = torch.where(
            is_aft, torch.clamp(ev_time[parent] + _gamma(gen, (E,), 1.0) * 120.0, 0, T),
            ev_time)

    if surface is not None:
        elev = surface_elevation(surface, ev_pos[:, :2])
        ev_pos = torch.cat((ev_pos[:, :2], torch.minimum(ev_pos[:, 2], elev)[:, None]), 1)

    # --- moveout truncation ----------------------------------------------
    d0, d1 = cfg.dist_range
    b1 = _beta(gen, (E,), 2.0, 5.0)
    b2 = _beta(gen, (E,), 1.0, 5.0)
    mix = _rand(gen, (E,)) < 0.5
    max_dist = d0 + (d1 - d0) * torch.where(mix, b1, b2)
    if cfg.use_extra_nearby_moveouts:
        nearby = _rand(gen, (E,)) < 0.5
        max_dist = torch.where(nearby, max_dist * 0.5, max_dist)
    long_range = _rand(gen, (E,)) < 0.05
    max_dist = torch.where(long_range, torch.clamp(max_dist * 3.0, max=d1), max_dist)

    dist = torch.linalg.norm(ev_pos[:, None, :] - sta_cart[None, :, :], dim=-1)  # (E, n_sta)
    lap = _laplace(gen, (E, 2)) * cfg.spc_thresh_rand
    thresh = max_dist[:, None, None] + lap[:, None, :]               # (E, 1, 2)
    pair_jit = _randn(gen, (E, n_sta, 2)) * cfg.spc_random
    has_phase = dist[:, :, None] + pair_jit < thresh                 # (E, n_sta, 2)
    sta_valid = torch.arange(n_sta, device=dev) < n_sta_real
    has_phase = has_phase & ev_mask[:, None, None] & sta_valid[None, :, None]
    if cfg.s_extra != 0.0:
        keep_s = _rand(gen, (E, n_sta)) > cfg.s_extra
        has_phase = torch.stack((has_phase[..., 0], has_phase[..., 1] & keep_s), -1)

    # --- arrival synthesis -----------------------------------------------
    trv = trv_from_cart(sta_cart, ev_pos)                            # (E, n_sta, 2)
    if corr_chol is not None and cfg.use_correlated_noise:
        # spatially-correlated noise (ref :417-481): per-event bias factor
        # on the moveout, per-station softplus scales ∝ travel time, and a
        # station-distance Cholesky colouring the Gaussian draws
        rel1, rel2, cb1, cb2, _, sp_beta, sp_shift = cfg.corr_noise_params
        bias_val = _rand(gen, (E, 1, 2), 1.0 - cb1, 1.0 + cb2)
        std_val = _rand(gen, (E, 1, 2), rel1, rel1 + rel2)
        trv = trv * bias_val
        beta = 10.0 ** sp_beta
        scale = torch.nn.functional.softplus(beta * (trv * std_val + sp_shift)) / beta
        z = _randn(gen, (E, n_sta, 2))
        noise = scale * torch.einsum("st,etp->esp", corr_chol, z)
    else:
        # correlated P/S systematic velocity bias per event (:679-697)
        zb = _randn(gen, (E, 2))
        corr = 0.5 * (zb[:, 0:1] + zb[:, 1:2])
        bias = cfg.total_bias * 0.5 * (zb + corr)                    # (E, 2)
        trv = trv * (1.0 + bias[:, None, :])
        noise = _laplace(gen, (E, n_sta, 2)) * cfg.sig_t * trv
    t_arr = ev_time[:, None, None] + trv + noise

    # excess-noise picks lose their positive association label (:782-813)
    if cfg.use_stable_association_labels:
        lim = torch.clamp_min(cfg.thresh_noise_max * cfg.sig_t * trv,
                              cfg.min_misfit_allowed)
        assoc_ok = noise.abs() < lim
    else:
        assoc_ok = torch.ones_like(noise, dtype=torch.bool)

    # --- missed picks (global fraction × per-station rate, :716-733) ------
    mf = _rand(gen, (), *cfg.miss_pick_fraction)
    sta_rate = smooth_rate(gen, n_sta, 4.0)
    miss_p = torch.clamp(mf * sta_rate[None, :, None], 0.0, 0.95)
    kept = has_phase & ~(_rand(gen, has_phase.shape) < miss_p)

    # --- coda false picks (attached to true picks, :736-740) -------------
    coda = (_rand(gen, kept.shape) < cfg.coda_rate) & kept
    t_coda = t_arr + _rand(gen, kept.shape, *cfg.coda_win)

    # --- flatten true + coda picks ---------------------------------------
    shape = kept.shape
    true_ev = torch.arange(E, device=dev)[:, None, None].expand(shape).reshape(-1)
    true_sta = torch.arange(n_sta, device=dev)[None, :, None].expand(shape).reshape(-1)
    true_ph = torch.arange(2, device=dev)[None, None, :].expand(shape).reshape(-1)
    true_m = kept.reshape(-1)

    # --- false picks ------------------------------------------------------
    NF = cfg.n_false_max
    f_rate = smooth_rate(gen, n_bins, cfg.tscale / cfg.dt_rate)
    lam_f = torch.clamp(cfg.max_false_events * true_m.sum().float(), max=NF)
    n_false = torch.clamp(torch.poisson(lam_f.reshape(1), generator=gen), max=NF)[0]
    false_t = _sample_times_from_rate(gen, f_rate, NF, T)
    false_sta = _randint(gen, (NF,), n_sta_real)
    false_ph = _randint(gen, (NF,), 2)
    false_m = torch.arange(NF, device=dev) < n_false

    # clean-interval carve-out (:748-755): no false picks over one random
    # contiguous 10-30% stretch (masking the drawn picks there equals a zero
    # Poisson rate); spikes are exempt, as the reference appends them after
    if cfg.use_clean_data_interval:
        f0, f1 = cfg.clean_interval_frac
        frac = f0 + (f1 - f0) * _rand(gen, ())
        start = _rand(gen, ()) * (1.0 - frac) * T
        in_clean = (false_t >= start) & (false_t < start + frac * T)
    else:
        in_clean = torch.zeros((NF,), dtype=torch.bool, device=dev)

    # network-wide spikes (:769-779): relocate some false picks to shared times
    n_spk = cfg.max_num_spikes
    if n_spk > 0:
        spk_t = _rand(gen, (n_spk,)) * T
        spk_assign = _randint(gen, (NF,), n_spk)
        in_spike = _rand(gen, (NF,)) < 0.1
        spread = _randn(gen, (NF,)) * cfg.spike_time_spread
        false_t = torch.where(in_spike, spk_t[spk_assign] + spread, false_t)
    else:
        in_spike = torch.zeros((NF,), dtype=torch.bool, device=dev)
    false_m = false_m & (in_spike | ~in_clean)

    pick_t = torch.cat((t_arr.reshape(-1), t_coda.reshape(-1), false_t))
    pick_sta = torch.cat((true_sta, true_sta, false_sta)).to(torch.int32)
    pick_ph = torch.cat((true_ph, true_ph, false_ph)).to(torch.int32)
    pick_ev = torch.cat((true_ev, torch.full_like(true_ev, -1),
                         torch.full((NF,), -1, device=dev))).to(torch.int32)
    pick_ok = torch.cat(((assoc_ok & kept).reshape(-1), torch.zeros_like(coda.reshape(-1)),
                         torch.zeros_like(false_m)))
    pick_m = torch.cat((true_m, coda.reshape(-1), false_m))

    # random phase-type flips, 10-30% of picks (:853-861)
    flip_frac = _rand(gen, (), 0.1, 0.3)
    flips = _rand(gen, pick_ph.shape) < flip_frac
    pick_ph = torch.where(flips, 1 - pick_ph, pick_ph)

    return Timeline(ev_pos, ev_time, ev_mag, ev_mask, pick_t, pick_sta,
                    pick_ph, pick_ev, pick_ok, pick_m)


# -- featurizers -------------------------------------------------------------

def _nearest_gauss(query_t, sorted_keys, n_valid, kernel_sig_t):
    """exp(-Δt²/2σ²) to the nearest entry of each window's sorted key array.
    query_t (B, Q); sorted_keys (B, n_pick); n_valid (B,)."""
    idx = torch.searchsorted(sorted_keys, query_t.contiguous())    # left side
    hi = (n_valid - 1)[:, None]
    lo_c = torch.minimum(torch.clamp_min(idx - 1, 0), hi)
    hi_c = torch.minimum(torch.clamp_min(idx, 0), hi)
    lo_c = torch.where(lo_c < 0, lo_c + sorted_keys.shape[1], lo_c)
    hi_c = torch.where(hi_c < 0, hi_c + sorted_keys.shape[1], hi_c)
    rel = torch.minimum((query_t - torch.gather(sorted_keys, 1, lo_c)).abs(),
                        (query_t - torch.gather(sorted_keys, 1, hi_c)).abs())
    rel = torch.where((n_valid > 0)[:, None], rel,
                      torch.full_like(rel, 10.0 * kernel_sig_t))
    return torch.exp(-0.5 * rel ** 2 / kernel_sig_t ** 2)


def featurize_window(tpick, ipick, phase, pick_mask, trv_grid, kernel_sig_t,
                     sta_mask):
    """Searchsorted featurizer (exact nearest-pick distances). Station keys
    are separated by a span-scaled offset: large enough to exceed every time
    in play, small enough that float32 keeps sub-kernel resolution at the
    highest station index."""
    B, n_pick = tpick.shape
    n_src, n_sta = trv_grid.shape[:2]
    off = (torch.maximum(tpick.abs().amax(dim=1), trv_grid.max()) * 1.25
           + 100.0)                                          # (B,)
    ipf = ipick.to(tpick.dtype)

    def sorted_keys(valid):
        keys = torch.where(valid, tpick + off[:, None] * ipf,
                           torch.full_like(tpick, float("inf")))
        return torch.sort(keys, dim=1).values, valid.sum(dim=1)

    k_any, n_any = sorted_keys(pick_mask)
    k_p, n_p = sorted_keys(pick_mask & (phase[..., 0] < 0.5))
    k_s, n_s = sorted_keys(pick_mask & (phase[..., 0] > 0.5))
    sta_off = off[:, None, None] * torch.arange(
        n_sta, device=tpick.device, dtype=tpick.dtype)[None, None, :]
    q_p = (trv_grid[None, :, :, 0] + sta_off).reshape(B, -1)
    q_s = (trv_grid[None, :, :, 1] + sta_off).reshape(B, -1)
    feats = [_nearest_gauss(q, k, n, kernel_sig_t).reshape(B, n_src, n_sta)
             for q, k, n in ((q_p, k_any, n_any), (q_s, k_any, n_any),
                             (q_p, k_p, n_p), (q_s, k_s, n_s))]
    feat = torch.stack(feats, dim=-1) * sta_mask[None, None, :, None]
    return feat, (feat.abs() > 0.01).to(feat.dtype)


def featurize_window_rasterized(tpick, ipick, phase, pick_mask, trv_grid,
                                kernel_sig_t, sta_mask, t_lo: float,
                                t_hi: float):
    """Rasterize picks into per-station series (bin ``kernel_sig_t/10``) by
    scatter-max of Gaussian bumps, then gather each (src, sta, phase) pair at
    its theoretical travel-time bin (the reference's updated featurizer)."""
    kernel_sig_t = float(kernel_sig_t)
    dt = kernel_sig_t / 10.0
    n_bins = int(np.ceil((t_hi - t_lo) / dt)) + 1
    B, n_pick = tpick.shape
    n_sta = trv_grid.shape[1]
    w = 50                                          # ±5σ at dt = σ/10
    offs = torch.arange(-w, w + 1, device=tpick.device, dtype=torch.int32)
    centers = torch.round((tpick - t_lo) / dt).to(torch.int32)
    bins = centers[..., None] + offs                            # (B, n_pick, 2w+1)
    t_bin = t_lo + bins * dt
    bump = torch.exp(-0.5 * ((t_bin - tpick[..., None]) / kernel_sig_t) ** 2)
    in_range = (bins >= 0) & (bins < n_bins)
    flat_all = ipick.to(torch.int64)[..., None] * n_bins + bins

    def series(valid):
        ok = valid[..., None] & in_range
        flat = torch.where(ok, flat_all, torch.zeros_like(flat_all)).reshape(B, -1)
        vals = torch.where(ok, bump, torch.zeros_like(bump)).reshape(B, -1)
        s = torch.zeros((B, n_sta * n_bins), dtype=tpick.dtype, device=tpick.device)
        return s.scatter_reduce_(1, flat, vals, "amax", include_self=True)

    s_any = series(pick_mask)
    s_p = series(pick_mask & (phase[..., 0] < 0.5))
    s_s = series(pick_mask & (phase[..., 0] > 0.5))
    sta_base = torch.arange(n_sta, device=tpick.device)[None, :] * n_bins

    def gather(s, ph):
        idx = torch.clamp(torch.round((trv_grid[:, :, ph] - t_lo) / dt), 0,
                          n_bins - 1).to(torch.int32)
        flat = (sta_base + idx).reshape(-1)
        return s[:, flat].reshape(B, *idx.shape)

    feat = torch.stack((gather(s_any, 0), gather(s_any, 1),
                        gather(s_p, 0), gather(s_s, 1)), dim=-1)
    feat = feat * sta_mask[None, None, :, None]
    return feat, (feat.abs() > 0.01).to(feat.dtype)


# -- windows -----------------------------------------------------------------

def _gauss_labels(pos_q, t_slice_abs, ev_pos, ev_time, ev_active, sig_x, sig_z,
                  sig_t):
    """Max over active events of the separable space-time Gaussian bump
    (ref :1192-1221). pos_q (..., n, 3) cart; t_slice_abs (..., n_t)
    absolute; ev_active (..., E). Returns (..., n, n_t)."""
    d2 = (((pos_q[..., :, None, :2] - ev_pos[:, :2]) / sig_x) ** 2).sum(-1) \
        + ((pos_q[..., :, None, 2] - ev_pos[:, 2]) / sig_z) ** 2    # (..., n, E)
    sp = torch.exp(-0.5 * d2)
    tm = torch.exp(-0.5 * ((t_slice_abs[..., :, None] - ev_time) / sig_t) ** 2)
    val = sp[..., :, None, :] * tm[..., None, :, :]                  # (..., n, n_t, E)
    val = torch.where(ev_active[..., None, None, :], val, 0.0)
    return val.amax(dim=-1)


def _select_picks(tl: Timeline, t0, smask, n_pick: int, t_win: float, max_t):
    """Per window (leading axis B) the ``n_pick`` picks nearest the window
    centre among those in the window at a kept station, in (station, time)
    order. Returns (tp, ip, ph, pmask, pev, pok)."""
    B = t0.shape[0]
    n_all = tl.pick_t.shape[0]
    sta = tl.pick_sta.long()[None].expand(B, n_all)
    t_rel = tl.pick_t[None] - t0[:, None]
    in_win = (tl.pick_mask[None] & (t_rel > -10.0) & (t_rel < t_win + max_t + 10.0)
              & torch.gather(smask, 1, sta))
    prio = torch.where(in_win, -(t_rel - t_win / 2).abs(), float("-inf"))
    sel = torch.topk(prio, n_pick, dim=1).indices
    pmask = torch.gather(in_win, 1, sel)
    # stable ordering: (station, time) lexsort as the reference (:1129); the
    # span-scaled multiplier keeps f32 key resolution well under 1 s
    key_off = t_win + max_t + 40.0
    sta_sel = torch.gather(sta, 1, sel)
    t_sel = torch.gather(t_rel, 1, sel)
    order = torch.argsort(torch.where(pmask, sta_sel.to(t_rel.dtype) * key_off + t_sel,
                                      float("inf")), dim=1)
    sel = torch.gather(sel, 1, order)
    pmask = torch.gather(pmask, 1, order)
    tp = torch.where(pmask, torch.gather(t_rel, 1, sel), 0.0)
    ip = torch.where(pmask, torch.gather(sta, 1, sel), 0).to(torch.int32)
    ph = torch.where(pmask, tl.pick_phase.long()[sel], 0).to(torch.float32)[..., None]
    pev = torch.where(pmask, tl.pick_event.long()[sel], -1)
    pok = pmask & tl.pick_assoc_ok[sel]
    return tp, ip, ph, pmask, pev, pok


def _active_events(cfg, tcfg, tl: Timeline, t0, ip, pmask, pev, n_sta: int,
                   t_win: float):
    """(B, E) events active in each window (:946-949): at least
    ``min_sta_arrival`` stations and ``min_pick_arrival`` picks among the
    window's picks, origin time near the window."""
    B = ip.shape[0]
    E = tl.ev_pos_cart.shape[0]
    dev = ip.device
    real = pmask & (pev >= 0)
    n_pick_ev = torch.zeros((B, E + 1), device=dev).scatter_add_(
        1, torch.where(real, pev, E), real.float())[:, :E]
    cell = torch.where(real, pev, 0) * n_sta + ip.long()
    uniq = torch.zeros((B, E * n_sta), device=dev).scatter_reduce_(
        1, cell, real.float(), "amax")
    n_sta_ev = uniq.reshape(B, E, n_sta).sum(-1)
    span = 2.5 * tcfg.src_t_kernel * 3
    return (tl.ev_mask[None] & (n_sta_ev >= cfg.min_sta_arrival)
            & (n_pick_ev >= cfg.min_pick_arrival)
            & (tl.ev_time[None] >= t0[:, None] - span)
            & (tl.ev_time[None] <= t0[:, None] + t_win + span))


def _active_first(active):
    """Event order per window: active events first, each group by index."""
    E = active.shape[-1]
    ar = torch.arange(E, device=active.device)
    return torch.argsort(torch.where(active, ar, E + ar), dim=-1)


def window_from_draws(cfg, tcfg, gcfg, tl: Timeline, sta_cart, grids_cart, trv_grids,
                      t0, g_idx, smask, x_query, x_qsrc, tq,
                      t_win: float = 10.0) -> WindowBatch:
    """Everything of a :class:`WindowBatch` that follows from the timeline
    and the draws (``t0`` = ``t_sample`` (B,), ``g_idx`` = ``grid_idx``,
    ``smask`` = ``sta_mask`` (B, n_sta), and the final ``x_query``,
    ``x_qsrc``, ``tq_sample``): pick selection by priority, the (station,
    time) order, features, the active-event gate, the three label sets and
    the per-window station graphs (masked kNN). Deterministic."""
    B = t0.shape[0]
    n_sta = sta_cart.shape[0]
    E = tl.ev_pos_cart.shape[0]
    dev = t0.device
    g_idx = g_idx.long()
    max_t = trv_grids.max()
    tp, ip, ph, pmask, pev, pok = _select_picks(tl, t0, smask, gcfg.max_picks,
                                                t_win, max_t)
    feats = [featurize_window(tp[b:b + 1], ip[b:b + 1], ph[b:b + 1], pmask[b:b + 1],
                              trv_grids.index_select(0, g_idx[b:b + 1])[0],
                              tcfg.src_t_kernel, smask[b])
             for b in range(B)]
    feat = torch.cat([f[0] for f in feats])
    fmask = torch.cat([f[1] for f in feats])
    active = _active_events(cfg, tcfg, tl, t0, ip, pmask, pev, n_sta, t_win)

    # --- labels -------------------------------------------------------------
    t_slice = torch.linspace(-t_win / 2.0, t_win / 2.0, N_T, device=dev)
    t_abs = t0[:, None] + t_slice
    sig = (tcfg.src_x_kernel, tcfg.src_depth_kernel, tcfg.src_t_kernel)
    lbl_grid = _gauss_labels(grids_cart[g_idx], t_abs, tl.ev_pos_cart, tl.ev_time,
                             active, *sig)
    lbl_query = _gauss_labels(x_query, t_abs, tl.ev_pos_cart, tl.ev_time, active, *sig)

    # association labels (pick_labels_extract_interior_region, :1236-1249)
    ev_of_pick = torch.where(pok & (pev >= 0), pev, E)               # E → dummy
    act_of_pick = torch.gather(
        torch.cat((active, torch.zeros((B, 1), dtype=torch.bool, device=dev)), 1),
        1, ev_of_pick)
    ep = torch.cat((tl.ev_pos_cart, tl.ev_pos_cart.new_zeros(1, 3)))[ev_of_pick]
    et = torch.cat((tl.ev_time, tl.ev_time.new_zeros(1)))[ev_of_pick] - t0[:, None]
    d2 = (((x_qsrc[:, :, None, :2] - ep[:, None, :, :2]) / tcfg.src_x_arv_kernel) ** 2
          ).sum(-1) + ((x_qsrc[:, :, None, 2] - ep[:, None, :, 2])
                       / tcfg.src_depth_kernel) ** 2
    w = torch.exp(-0.5 * d2) * torch.exp(
        -0.5 * ((tq[:, :, None] - et[:, None, :]) / tcfg.src_t_arv_kernel) ** 2)
    w = w * act_of_pick[:, None, :]
    is_p = (ph[..., 0] < 0.5)[:, None, :]
    is_s = (ph[..., 0] > 0.5)[:, None, :]
    lbl_assoc = torch.stack((w * is_p, w * is_s), dim=-1)

    # per-window station graphs (masked kNN)
    graphs = [knn_graph(sta_cart / 1000.0, gcfg.k_sta_edges, mask=smask[b])
              for b in range(B)]
    return WindowBatch(
        feat=feat, mask=fmask, sta_mask=smask,
        sta_nbr=torch.stack([g[0] for g in graphs]),
        sta_nbr_valid=torch.stack([g[1] for g in graphs]),
        grid_idx=g_idx.to(torch.int32), t_sample=t0, tpick=tp, ipick=ip, phase=ph,
        pick_mask=pmask, x_query=x_query, x_qsrc=x_qsrc, tq_sample=tq,
        lbl_grid=lbl_grid, lbl_query=lbl_query, lbl_assoc=lbl_assoc)


def draw_windows(gen, cfg, tcfg, gcfg, tl: Timeline, sta_cart, n_grids: int,
                 trv_grids, scale_cart, offset_cart, t_win: float = 10.0,
                 subnetworks=None):
    """The random draws of ``tcfg.n_batch`` windows on ``gen``'s device.
    Returns (t_sample (B,), grid_idx (B,), sta_mask (B, n_sta), x_query (B,
    n_q, 3), x_qsrc (B, n_qsrc, 3), tq_sample (B, n_qsrc)).

    Window times are preferential near detectable events (ref
    train_GENIE_model.py:868-877: an event passing the min_sta/min_pick gate
    of :826-831 over the whole timeline, then t = t_event + (2/3)·σ_t·
    Laplace) half the time and uniform otherwise. Station subsets keep a
    uniform fraction ``n_sta_range`` of the stations, or, with probability
    1/2 when ``subnetworks`` (n_subnet, n_sta) are given and
    ``fixed_subnetworks`` is set, an observed day's station set. Detection
    queries are uniform in the box, except the first ``n_q // 10`` rows,
    which take the exact positions of the window's active events, and the
    next ``n_q // 5``, focused near them (ref :1193-1211); association
    query sources take the active events first, the rest uniform."""
    B = tcfg.n_batch
    n_sta = sta_cart.shape[0]
    n_q, n_qsrc = tcfg.n_spc_query, tcfg.n_src_query
    E = tl.ev_time.shape[0]
    dev = gen.device

    t_rand = _rand(gen, (B,)) * (cfg.T - t_win)
    if cfg.use_preferential_sampling:
        real = tl.pick_mask & (tl.pick_event >= 0)
        pe = torch.where(real, tl.pick_event.long(), E)
        n_pick_ev = torch.zeros(E + 1, device=dev).scatter_add_(0, pe, real.float())[:E]
        cell = torch.where(real, pe, 0) * n_sta + tl.pick_sta.long()
        uniq = torch.zeros(E * n_sta, device=dev).scatter_reduce_(
            0, cell, real.float(), "amax")
        n_sta_ev = uniq.reshape(E, n_sta).sum(-1)
        gated = tl.ev_mask & (n_sta_ev >= cfg.min_sta_arrival) & \
            (n_pick_ev >= cfg.min_pick_arrival)
        ev_choice = _uniform_choice(gen, gated, B)
        t_near = tl.ev_time[ev_choice] + (2.0 / 3.0) * tcfg.src_t_kernel * _laplace(gen, (B,))
        use_near = (_rand(gen, (B,)) < 0.5) & gated.any()
        t_sample = torch.where(use_near, torch.clamp(t_near, 0, cfg.T - t_win), t_rand)
    else:
        t_sample = t_rand

    grid_idx = _randint(gen, (B,), n_grids)

    frac = _rand(gen, (B,), *cfg.n_sta_range)
    n_keep = torch.round(frac * n_sta).long()
    rank = torch.argsort(torch.argsort(_rand(gen, (B, n_sta)), dim=1), dim=1)
    sta_mask = rank < n_keep[:, None]
    if subnetworks is not None and cfg.fixed_subnetworks:
        subnets = torch.as_tensor(subnetworks, device=dev).bool()
        pick_sub = _randint(gen, (B,), subnets.shape[0])
        use_sub = _rand(gen, (B,)) < 0.5
        sta_mask = torch.where(use_sub[:, None], subnets[pick_sub], sta_mask)

    # the active events of each window decide the exact and focused rows
    max_t = trv_grids.max()
    _, ip, _, pmask, pev, _ = _select_picks(tl, t_sample, sta_mask, gcfg.max_picks,
                                            t_win, max_t)
    active = _active_events(cfg, tcfg, tl, t_sample, ip, pmask, pev, n_sta, t_win)
    any_active = active.any(dim=1)
    order = _active_first(active)                                   # (B, E)
    n_act = active.sum(dim=1)

    x_query = _rand(gen, (B, n_q, 3)) * scale_cart + offset_cart
    n_exact = min(n_q // 10, E)
    take_exact = torch.arange(n_exact, device=dev)[None] < n_act[:, None]
    exact = tl.ev_pos_cart[order[:, :n_exact]]
    x_exact = torch.where(take_exact[..., None], exact, x_query[:, :n_exact])
    n_foc = n_q // 5
    ev_sel = torch.where(any_active[:, None], _uniform_choice(gen, active, n_foc), 0)
    kern = torch.tensor([tcfg.src_x_kernel, tcfg.src_x_kernel, tcfg.src_depth_kernel],
                        device=dev)
    foc = tl.ev_pos_cart[ev_sel] + 2.0 * _randn(gen, (B, n_foc, 3)) * kern
    x_foc = torch.where(any_active[:, None, None], foc,
                        x_query[:, n_exact:n_exact + n_foc])
    x_query = torch.cat((x_exact, x_foc, x_query[:, n_exact + n_foc:]), dim=1)

    x_qsrc = _rand(gen, (B, n_qsrc, 3)) * scale_cart + offset_cart
    tq = _rand(gen, (B, n_qsrc)) * t_win
    take = torch.arange(n_qsrc, device=dev)[None] < torch.clamp(n_act, max=n_qsrc)[:, None]
    ev_for_q = order[:, torch.arange(n_qsrc, device=dev) % E]
    x_qsrc = torch.where(take[..., None], tl.ev_pos_cart[ev_for_q], x_qsrc)
    tq = torch.where(take, tl.ev_time[ev_for_q] - t_sample[:, None], tq)
    return t_sample, grid_idx, sta_mask, x_query, x_qsrc, tq


def make_windows(gen, cfg, tcfg, gcfg, tl: Timeline, sta_cart, grids_cart, trv_grids,
                 scale_cart, offset_cart, t_win: float = 10.0,
                 subnetworks=None) -> WindowBatch:
    """Slice a timeline into ``tcfg.n_batch`` training windows:
    :func:`draw_windows`, then :func:`window_from_draws`. grids_cart
    (n_grids, n_src, 3); trv_grids (n_grids, n_src, n_sta, 2)."""
    draws = draw_windows(gen, cfg, tcfg, gcfg, tl, sta_cart, grids_cart.shape[0],
                         trv_grids, scale_cart, offset_cart, t_win, subnetworks)
    return window_from_draws(cfg, tcfg, gcfg, tl, sta_cart, grids_cart, trv_grids,
                             *draws, t_win=t_win)
