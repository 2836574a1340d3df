"""Window featurizers on the dense product layout.

Port of the featurizers of ``genie_tpu/synth/generator.py:326-424``; the
synthetic-data generator itself (training) is not ported yet. Pick arrays
carry a leading window axis ``B``; ``trv_grid`` (n_src, n_sta, 2) is shared.
Both return ``(feat, mask)`` of shape (B, n_src, n_sta, 4): nearest-any-pick
vs theoretical P, vs S; nearest same-phase pick vs P, vs S.
"""

from __future__ import annotations

import numpy as np
import torch


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
