"""Bayesian optimization of synthetic-data parameters.

Copied from ``genie_tpu/train/bayes_opt.py`` (numpy only); ``apply_params``
writes the port's ``config.SyntheticConfig``. The objective of
``scripts/nc_optimize_data.py`` on the port's generator is
``workflow.optimize_data_objective``.

The reference ships this flow disabled (``train_GENIE_model.py:1887-2160``):
skopt ``gp_minimize`` with EI over 11 generator parameters, minimizing the
mismatch between pick statistics of synthetic timelines and of REAL pick
days (``sample_picks``: per-station hourly count quantiles + spatial
coincidence ratios). This module implements both halves natively — a small
GP(+RBF)/expected-improvement minimizer (no skopt in the image) and the
pick-statistics objective — so the capability actually runs here.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- GP + EI

def _rbf(a, b, ls):
    d2 = ((a[:, None, :] - b[None, :, :]) / ls[None, None, :]) ** 2
    return np.exp(-0.5 * d2.sum(-1))


def gp_minimize(fn, bounds, n_calls: int = 60, n_random_starts: int = 20,
                seed: int = 0, noise: float = 1e-4, n_candidates: int = 4096,
                callback=None):
    """Minimize ``fn(x)`` over box ``bounds`` [(lo, hi), ...] with a GP
    surrogate + expected improvement — the reference's skopt call signature
    (acq EI, random init, Gaussian noise) on a plain numpy GP.

    Returns ``(x_best, y_best, X, Y)``. Lengthscales use the median
    heuristic in unit-box coordinates; the acquisition is maximized over
    ``n_candidates`` uniform samples (plenty at n_calls≈150, d≈11).
    """
    rng = np.random.default_rng(seed)
    bounds = np.asarray(bounds, np.float64)
    lo, hi = bounds[:, 0], bounds[:, 1]
    d = len(bounds)

    def to_unit(x):
        return (x - lo) / (hi - lo)

    X, Y = [], []
    n_random_starts = min(n_random_starts, n_calls)
    for i in range(n_random_starts):
        x = lo + (hi - lo) * rng.uniform(size=d)
        X.append(x)
        Y.append(float(fn(x)))
        if callback:
            callback(i, X[-1], Y[-1])

    for i in range(n_random_starts, n_calls):
        Xu = to_unit(np.asarray(X))
        y = np.asarray(Y)
        y_mu, y_sd = y.mean(), max(y.std(), 1e-12)
        yn = (y - y_mu) / y_sd
        # median-heuristic ARD lengthscales in the unit box
        if len(Xu) > 1:
            med = np.median(np.abs(Xu[:, None, :] - Xu[None, :, :]), axis=(0, 1))
            ls = np.maximum(med, 0.05)
        else:
            ls = np.full(d, 0.3)
        K = _rbf(Xu, Xu, ls) + noise * np.eye(len(Xu))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cand = rng.uniform(size=(n_candidates, d))
        # densify around the incumbent (local refinement half of the budget)
        best_u = Xu[np.argmin(yn)]
        local = np.clip(best_u[None] + 0.05 * rng.normal(
            size=(n_candidates // 4, d)), 0, 1)
        cand = np.concatenate((cand, local))
        Kc = _rbf(cand, Xu, ls)
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        sd = np.sqrt(var)
        y_best = yn.min()
        z = (y_best - mu) / sd
        from math import erf, pi
        Phi = 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))
        phi = np.exp(-0.5 * z ** 2) / np.sqrt(2 * pi)
        ei = (y_best - mu) * Phi + sd * phi
        x = lo + (hi - lo) * cand[np.argmax(ei)]
        X.append(x)
        Y.append(float(fn(x)))
        if callback:
            callback(i, X[-1], Y[-1])

    j = int(np.argmin(Y))
    return np.asarray(X[j]), float(Y[j]), np.asarray(X), np.asarray(Y)


# ------------------------------------------------- pick statistics (Trgts)

def pick_statistics(pick_t, pick_sta, sta_cart, t_sample_win: float = 120.0,
                    windows=(40e3, 150e3, 300e3), max_t: float = 500.0,
                    n_iter: int = 150, seed: int = 0):
    """The reference's ``sample_picks`` targets (train_GENIE_model.py:
    1965-2040), the two statistics its objective leans on:

    [1] quantiles (0.1..0.9) of per-station hourly pick counts (median over
        hours) — overall rate + station heterogeneity;
    [2] for each spatial window radius: quantiles of the ratio of picks on
        stations within the radius of a random root station to picks
        outside, inside random ``max_t``-fraction time balls — measures
        spatio-temporal clustering (events light up nearby stations).

    Returns a list of 1-D arrays (one per statistic block).
    """
    rng = np.random.default_rng(seed)
    pick_t = np.asarray(pick_t)
    pick_sta = np.asarray(pick_sta).astype(int)
    sta_cart = np.asarray(sta_cart)
    n_sta = len(sta_cart)
    T = max(float(pick_t.max()) if len(pick_t) else 3600.0, 3600.0)
    qs = np.arange(0.1, 1.0, 0.2)

    # [1] per-station hourly count quantiles
    hours = np.arange(0, T + 3600, 3600.0)
    counts = np.zeros((n_sta, len(hours) - 1))
    for j in range(n_sta):
        counts[j] = np.histogram(pick_t[pick_sta == j], bins=hours)[0]
    s1 = np.median(np.quantile(counts, qs, axis=0), axis=1)

    # [2] spatial coincidence ratios
    pw = np.linalg.norm(sta_cart[:, None, :2] - sta_cart[None, :, :2], axis=2)
    order = np.argsort(pick_t)
    t_sorted = pick_t[order]
    sta_sorted = pick_sta[order]
    ratios = [[] for _ in windows]
    for _ in range(n_iter):
        root = rng.integers(0, n_sta)
        t0 = rng.uniform(0, T)
        i0, i1 = np.searchsorted(t_sorted, (t0 - 0.3 * max_t, t0 + 0.3 * max_t))
        ss = sta_sorted[i0:i1]
        for k, w in enumerate(windows):
            inside_set = pw[root] < w
            n_in = int(inside_set[ss].sum())
            ratios[k].append(n_in / max(len(ss) - n_in, 1.0))
    s2 = np.concatenate([np.quantile(r, qs) for r in ratios])
    return [s1, s2]


def stats_residual(stats, targets_list, n_random: int = 30, seed: int = 0):
    """Mean relative L2 residual of ``stats`` against random real-day target
    draws (ref ``evaluate_bayesian_objective``, :2140-2152)."""
    rng = np.random.default_rng(seed)
    res = 0.0
    for _ in range(n_random):
        tg = targets_list[rng.integers(0, len(targets_list))]
        for s, t in zip(stats, tg):
            res += (np.linalg.norm(s - t)
                    / max(np.linalg.norm(t), 1e-5)) / n_random
    return res


PARAM_SPACE = [
    # (config field, lo, hi) — the reference's 11-parameter box
    # (train_GENIE_model.py:1931-1941), mapped onto SyntheticConfig
    ("spc_random", 100.0, 300e3),
    ("spc_thresh_rand", 100.0, 300e3),
    ("coda_rate", 0.001, 0.3),
    ("coda_win_hi", 1.0, 180.0),
    ("dist_range_lo", 5000.0, 149e3),
    ("dist_range_hi", 300e3, 800e3),
    ("max_rate_events", 5.0, 250.0),
    ("max_false_events", 0.2, 5.0),     # ratio, as in the reference's x[8]
    ("miss_pick_lo", 0.0, 0.25),
    ("miss_pick_hi", 0.25, 0.6),
]


def apply_params(synth_cfg, x):
    """Write an optimizer vector into a SyntheticConfig (in place)."""
    names = [p[0] for p in PARAM_SPACE]
    v = dict(zip(names, x))
    synth_cfg.spc_random = float(v["spc_random"])
    synth_cfg.spc_thresh_rand = float(v["spc_thresh_rand"])
    synth_cfg.coda_rate = float(v["coda_rate"])
    synth_cfg.coda_win = (synth_cfg.coda_win[0], float(v["coda_win_hi"]))
    synth_cfg.dist_range = (float(v["dist_range_lo"]), float(v["dist_range_hi"]))
    synth_cfg.max_rate_events = float(v["max_rate_events"])
    synth_cfg.max_false_events = float(v["max_false_events"])
    synth_cfg.miss_pick_fraction = (float(v["miss_pick_lo"]),
                                    float(v["miss_pick_hi"]))
    return synth_cfg
