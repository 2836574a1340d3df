"""Competitive assignment of picks to candidate sources.

Replaces the reference's cvxpy integer program (``competitive_assignment``,
process_utils.py:879-1043) with an exact decomposition + local search that
needs no external ILP solver:

  Variables: w[arrival, source, phase] ∈ {0,1}, source activation a[q].
  Constraints: each arrival assigned to ≤1 (source, phase); for each
  (station, source, phase) at most one arrival; w ≤ a.
  Objective: maximize Σ weight·w − cost·Σ a.

Key structure: GIVEN an active source set, the inner problem decomposes per
station into small optimal bipartite matchings (arrivals at that station ×
(active source, phase) slots) — solved exactly with
``scipy.optimize.linear_sum_assignment``. Source activation is a
set-function optimization: for ≤ ``exact_max_sources`` sources every
activation subset is enumerated (provably optimal — the common case, since
components are split to ≤ max_sources ≈ 15 upstream, matching the
reference's spectral splitting); above that, greedy single-flip descent with
a pair-flip escape on the *effective* objective (unused active sources cost
nothing, as they are pruned from the solution). Randomized comparison
against brute force lives in tests/test_infer_components.py.

``competitive_assignment_split`` (ref :1045-1209) is the relaxed variant used
to divide picks between two source clusters: the per-(station, source, phase)
capacity is lifted, which makes the inner problem a simple per-arrival argmax.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _inner_assignment(weights, active, min_weight=0.0):
    """Optimal pick→(source, phase) assignment for a fixed active set.

    weights: (n_arv, n_src, 2); returns (total, assign) where
    assign[i] = (q, ph) or (-1, -1).
    """
    n_arv, n_src, _ = weights.shape
    assign = -np.ones((n_arv, 2), dtype=np.int64)
    act = np.where(active)[0]
    if len(act) == 0:
        return 0.0, assign
    total = 0.0
    # decompose by station is implicit: the caller passes per-station blocks;
    # here we require rows of `weights` to be arrivals of ONE station.
    w = weights[:, act, :].reshape(n_arv, len(act) * 2)
    w = np.where(w > min_weight, w, 0.0)
    # maximize → minimize negative; pad so assignment is optional
    rows, cols = linear_sum_assignment(-w)
    for r, c in zip(rows, cols):
        if w[r, c] > 0.0:
            q, ph = act[c // 2], c % 2
            assign[r] = (q, ph)
            total += w[r, c]
    return total, assign


def _solve_given_active(weights, ipick, active, min_weight=0.0):
    """Per-station decomposition; returns (total, assign (n_arv, 2))."""
    n_arv = weights.shape[0]
    assign = -np.ones((n_arv, 2), dtype=np.int64)
    total = 0.0
    for s in np.unique(ipick):
        rows = np.where(ipick == s)[0]
        t, a = _inner_assignment(weights[rows], active, min_weight)
        total += t
        assign[rows] = a
    return total, assign


def _effective(weights, ipick, act, cost, min_weight):
    """Objective with unused active sources pruned (they cost nothing in the
    final solution, so the search must not be charged for them either)."""
    t, a = _solve_given_active(weights, ipick, act, min_weight)
    used = np.zeros(len(act), bool)
    hit = a[:, 0] >= 0
    used[a[hit, 0]] = True
    eff = act & used
    return t - cost * eff.sum(), a, eff


def _exact_enumeration(weights, ipick, cost, min_weight, work_budget=2e6,
                       restrict=None):
    """Provably optimal activation by subset enumeration, made cheap twice
    over: (a) candidate sources decompose into independent connected
    components (two sources interact only through a station that scores
    both), each enumerated separately; (b) given an active set A, the inner
    assignment of station s depends only on A ∩ relevant(s), so inner solves
    are memoized per station on that intersection. This covers the reference
    ILP's exact regime up to the full max_sources_per_component=15 split
    bound (ref process_utils.py:879-1043), closing the 11–15-source band
    that previously fell to the heuristic. Returns None when the estimated
    enumeration work exceeds ``work_budget`` (pathologically dense
    components) — the caller then falls back to the flip heuristic, whose
    optimality gap is bounded empirically in tests."""
    n_arv, n_src, _ = weights.shape
    cand_src = np.where((weights > min_weight).any(axis=(0, 2)))[0]
    k = len(cand_src)
    assign_out = -np.ones((n_arv, 2), np.int64)
    act_out = np.zeros(n_src, bool)
    if k == 0:
        return assign_out, act_out

    stations = np.unique(ipick)
    pos_of = {q: i for i, q in enumerate(cand_src)}
    rel_masks, rows_of = [], []
    for s in stations:
        rows = np.where(ipick == s)[0]
        rel = 0
        for i, q in enumerate(cand_src):
            if (weights[rows, q, :] > min_weight).any():
                rel |= 1 << i
        rows_of.append(rows)
        rel_masks.append(rel)

    # connected components of candidate sources linked by shared stations
    parent = list(range(k))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for rel in rel_masks:
        ids = [i for i in range(k) if rel >> i & 1]
        for i in ids[1:]:
            parent[find(i)] = find(ids[0])
    # restrict pairs couple their sources: merge their components so the
    # mutual-exclusion constraint is enforced inside one enumeration
    restrict_local = []
    if restrict:
        for qa, qb in restrict:
            ia, ib = pos_of.get(int(qa)), pos_of.get(int(qb))
            if ia is None or ib is None:
                continue  # a non-candidate source is never active anyway
            restrict_local.append((ia, ib))
            parent[find(ia)] = find(ib)
    comp_masks = {}
    for i in range(k):
        r = find(i)
        comp_masks[r] = comp_masks.get(r, 0) | (1 << i)

    # two-term work estimate: the outer subset loop costs one memo lookup
    # per (subset, station) pair, while each DISTINCT per-station submask
    # costs one linear_sum_assignment solve (~100x a lookup). Components
    # whose estimate exceeds the budget fall back to the flip heuristic.
    est = 0.0
    for cm in comp_masks.values():
        kc = bin(cm).count("1")
        sta = [rel for rel in rel_masks if rel & cm]
        est += (1 << kc) * len(sta)
        est += 100.0 * sum(1 << min(bin(rel & cm).count("1"), kc)
                           for rel in sta)
    if est > work_budget:
        return None

    for cm in comp_masks.values():
        sta_ids = [si for si, rel in enumerate(rel_masks) if rel & cm]
        comp_bits = [i for i in range(k) if cm >> i & 1]
        memos = [dict() for _ in sta_ids]

        def station_solve(j, sub_bits):
            memo = memos[j]
            hit = memo.get(sub_bits)
            if hit is not None:
                return hit
            rows = rows_of[sta_ids[j]]
            act = np.zeros(n_src, bool)
            for i in comp_bits:
                if sub_bits >> i & 1:
                    act[cand_src[i]] = True
            t, a = _inner_assignment(weights[rows], act, min_weight)
            used = 0
            for q in a[a[:, 0] >= 0, 0]:
                used |= 1 << pos_of[int(q)]
            memo[sub_bits] = (t, a, used)
            return memo[sub_bits]

        pair_masks = [(1 << ia) | (1 << ib) for ia, ib in restrict_local
                      if cm >> ia & 1]  # pairs living in this component
        best_obj, best_parts, best_used = 0.0, None, 0
        kc = len(comp_bits)
        for local in range(1, 1 << kc):
            bits = 0
            for j, i in enumerate(comp_bits):
                if local >> j & 1:
                    bits |= 1 << i
            if any((bits & pm) == pm for pm in pair_masks):
                continue  # violates a mutual-exclusion (restrict) pair
            total, union_used = 0.0, 0
            parts = []
            for j in range(len(sta_ids)):
                t, a, used = station_solve(j, bits & rel_masks[sta_ids[j]])
                total += t
                union_used |= used
                parts.append(a)
            obj = total - cost * bin(union_used).count("1")
            if obj > best_obj + 1e-12:
                best_obj, best_parts, best_used = obj, parts, union_used
        if best_parts is not None:
            for j, a in enumerate(best_parts):
                rows = rows_of[sta_ids[j]]
                hit = a[:, 0] >= 0
                assign_out[rows[hit]] = a[hit]
            for i in range(k):
                if best_used >> i & 1:
                    act_out[cand_src[i]] = True
    return assign_out, act_out


def competitive_assignment(weights, ipick, cost, min_weight: float = 0.0,
                           force_n_sources: int | None = None,
                           exact_max_sources: int = 15, restrict=None):
    """Solve the activation + assignment problem.

    weights: (n_arv, n_src, 2) association scores (thresholded upstream);
    ipick: (n_arv,) station of each arrival; cost: activation penalty per
    source (ref `cost`); returns (assign (n_arv, 2), active (n_src,) bool).

    restrict: optional list of (qa, qb) source-index pairs of which at most
    one may be active (the reference's optional constraint 1,
    process_utils.py:970-986 — spatio-temporal separation of duplicates).
    Enforced exactly in the enumeration path (restrict-linked components
    are merged) and by partner-deactivation in the flip heuristic.

    Exact (memoized subset enumeration) for n_src ≤ exact_max_sources —
    which now matches the max_sources_per_component split bound, so every
    component the pipeline hands us is solved provably optimally, same as
    the reference ILP; otherwise single-flip descent + pair-flip escape on
    the effective objective.
    """
    n_arv, n_src, _ = weights.shape
    if n_arv == 0 or n_src == 0:
        return -np.ones((n_arv, 2), np.int64), np.zeros(n_src, bool)

    if force_n_sources is None and n_src <= exact_max_sources:
        res = _exact_enumeration(weights, ipick, cost, min_weight,
                                 restrict=restrict)
        if res is not None:
            return res
        # over the enumeration work budget: fall through to the heuristic

    best_obj, best_assign, best_act = _effective(
        weights, ipick, np.ones(n_src, bool), cost, min_weight)
    active = best_act.copy()
    improved = True
    while improved:
        improved = False
        order = np.argsort([weights[:, q, :].sum() for q in range(n_src)])
        for q in order:
            if force_n_sources is not None and active.sum() <= force_n_sources and active[q]:
                continue
            cand = active.copy()
            cand[q] = ~cand[q]
            if restrict and cand[q]:
                for qa, qb in restrict:  # keep feasibility: drop partners
                    if qa == q and cand[qb]:
                        cand[qb] = False
                    elif qb == q and cand[qa]:
                        cand[qa] = False
            obj, a, eff = _effective(weights, ipick, cand, cost, min_weight)
            if obj > best_obj + 1e-9:
                best_obj, best_assign, best_act = obj, a, eff
                active = cand
                improved = True
        if not improved and force_n_sources is None:
            # pair-flip escape (e.g. swap one active source for another)
            for q1 in range(n_src):
                for q2 in range(q1 + 1, n_src):
                    cand = active.copy()
                    cand[q1] = ~cand[q1]
                    cand[q2] = ~cand[q2]
                    obj, a, eff = _effective(weights, ipick, cand, cost,
                                             min_weight)
                    if obj > best_obj + 1e-9:
                        best_obj, best_assign, best_act = obj, a, eff
                        active = cand
                        improved = True
                        break
                if improved:
                    break
    return best_assign, best_act


def competitive_assignment_split(weights, ipick, cost):
    """Relaxed variant (per-(station,source,phase) capacity lifted, ref
    b2=1e5 :1045-1209): each arrival independently takes its best positive
    (source, phase); used to split picks between source clusters."""
    n_arv, n_src, _ = weights.shape
    assign = -np.ones((n_arv, 2), np.int64)
    if n_arv == 0:
        return assign, np.zeros(n_src, bool)
    flat = weights.reshape(n_arv, -1)
    best = flat.argmax(axis=1)
    val = flat[np.arange(n_arv), best]
    ok = val > 0
    assign[ok, 0] = best[ok] // 2
    assign[ok, 1] = best[ok] % 2
    active = np.zeros(n_src, bool)
    active[np.unique(assign[ok, 0])] = True
    return assign, active


def maximize_bipartite_assignment(srcs_a, srcs_b, sig_x=15e3, sig_t=5.0,
                                  min_weight=0.01):
    """Optimal 1-1 matching of two catalogs on Gaussian space-time affinity —
    the reference's evaluation-metric machinery (process_utils.py:1463-1540).

    srcs_*: (n, 4) arrays of (x, y, z, t) in Cartesian metres/seconds.
    Returns (idx_a, idx_b) matched index arrays.
    """
    if len(srcs_a) == 0 or len(srcs_b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d2 = ((srcs_a[:, None, :3] - srcs_b[None, :, :3]) ** 2).sum(-1) / sig_x**2
    dt2 = (srcs_a[:, None, 3] - srcs_b[None, :, 3]) ** 2 / sig_t**2
    w = np.exp(-0.5 * d2) * np.exp(-0.5 * dt2)
    w = np.where(w > min_weight, w, 0.0)
    rows, cols = linear_sum_assignment(-w)
    keep = w[rows, cols] > 0
    return rows[keep], cols[keep]
