"""Plain candidates and association decisions, for the checks.

Frozen copies, in NumPy and SciPy, of what ``InferencePipeline`` decides on
the host between its device stages: the peaks of each query node's sweep
series above a threshold with a minimum spacing, the split of candidates
into groups at time gaps, the connected components of the source-pick
weight graph, the spectral split of an oversized component, and the
competitive assignment of picks to sources (for a fixed active set, an
optimal matching per station; the active set by subset enumeration over
each group of sources that share a station, or by single- and pair-flip
descent where that is too much work).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def find_peaks_1d(x, thresh: float, min_spacing: int = 1):
    """Local maxima above ``thresh``; where two lie within ``min_spacing``
    bins, the higher one is kept."""
    x = np.asarray(x)
    n = len(x)
    if n < 3:
        return np.zeros(0, np.int64)
    is_peak = (x[1:-1] >= x[:-2]) & (x[1:-1] > x[2:]) & (x[1:-1] > thresh)
    idx = np.where(is_peak)[0] + 1
    if min_spacing > 1 and len(idx) > 1:
        keep = []
        taken = np.zeros(n, bool)
        for i in idx[np.argsort(-x[idx])]:
            if not taken[max(0, i - min_spacing):i + min_spacing + 1].any():
                keep.append(i)
                taken[i] = True
        idx = np.array(sorted(keep), np.int64)
    return idx


def split_time_groups(times, break_win: float):
    """Index groups of ``times``, split where sorted times leave a gap of
    ``break_win`` or more; each group in index order."""
    times = np.asarray(times)
    if len(times) == 0:
        return []
    order = np.argsort(times)
    breaks = np.where(np.diff(times[order]) >= break_win)[0]
    return [np.sort(g) for g in np.split(order, breaks + 1)]


def connected_components(n: int, edges) -> np.ndarray:
    """Labels 0.. of the components of ``n`` nodes, numbered in the order
    of each component's smallest root index."""
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = np.array([find(i) for i in range(n)])
    return np.unique(roots, return_inverse=True)[1]


def _station_assignment(weights, active):
    """Optimal assignment of one station's arrivals (rows of ``weights``,
    (n_arv, n_src, 2)) to (active source, phase) slots, each slot at most
    once: (total, assign (n_arv, 2) of (source, phase) or (-1, -1))."""
    n_arv = weights.shape[0]
    assign = -np.ones((n_arv, 2), np.int64)
    act = np.where(active)[0]
    if len(act) == 0:
        return 0.0, assign
    w = weights[:, act, :].reshape(n_arv, len(act) * 2)
    w = np.where(w > 0.0, w, 0.0)
    total = 0.0
    for r, c in zip(*linear_sum_assignment(-w)):
        if w[r, c] > 0.0:
            assign[r] = (act[c // 2], c % 2)
            total += w[r, c]
    return total, assign


def _solve(weights, ipick, active):
    assign = -np.ones((weights.shape[0], 2), np.int64)
    total = 0.0
    for s in np.unique(ipick):
        rows = np.where(ipick == s)[0]
        t, a = _station_assignment(weights[rows], active)
        total += t
        assign[rows] = a
    return total, assign


def _effective(weights, ipick, active, cost):
    """The objective with active sources that receive no pick left out."""
    t, a = _solve(weights, ipick, active)
    used = np.zeros(len(active), bool)
    hit = a[:, 0] >= 0
    used[a[hit, 0]] = True
    eff = active & used
    return t - cost * eff.sum(), a, eff


def _enumerate(weights, ipick, cost, work_budget: float = 2e6):
    """The optimal active set by enumerating the subsets of each group of
    sources linked through a station; ``None`` where the estimated work is
    over ``work_budget``."""
    n_arv, n_src, _ = weights.shape
    cand = np.where((weights > 0.0).any(axis=(0, 2)))[0]
    k = len(cand)
    assign_out = -np.ones((n_arv, 2), np.int64)
    act_out = np.zeros(n_src, bool)
    if k == 0:
        return assign_out, act_out
    slot = {q: i for i, q in enumerate(cand)}
    rows_of, rel_of = [], []
    for s in np.unique(ipick):
        rows = np.where(ipick == s)[0]
        rel = 0
        for i, q in enumerate(cand):
            if (weights[rows, q, :] > 0.0).any():
                rel |= 1 << i
        rows_of.append(rows)
        rel_of.append(rel)
    parent = list(range(k))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for rel in rel_of:
        ids = [i for i in range(k) if rel >> i & 1]
        for i in ids[1:]:
            parent[find(i)] = find(ids[0])
    groups = {}
    for i in range(k):
        groups[find(i)] = groups.get(find(i), 0) | (1 << i)
    est = 0.0
    for gm in groups.values():
        kg = bin(gm).count("1")
        rels = [rel for rel in rel_of if rel & gm]
        est += (1 << kg) * len(rels)
        est += 100.0 * sum(1 << min(bin(rel & gm).count("1"), kg) for rel in rels)
    if est > work_budget:
        return None
    for gm in groups.values():
        stations = [j for j, rel in enumerate(rel_of) if rel & gm]
        bits_of = [i for i in range(k) if gm >> i & 1]
        memo = [dict() for _ in stations]

        def at_station(j, sub):
            hit = memo[j].get(sub)
            if hit is None:
                act = np.zeros(n_src, bool)
                for i in bits_of:
                    if sub >> i & 1:
                        act[cand[i]] = True
                t, a = _station_assignment(weights[rows_of[stations[j]]], act)
                used = 0
                for q in a[a[:, 0] >= 0, 0]:
                    used |= 1 << slot[int(q)]
                hit = memo[j][sub] = (t, a, used)
            return hit

        best, best_parts, best_used = 0.0, None, 0
        for local in range(1, 1 << len(bits_of)):
            bits = 0
            for j, i in enumerate(bits_of):
                if local >> j & 1:
                    bits |= 1 << i
            total, used_all, parts = 0.0, 0, []
            for j in range(len(stations)):
                t, a, used = at_station(j, bits & rel_of[stations[j]])
                total += t
                used_all |= used
                parts.append(a)
            obj = total - cost * bin(used_all).count("1")
            if obj > best + 1e-12:
                best, best_parts, best_used = obj, parts, used_all
        if best_parts is not None:
            for j, a in enumerate(best_parts):
                rows = rows_of[stations[j]]
                hit = a[:, 0] >= 0
                assign_out[rows[hit]] = a[hit]
            for i in range(k):
                if best_used >> i & 1:
                    act_out[cand[i]] = True
    return assign_out, act_out


def competitive_assignment(weights, ipick, cost: float, exact_max_sources: int = 15):
    """Picks (``weights`` (n_arv, n_src, 2), stations ``ipick``) to sources:
    maximise the assigned weight less ``cost`` per source used, each
    (station, source, phase) taking one arrival at most. Returns (assign
    (n_arv, 2) of (source, phase) or (-1, -1), active (n_src,))."""
    n_arv, n_src, _ = weights.shape
    if n_arv == 0 or n_src == 0:
        return -np.ones((n_arv, 2), np.int64), np.zeros(n_src, bool)
    if n_src <= exact_max_sources:
        res = _enumerate(weights, ipick, cost)
        if res is not None:
            return res
    best, best_assign, best_act = _effective(weights, ipick, np.ones(n_src, bool), cost)
    active = best_act.copy()
    improved = True
    while improved:
        improved = False
        for q in np.argsort([weights[:, q, :].sum() for q in range(n_src)]):
            trial = active.copy()
            trial[q] = ~trial[q]
            obj, a, eff = _effective(weights, ipick, trial, cost)
            if obj > best + 1e-9:
                best, best_assign, best_act = obj, a, eff
                active = trial
                improved = True
        if not improved:
            for q1 in range(n_src):
                for q2 in range(q1 + 1, n_src):
                    trial = active.copy()
                    trial[q1] = ~trial[q1]
                    trial[q2] = ~trial[q2]
                    obj, a, eff = _effective(weights, ipick, trial, cost)
                    if obj > best + 1e-9:
                        best, best_assign, best_act = obj, a, eff
                        active = trial
                        improved = True
                        break
                if improved:
                    break
    return best_assign, best_act


def _best_slot(weights):
    """Each arrival to its best positive (source, phase), capacities lifted."""
    n_arv = weights.shape[0]
    assign = -np.ones((n_arv, 2), np.int64)
    if n_arv == 0:
        return assign
    flat = weights.reshape(n_arv, -1)
    best = flat.argmax(axis=1)
    ok = flat[np.arange(n_arv), best] > 0
    assign[ok, 0] = best[ok] // 2
    assign[ok, 1] = best[ok] % 2
    return assign


def _bisect(affinity):
    """Two halves of a dense affinity matrix by the normalised Laplacian's
    second eigenvector, split at its median."""
    a = np.asarray(affinity, float)
    n = len(a)
    if n <= 1:
        return np.zeros(n, int)
    d = 1.0 / np.sqrt(np.maximum(a.sum(axis=1), 1e-12))
    fiedler = np.linalg.eigh(np.eye(n) - d[:, None] * a * d[None, :])[1][:, 1]
    labels = (fiedler > np.median(fiedler)).astype(int)
    if labels.sum() in (0, n):
        labels[np.argsort(fiedler)[:n // 2]] = 0
        labels[np.argsort(fiedler)[n // 2:]] = 1
    return labels


def split_component(weights, ipick, src_pos, src_time, max_sources: int,
                    sig_x: float = 15e3, sig_t: float = 10.0, max_splits: int = 30):
    """Halve a (sources × picks × 2) block until each part has at most
    ``max_sources`` sources (or ``max_splits`` cuts were made); each pick
    goes with its best source. Returns [(source indices, pick indices)]."""
    parts = [(np.arange(weights.shape[0]), np.arange(weights.shape[1]))]
    out, splits = [], 0
    while parts:
        qs, ps = parts.pop()
        if len(qs) <= max_sources or splits >= max_splits:
            out.append((qs, ps))
            continue
        splits += 1
        w = weights[np.ix_(qs, ps)].sum(-1)
        shared = w @ w.T
        d2 = ((src_pos[qs][:, None] - src_pos[qs][None]) ** 2).sum(-1) / sig_x ** 2
        dt2 = (src_time[qs][:, None] - src_time[qs][None]) ** 2 / sig_t ** 2
        labels = _bisect(shared / max(shared.max(), 1e-9) + np.exp(-0.5 * (d2 + dt2)))
        assign = _best_slot(weights[np.ix_(qs, ps)].transpose(1, 0, 2))
        side = np.full(len(ps), -1)
        ok = assign[:, 0] >= 0
        side[ok] = labels[assign[ok, 0]]
        for s in (0, 1):
            if (labels == s).any():
                parts.append((qs[labels == s], ps[side == s]))
    return out


def assign_events(W, ip_pick, src_pos, src_time, cost: float, max_sources: int,
                  max_splits: int):
    """The association's events from the source-pick weights ``W`` (n_src,
    n_pick, 2): the weight graph's components, oversized ones split, each
    part assigned competitively. Returns [(source, pick columns, phases)]."""
    n_src, n_pick = W.shape[:2]
    has_w = W.sum(-1) > 0
    edges = [(q, n_src + p) for q in range(n_src) for p in np.where(has_w[q])[0]]
    labels = connected_components(n_src + n_pick, edges)
    out = []
    for lab in np.unique(labels[:n_src]):
        qs = np.where(labels[:n_src] == lab)[0]
        ps = np.where(labels[n_src:] == lab)[0]
        if len(ps) == 0:
            continue
        if len(qs) > max_sources:
            parts = split_component(W[np.ix_(qs, ps)], ip_pick[ps], src_pos[qs],
                                    src_time[qs], max_sources, max_splits=max_splits)
            parts = [(qs[a], ps[b]) for a, b in parts]
        else:
            parts = [(qs, ps)]
        for q_p, p_p in parts:
            if len(p_p) == 0 or len(q_p) == 0:
                continue
            assign, _ = competitive_assignment(W[np.ix_(q_p, p_p)].transpose(1, 0, 2),
                                               ip_pick[p_p], cost)
            for qi, q in enumerate(q_p):
                rows = np.where(assign[:, 0] == qi)[0]
                if len(rows):
                    out.append((q, p_p[rows], assign[rows, 1].copy()))
    return out
