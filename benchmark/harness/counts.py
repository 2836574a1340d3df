"""Operations and bytes of the work the benchmark drives, from shapes.

The peaks are NVIDIA's published H100 SXM rates: 3.35 TB/s of HBM and
67 TFLOP/s of float32 outside the tensor cores (the port runs float32 with
TF32 off), both at the card's full 700 W.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def round_bound(rows, n_sta, cx, cz, m, h, k, z_is_x, e=0, n_src=0):
    """Least bytes, operations and time (s) of one fused dual-relation
    round: each input read once and the output written once, every slot of
    the station table valid; the edge form (e = 4) reads its (n_sta, e) and
    (n_src, e) tables once. Returns (bytes, flops, seconds)."""
    d = cx + cz + e + m
    elems_in = rows * n_sta * (cx + (0 if z_is_x else cz) + cz + m)
    elems_out = rows * n_sta * 2 * h
    small = n_sta * k * 2 + 2 * d * h + 2 * h + 2 + (n_sta + n_src) * e
    nbytes = 4 * (elems_in + elems_out + small)
    flops = rows * n_sta * (2 * k * cz + 2 * 2 * h * d)
    return nbytes, flops, max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def sweep_rounds(n_windows: int, window_batch: int, n_grids: int, n_src: int,
                 n_sta: int, k_sta: int, e: int):
    """The (rows, cx, cz, m, h, z_is_x) launches of a detection sweep over
    ``n_windows`` non-empty windows: per batch of windows and per grid, the
    trunk's two rounds."""
    out = []
    for s in range(0, n_windows, window_batch):
        rows = min(window_batch, n_windows - s) * n_src
        for _ in range(n_grids):
            out.append((rows, 30, 30, 4, 30, True))
            out.append((rows, 60, 30, 4, 15, False))
    return out


def sweep_round_least_seconds(n_windows, window_batch, n_grids, n_src, n_sta,
                              k_sta, e) -> float:
    return sum(round_bound(rows, n_sta, cx, cz, m, h, k_sta, zx, e, n_src)[2]
               for rows, cx, cz, m, h, zx in sweep_rounds(
                   n_windows, window_batch, n_grids, n_src, n_sta, k_sta, e))


def _linear(n, fan_in, fan_out):
    return 2 * n * fan_in * fan_out


def detection_forward_flops(n_src: int, n_sta: int, n_q: int, n_t: int, k_sta: int,
                            k_spc: int, k_attn: int, use_abs: bool, e: int) -> int:
    """Model FLOPs (2 per multiply-add) of one window's
    ``forward_detection_only`` on one grid: every linear, every neighbour
    mean (k terms each, whatever implements it), the read-in's gated sum and
    the attention products, at the configuration's widths (hidden 30,
    latent 15, 5 heads; read-in 30 → 15; three spatial layers with 5 global
    channels; the grid and query temporal heads over ``n_t`` offsets)."""
    P = n_src * n_sta
    h, lat, heads = 30, 15, 5
    hl = heads * lat
    c_in = 4 + (6 if use_abs else 0)
    f = _linear(P, c_in + 4, h)                       # DataAggregation.init_trns
    f += 2 * k_spc * P * h                            # round 1 source mean
    f += P * (2 * k_sta * h + 2 * 2 * h * (h + h + e + 4))       # round 1
    f += 2 * _linear(P, 2 * h, h) + 2 * k_spc * P * h           # round 2 inputs
    f += P * (2 * k_sta * h + 2 * 2 * 15 * (2 * h + h + e + 4))  # round 2
    f += _linear(P, h + 3, h) + 2 * P * h + _linear(n_src, h, 15)   # read-in
    c = 15
    for _ in range(3):                                # spatial aggregation
        f += _linear(n_src * k_spc, c, 5)
        f += _linear(n_src * k_spc, c + 3 + 5, h) + 2 * n_src * k_spc * h
        f += _linear(n_src, c + h, h)
        c = h
    f += _linear(n_src, h, h)                         # spatial direct

    def temporal(n):
        g = 2 * _linear(n, h, h) + 2 * _linear(n, h, hl)   # context, values
        g += _linear(n_t, 1, h) + _linear(n_t, h, hl)      # time queries
        g += 2 * n * n_t * hl * 2                          # scores, weighting
        g += _linear(n * n_t, lat, h) + _linear(n * n_t, h, 1)
        return g

    f += temporal(n_src)                              # grid head
    nk = n_q * k_attn                                 # query spatial attention
    f += _linear(nk, 3, hl) + 2 * _linear(nk, h + 3, hl)
    f += 2 * nk * hl * 2 + _linear(n_q, lat, h)
    f += temporal(n_q)                                # query head
    return int(f)


def association_forward_flops(n_src: int, n_sta: int, n_qsrc: int, n_pick: int,
                              k_sta: int, k_spc: int, k_time: int, k_pair: int,
                              k_attn: int, use_abs: bool, e: int) -> int:
    """Model FLOPs of the association head of one window's full forward on
    one grid, beyond ``forward_detection_only``: the spatial attention to
    the ``n_qsrc`` query sources, the read-out onto the product, the
    association trunk's two rounds (5 mask channels, the trunk's 30-wide
    latent as input), the P and S slice collapses over ``k_time`` product
    nodes a pick, and the station-source attention over each pick's
    ``k_pair`` co-station picks and a null slot (3 heads of 15)."""
    P = n_src * n_sta
    h, lat = 30, 15
    hl_s, hl_a = 5 * lat, 3 * lat
    nk = n_qsrc * k_attn                               # query-source attention
    f = _linear(nk, 3, hl_s) + 2 * _linear(nk, h + 3, hl_s)
    f += 2 * nk * hl_s * 2 + _linear(n_qsrc, lat, h)
    f += _linear(P, h + 3, h) + _linear(P, h, lat)     # read-out
    f += _linear(P, lat + (6 if use_abs else 0) + h + 5, h)     # association trunk
    f += 2 * _linear(P, h, h) + 2 * k_spc * P * h
    f += P * (2 * k_sta * h + 2 * 2 * h * (h + h + e + 5))
    f += 2 * _linear(P, 2 * h, h) + 2 * k_spc * P * h
    f += P * (2 * k_sta * h + 2 * 2 * lat * (2 * h + h + e + 5))
    for _ in range(2):                                  # slice collapses
        f += _linear(n_pick * k_time, h + 2, h) + _linear(n_pick, h, lat)
    n = n_qsrc * n_pick * (k_pair + 1)                  # station-source attention
    f += _linear(n, 2 * lat + 6, h) + _linear(n, h, hl_a)
    f += _linear(n, h + 3, h) + _linear(n, h, hl_a)
    f += _linear(n, 2 * lat + 8, h) + _linear(n, h, hl_a)
    f += 2 * n * hl_a * 2
    f += _linear(n_qsrc * n_pick, lat, h) + _linear(n_qsrc * n_pick, h, 2)
    return int(f)


def train_step_flops(n_windows: int, n_src: int, n_sta: int, n_q: int, n_qsrc: int,
                     n_pick: int, graph: dict, use_abs: bool, e: int) -> int:
    """Model FLOPs of one training step: each window's full forward on its
    grid (detection over ``n_q`` query points and 9 time offsets, and the
    association head), and the backward counted as twice the forward."""
    fwd = detection_forward_flops(n_src, n_sta, n_q, 9, graph["k_sta_edges"],
                                  graph["k_spc_edges"], graph["k_spatial_attn"],
                                  use_abs, e)
    fwd += association_forward_flops(n_src, n_sta, n_qsrc, n_pick, graph["k_sta_edges"],
                                     graph["k_spc_edges"], graph["k_time_edges"],
                                     graph["k_pick_pairs"], graph["k_spatial_attn"],
                                     use_abs, e)
    return 3 * n_windows * fwd


def non_empty_windows(pick_t, t_start, t_end, t_win, step_size, max_t) -> int:
    """Sweep windows that hold a pick (the sweep skips the others)."""
    t0s = np.arange(t_start, t_end, t_win / step_size)
    ts = np.sort(np.asarray(pick_t, np.float64))
    lo = np.searchsorted(ts, t0s - 10.0, side="right")
    hi = np.searchsorted(ts, t0s + t_win + max_t + 10.0, side="left")
    return int((hi > lo).sum())
