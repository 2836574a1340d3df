"""The operation and byte counters against hand counts."""

import pytest

from benchmark.harness import counts


def test_round_bound_hand_count():
    # 2 rows x 3 stations, cx = cz = 2, m = 1, h = 2, k = 2, z read apart, e = 0
    nbytes, flops, secs = counts.round_bound(2, 3, 2, 2, 1, 2, 2, False)
    d = 2 + 2 + 0 + 1
    elems_in = 2 * 3 * (2 + 2 + 2 + 1)          # x, z, agg_src, mask
    elems_out = 2 * 3 * 2 * 2                   # [h1 | h2]
    small = 3 * 2 * 2 + 2 * d * 2 + 2 * 2 + 2   # table, weights, biases, slopes
    assert nbytes == 4 * (elems_in + elems_out + small)
    assert flops == 2 * 3 * (2 * 2 * 2 + 2 * 2 * 2 * d)
    assert secs == max(nbytes / 3.35e12, flops / 67e12)


@pytest.mark.parametrize("form,want_ms", [
    ((30, 30, 4, 30, True), 0.443), ((60, 30, 4, 15, False), 0.550),
    ((30, 30, 5, 30, False), 0.554)])
def test_round_bound_at_run6_width(form, want_ms):
    cx, cz, m, h, z_is_x = form
    _, _, secs = counts.round_bound(8000, 374, cx, cz, m, h, 8, z_is_x)
    assert round(secs * 1e3, 3) == want_ms


def test_sweep_rounds_batches():
    launches = counts.sweep_rounds(33, 16, 5, 500, 374, 8, 0)
    assert len(launches) == 3 * 5 * 2
    assert [r[0] for r in launches[::10]] == [8000, 8000, 500]


def test_detection_flops_hand_count():
    # one source, one station, one query, one time offset, k = 1 everywhere
    f = counts.detection_forward_flops(1, 1, 1, 1, 1, 1, 1, False, 0)
    lin = 2 * (8 * 30)                                   # init_trns
    lin += 2 * 30 + (2 * 30 + 4 * 30 * 64)               # round 1: src mean, round
    lin += 2 * 2 * 60 * 30 + 2 * 30                      # round 2 linears, src mean
    lin += 2 * 30 + 4 * 15 * 94                          # round 2
    lin += 2 * 33 * 30 + 2 * 30 + 2 * 30 * 15            # read-in
    for c in (15, 30, 30):                               # spatial layers
        lin += 2 * c * 5 + 2 * (c + 8) * 30 + 2 * 30 + 2 * (c + 30) * 30
    lin += 2 * 30 * 30                                   # spatial direct
    temporal = (2 * 2 * 30 * 30 + 2 * 2 * 30 * 75 + 2 * 30 + 2 * 30 * 75
                + 2 * 75 * 2 + 2 * 15 * 30 + 2 * 30)
    attn = 2 * 3 * 75 + 2 * 2 * 33 * 75 + 2 * 75 * 2 + 2 * 15 * 30
    assert f == lin + 2 * temporal + attn


def test_non_empty_windows():
    # picks at 0 s and 100 s; windows every 5 s over [0, 200), t_win 10, max_t 20
    n = counts.non_empty_windows([0.0, 100.0], 0.0, 200.0, 10.0, 2.0, 20.0)
    # a window at t0 holds a pick p when t0 - 10 < p < t0 + 40
    want = sum(any(t0 - 10 < p < t0 + 40 for p in (0.0, 100.0))
               for t0 in range(0, 200, 5))
    assert n == want


def test_association_flops_hand_count():
    # every size 1, so each (query source, pick) has one co-station slot and the null
    f = counts.association_forward_flops(1, 1, 1, 1, 1, 1, 1, 1, 1, False, 0)
    want = 2 * 3 * 75 + 2 * 2 * 33 * 75 + 2 * 75 * 2 + 2 * 15 * 30    # query attention
    want += 2 * 33 * 30 + 2 * 30 * 15                                 # read-out
    want += 2 * 50 * 30                                               # trunk input
    want += 2 * 2 * 30 * 30 + 2 * 30 + 2 * 30 + 4 * 30 * 65           # round 1
    want += 2 * 2 * 60 * 30 + 2 * 30 + 2 * 30 + 4 * 15 * 95           # round 2
    want += 2 * (2 * 32 * 30 + 2 * 30 * 15)                           # P and S slices
    n = 2
    want += n * 2 * (36 * 30 + 30 * 45 + 33 * 30 + 30 * 45 + 38 * 30 + 30 * 45)
    want += 2 * n * 45 * 2 + 2 * 15 * 30 + 2 * 30 * 2                 # attention, projection
    assert f == want


def test_train_step_flops_is_three_forwards_a_window():
    g = {"k_sta_edges": 8, "k_spc_edges": 15, "k_time_edges": 10, "k_pick_pairs": 16,
         "k_spatial_attn": 10}
    fwd = (counts.detection_forward_flops(500, 374, 2000, 9, 8, 15, 10, False, 0)
           + counts.association_forward_flops(500, 374, 96, 512, 8, 15, 10, 16, 10, False, 0))
    assert counts.train_step_flops(8, 500, 374, 2000, 96, 512, g, False, 0) == 3 * 8 * fwd
    assert round(counts.train_step_flops(8, 500, 374, 2000, 96, 512, g, False, 0) / 1e9) == 568
