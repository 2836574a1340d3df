"""Faults planted under the timed path make ``correct`` come out false.

Each case drives a whole run on the CPU at a small size, skipping only the
look for a card, with one fault planted in the program's pipeline below
the benchmark's wrappers: half of the grids left out of the sweep's
ensemble mean; half of the clustered candidates left out; refinement
returning its candidates unchanged; the association weights altered; half
of the associated events left out; the located events moved 2 km; the
magnitudes altered; and, in the training cell, each fault of
``train_faults``. A run with nothing planted is correct
(``test_bench_reference``).
"""

import numpy as np
import pytest

from benchmark.tests.cpu_cell import run_small, run_small_train
from benchmark.tests.train_faults import FAULTS


def half_the_grids(pipe):
    sweep = pipe.detection_sweep

    def detection_sweep(*a, **k):
        return sweep(*a, **{**k, "grids": list(range(pipe.n_grids // 2))})
    pipe.detection_sweep = detection_sweep


def half_the_candidates(pipe):
    cluster = pipe.cluster_candidates

    def cluster_candidates(*a, **k):
        srcs, vals = cluster(*a, **k)
        return srcs[:len(srcs) // 2], vals[:len(vals) // 2]
    pipe.cluster_candidates = cluster_candidates


def half_the_events(pipe):
    associate = pipe.associate_per_source

    def associate_per_source(*a, **k):
        events = associate(*a, **k)
        return events[:len(events) // 2]
    pipe.associate_per_source = associate_per_source


def refine_unchanged(pipe):
    def refine_sources(pick_t, pick_sta, pick_phase, srcs, vals, *a, **k):
        return srcs, vals
    pipe.refine_sources = refine_sources


def weights_altered(pipe):
    window = pipe._assoc_window

    def assoc_window(*a, **k):
        p, s = window(*a, **k)
        return 0.9 * p, s
    pipe._assoc_window = assoc_window


def location_moved(pipe):
    locate = pipe.locate

    def moved(*a, **k):
        out = locate(*a, **k)
        for ev in out:
            ev.pos_cart = ev.pos_cart + np.float32(2000.0)
        return out
    pipe.locate = moved


def magnitude_altered(pipe):
    mags = pipe.assign_magnitudes

    def altered(*a, **k):
        out = mags(*a, **k)
        for ev in out:
            ev.mag = ev.mag + 0.1
        return out
    pipe.assign_magnitudes = altered


@pytest.mark.parametrize("fault,number", [
    (half_the_grids, "sweep_gap"), (half_the_candidates, "cand_gap"),
    (refine_unchanged, "refine_gap"), (weights_altered, "assoc_gap"),
    (half_the_events, "assign_gap"), (location_moved, "locate_cost_gap_s"),
    (magnitude_altered, "mag_gap")])
def test_fault_is_not_correct(fault, number):
    res = run_small("nc_run6.swarm", plant=fault)
    assert res["correct"] is False
    got = res["checked"][number]
    assert not got["value"] <= got["limit"], res["checked"]


def test_sweep_fault_in_the_updated_definition():
    res = run_small("nc_run6_updated.sweep", plant=half_the_grids)
    assert res["correct"] is False


@pytest.mark.parametrize("fault,number", [
    ("optimizer_skipped", "update_gap"), ("half_the_batch", "loss_gap"),
    ("one_backward_skipped", "grad_gap"), ("half_the_picks", "batch_gap"),
    ("events_dropped", "batch_gap")])
def test_training_fault_is_not_correct(fault, number):
    res = run_small_train(plant=FAULTS[fault])
    assert res["correct"] is False
    got = res["checked"][number]
    assert not got["value"] <= got["limit"], res["checked"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault,number", [
    ("optimizer_skipped", "update_gap"), ("half_the_batch", "loss_gap"),
    ("one_backward_skipped", "grad_gap"), ("half_the_picks", "batch_gap"),
    ("events_dropped", "batch_gap")])
def test_training_fault_on_the_card(fault, number):
    """Each training fault at the cell's own size, on three seeds."""
    import argparse

    import torch

    from benchmark import run

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        args = argparse.Namespace(workload="nc_run6.train", seed=seed, seconds=2.0,
                                  trace=0, precision="f32")
        res = run.run_cell(args, plant=FAULTS[fault])
        print(f"fault {fault} seed {seed}: correct {res['correct']}, "
              + ", ".join(f"{k} {v['value']!r}" for k, v in res["checked"].items()))
        got = res["checked"][number]
        assert res["correct"] is False and not got["value"] <= got["limit"]
