"""The check's control on the card: the program with TF32 matrix products
comes out not correct at the cell's own size, on three seeds, where the
program in float32 comes out correct. Marked ``cuda``; skips without a card.
Run on the card: ``python -m pytest benchmark/tests -m cuda``."""

import argparse

import pytest
import torch


def _run(workload, seed, precision):
    from benchmark import run

    args = argparse.Namespace(workload=workload, seed=seed, seconds=5.0, trace=0,
                              precision=precision)
    res = run.run_cell(args)
    print(f"control {workload} seed {seed} {precision}: correct {res['correct']}, "
          + ", ".join(f"{k} {v['value']!r}" for k, v in res["checked"].items()))
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["nc_run6.day_background", "nc_run6.swarm",
                                      "nc_run6_updated.sweep", "nc_run6.train"])
def test_tf32_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        assert _run(workload, seed, "tf32")["correct"] is False
    assert _run(workload, 2**31 + 104, "f32")["correct"] is True
