"""Optimizer steps completed per second of wall time through the program's ``make_train_step``."""

from benchmark.harness import readings


def read(run):
    return readings.steps_per_s(run)
