"""The training step's detector FLOPs (forward at training shapes, backward twice the forward) over its wall time, share of the f32 peak."""

from benchmark.harness import readings


def read(run):
    return readings.train_mfu(run)
