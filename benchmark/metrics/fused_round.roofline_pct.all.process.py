"""Every fused-round launch the program recorded (sweep, refinement, association): least time over device time, through ``process``."""

from benchmark.harness import spans


def read(run):
    return spans.round_roofline_all(run)
