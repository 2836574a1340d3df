"""The sweep's fused-round launches: least time over device time, through ``process``."""

from benchmark.harness import readings


def read(run):
    return readings.round_roofline(run)
