"""The sweep's fused-round launches: least time over device time, through ``detection_sweep``."""

from benchmark.harness import readings


def read(run):
    return readings.round_roofline(run)
