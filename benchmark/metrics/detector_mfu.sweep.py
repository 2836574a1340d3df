"""The sweep's detector FLOPs over its wall time, share of the f32 peak, through ``detection_sweep``."""

from benchmark.harness import readings


def read(run):
    return readings.detector_mfu(run)
