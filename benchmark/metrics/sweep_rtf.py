"""Seconds of picks swept per second of wall time through ``InferencePipeline.detection_sweep``."""

from benchmark.harness import readings


def read(run):
    return readings.rate(run)
