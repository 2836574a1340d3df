"""Seconds of picks processed per second of wall time through ``InferencePipeline.process``."""

from benchmark.harness import readings


def read(run):
    return readings.rate(run)
