"""Device ms inside the benchmark's ``trv`` range around the pipeline's travel-time callable, per hour of picks."""

from benchmark.harness import readings


def read(run):
    return readings.range_device_ms_per_h(run, "trv")
