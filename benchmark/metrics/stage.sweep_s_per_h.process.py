"""Host seconds of the detection sweep (``stage_seconds['sweep']``) per hour of picks."""

from benchmark.harness import readings


def read(run):
    return readings.stage_s_per_h(run, ("sweep",))
