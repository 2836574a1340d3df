"""Share of the traced window in which no kernel runs, through ``detection_sweep``."""

from benchmark.harness import readings


def read(run):
    return readings.idle_pct(run)
