"""Share of the traced window in which no kernel runs, through ``process``."""

from benchmark.harness import readings


def read(run):
    return readings.idle_pct(run)
