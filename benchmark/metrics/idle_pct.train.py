"""Share of the traced window in which no kernel runs, through ``make_train_step``."""

from benchmark.harness import readings


def read(run):
    return readings.idle_pct(run)
