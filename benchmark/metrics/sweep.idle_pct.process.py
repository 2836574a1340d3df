"""Share of the program's ``pipeline.sweep`` spans' time in which no kernel runs, through ``process``."""

from benchmark.harness import spans


def read(run):
    return spans.idle_pct_in(run, "pipeline.sweep", "sweep")
