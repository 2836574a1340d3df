"""Share of the program's ``pipeline.locate`` spans' time in which no kernel runs, through ``process``."""

from benchmark.harness import spans


def read(run):
    return spans.idle_pct_in(run, "pipeline.locate", "locate")
