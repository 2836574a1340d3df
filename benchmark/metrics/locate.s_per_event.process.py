"""Host seconds of the program's ``pipeline.locate`` spans per event entering location (its ``locate.events`` counter), through ``process``."""

from benchmark.harness import spans


def read(run):
    return spans.seconds_per(run, "pipeline.locate", "locate.events")
