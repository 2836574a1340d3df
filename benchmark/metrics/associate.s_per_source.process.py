"""Host seconds of the program's ``pipeline.associate`` spans per source queried (its ``associate.sources`` counter), through ``process``."""

from benchmark.harness import spans


def read(run):
    return spans.seconds_per(run, "pipeline.associate", "associate.sources")
