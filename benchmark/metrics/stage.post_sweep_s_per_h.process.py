"""Host seconds of the stages after the sweep (candidates, refine, associate, locate, magnitudes) per hour of picks."""

from benchmark.harness import readings


def read(run):
    return readings.stage_s_per_h(run, readings.POST_SWEEP)
