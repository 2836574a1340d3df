"""Host seconds of a training step's batch generation (``train_step.stage_seconds['generate']``) per step."""

from benchmark.harness import readings


def read(run):
    return readings.stage_s_per_request(run, "generate")
