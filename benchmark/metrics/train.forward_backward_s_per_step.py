"""Host seconds of a training step's forward and backward over its windows (``train_step.stage_seconds['forward_backward']``) per step."""

from benchmark.harness import readings


def read(run):
    return readings.stage_s_per_request(run, "forward_backward")
