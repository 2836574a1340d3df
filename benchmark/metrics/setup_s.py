"""Set-up: process start to the first timed request, compilation included (s)."""


def read(run):
    return run.setup_s
