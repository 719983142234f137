"""Seconds from the process's start to the window: start-up, the data,
the kernels' build (in a checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
