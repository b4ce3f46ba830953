"""Seconds from the process's start to the window's: CUDA start-up, the
kernels' build or load, the weights, and the traffic's pre-roll or fill,
which warms every shape the window uses."""


def read(run):
    return run.setup_s
