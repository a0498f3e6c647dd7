"""Seconds from the process's start to the window's start: imports,
building or loading the kernels, making the weights and the traffic, the
warm-up aggregation and the first rounds."""


def read(run):
    return run.setup_s
