"""Seconds from the process's start to the first timed call: the kernels'
build or load, the data, the index build and the warm-up."""


def read(run):
    return run.setup_s
