"""Seconds from the process's start to the first timed search: imports,
CUDA's start, the kernel build or its cache, the data made from the seed,
and the warm-up of every request shape the traffic sends."""


def read(run):
    return run.setup_s
