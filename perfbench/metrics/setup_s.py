"""Seconds from the process's start to the first timed call: imports,
inputs, weights, the program's build, kernel libraries and warm-up."""


def read(run):
    return run.setup_s
