"""Seconds from the process's start to its first timed frame or step:
imports, the weights, loading (and on a first run building) the kernels,
and warming the cell's shapes."""


def read(run):
    return run.setup_s
