"""Kernel launches in the window (kernels/build.LAUNCHES) a round."""
from portbench.readers import launches_per


def read(run):
    return launches_per(run, run.rounds)
