"""Least time of the window's modexp_fixed launches over their device time."""
from portbench.readers import roofline


def read(run):
    return roofline(run, ("modexp_fixed",))
