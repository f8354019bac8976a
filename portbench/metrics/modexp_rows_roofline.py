"""Least time of the window's modexp_rows launches over their device time."""
from portbench.readers import roofline


def read(run):
    return roofline(run, ("modexp_rows",))
