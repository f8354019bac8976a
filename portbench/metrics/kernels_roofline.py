"""Least time of the window's hand-written kernel launches (portbench/counts)
over their device time in the trace, in percent."""
from portbench.readers import roofline


def read(run):
    return roofline(run)
