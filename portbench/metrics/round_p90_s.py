"""90th percentile of the wall laps of the window's rounds."""
from portbench.readers import percentile


def read(run):
    return percentile(run.laps, 90)
