"""95th percentile of every tenant's wall lap a round in the window
(each tenant's own phase clock, device synchronized at each lap)."""
from portbench.readers import percentile


def read(run):
    return percentile(run.laps, 95)
