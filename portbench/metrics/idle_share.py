"""Share of the traced window in which no operation ran on the device."""
from portbench.readers import idle_share


def read(run):
    return idle_share(run)
