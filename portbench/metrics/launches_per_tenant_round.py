"""Kernel launches in the window (kernels/build.LAUNCHES) a tenant-round."""
from portbench.readers import launches_per


def read(run):
    return launches_per(run, run.tenant_rounds)
