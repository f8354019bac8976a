"""Every tenant's completed rounds over the wall seconds of the window."""


def read(run):
    return run.tenant_rounds / run.window_s
