"""Wall seconds a round of one job: the iterate phase (each round's lap
synchronizes the device) over its rounds."""


def read(run):
    if run.tenants != 1:
        return None
    return run.window_s / run.rounds
