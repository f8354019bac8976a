"""Seconds from the process start to the window: torch and the CUDA
context, the kernels from the build cache, the inputs, the warm-up at the
cell's shapes, and the timed call's key generation, init and share."""


def read(run):
    return run.setup_s
