"""The benchmark's CPU tests run the port's plain kernel versions on one
intra-op thread each: under pytest-xdist's parallel workers, more
threads only contend."""
import pytest


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
