"""One PyTorch intra-op thread for the port's CPU tests.

pytest-xdist runs several test processes on the machine's cores, and each
PyTorch process starts one intra-op thread per core: at the tiny shapes of
these tests the threads only spin against each other's (a chain of CLIs
that takes 4 s alone took 79 s beside five other workers, and 22 s with
one thread).  A test module imports the fixture below, which holds
PyTorch to one thread for the module and restores the count after it.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
