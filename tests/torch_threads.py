"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers at once, and each torch
process would start one intra-op thread per core: their OpenMP threads
spin against one another and against the other workers.  On an 8-core
machine with 6 workers, tests/test_torch_quant_tiles.py took 203 s of wall
time with torch's default threads and 36 s with one.  Every port test
module that computes on the CPU imports ``one_torch_thread``; the autouse
fixture sets one thread for that module's tests and restores the count
after them."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
