"""One torch thread for the port's test modules.

Under pytest-xdist every worker's torch would start one intra-op thread
per CPU, so several workers' threads mostly spin against each other (a
port test file alone takes ~27% less CPU at one thread, and the suite's
wall under ``-n 6`` drops by a third).  A port test module imports
``one_torch_thread`` (an autouse fixture): its tests run torch on one
thread, and the worker's thread count is restored after the module.
Rank processes of ``tests/torch_dist.py`` run at one thread too.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
