"""One torch compute thread for each module of the port's CPU tests.

The suite runs as 6 xdist workers on 8 cores, and torch's OpenMP pool
otherwise takes every core in each worker: a worker's torch work then
holds up the other workers' single-threaded work.  Each port test
module imports `one_torch_thread` by name.  It restores the count when
the module ends, so the JAX package's tests that the same worker runs
next are as they were."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
