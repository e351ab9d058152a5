"""A module fixture for the port's CPU tests: one torch CPU thread.

The test run shares the machine's cores among its xdist workers, each of
which would start a torch thread pool as wide as the machine. With the cores
oversubscribed, the pools' waiting threads make the port's many small
elementwise ops tens of times slower (a tiled 16x16 render on an 8-core
machine beside seven busy processes: 1.0 s on one thread, 43-53 s on the
default pool). Results
do not depend on it: each test compares values computed under the same
setting, or holds them to a tolerance.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
