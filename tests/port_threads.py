"""One torch thread while a port test module runs.

The tier-1 run puts six pytest workers on the machine's cores. PyTorch's
CPU ops run on an OpenMP pool of one thread per core in every worker, and
the pool's threads spin while they wait, so six pools on one machine slow
the port's small tensor ops a hundredfold and take cores from the JAX
tests beside them. The port's CPU tests are small: one thread each is what
they need. Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`,
an autouse module fixture, which restores the count when the module ends.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
