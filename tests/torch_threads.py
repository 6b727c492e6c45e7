"""One torch intra-op thread for a port test module.

The port's tests run many small ops. Beside the other test workers on the
same cores, torch's intra-op thread pool only adds contention. A module
imports the fixture to run on one thread:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
