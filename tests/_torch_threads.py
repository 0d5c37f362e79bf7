"""The port's tests of small tensors run with one intra-op thread a
process: the suite runs several processes on the machine's cores, and
torch's default of one thread a core slows each of them many times over.
A test file takes the fixture with `from _torch_threads import one_thread`.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module, the count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
