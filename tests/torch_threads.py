"""Shared fixture of the port's CPU tests (``tests/test_torch_*.py``).

The suite runs in several worker processes on the same cores; torch's
default of one intra-op thread per core then oversubscribes them and
roughly doubles the port tests' wall time. Each port test module imports
``one_torch_thread``, which runs the module on one thread and restores the
count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
