"""One torch intra-op thread while a port test file runs.

The test workers share the machine's cores, and torch's default of one
thread per core then oversubscribes them: beside five busy workers a small
run slows by twentyfold.  A test file takes the fixture by importing it::

    from _torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
