"""The port's CPU test files' thread setting, imported by each of them."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is many small operations: one intra-op
    thread a test process, since parallel test workers share the cores
    (six concurrent runs of ``test_torch_walk.py`` on an 8-core host: 1063 s
    at eight threads each, 51 s at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
