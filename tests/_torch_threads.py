"""The torch thread cap of the port's test files: ``from _torch_threads
import _few_threads`` gives a file the autouse fixture."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads for the file's tests and module fixtures: the
    test lane runs six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
