"""A module-scoped autouse fixture for the PyTorch package's CPU tests:
two intra-op threads while the module runs.  The suite runs several test
processes on one host, where torch's default of one thread a core
oversubscribes it.  Import ``few_torch_threads`` into a test module to
apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
