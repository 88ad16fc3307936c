"""A module-scoped autouse fixture that runs a test module's torch work on
two threads (restored afterwards): the suite runs in several worker
processes on one machine, and a process asking torch for every core then
waits on the others' threads. Import it into a test module to apply it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)
