"""The benchmark's tests: ``python -m pytest benchmark/tests -q``. They run on
the CPU at small sizes; those marked ``card`` need a CUDA device, which a
fixture decides, and skip without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the machine with the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark runs, so that workers do not
    oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
