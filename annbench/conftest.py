"""Test settings of the benchmark's own tests: the ``card`` marker and the
fixtures that decide, inside a test, whether a card is there."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run them "
        "on the card with `python -m pytest -m card annbench`)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def few_threads():
    """Two torch threads while the test runs (several test workers share
    the machine), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
