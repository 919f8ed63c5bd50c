import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run them "
        "on the card with `python -m pytest -m card tests annbench`)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
