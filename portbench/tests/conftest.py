"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips where there is no CUDA device; the decision is made
when the fixture runs, never at import.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
