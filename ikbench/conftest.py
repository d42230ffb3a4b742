"""pytest settings of the benchmark's own tests (``python -m pytest
ikbench/tests``): the ``card`` marker, for tests that need a CUDA card.
Whether a card is there is decided inside the ``card`` fixture, never when
a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
