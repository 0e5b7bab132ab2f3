"""The benchmark's own tests (``python -m pytest ogcbench/tests``): CPU
tests at tiny sizes, and tests marked ``card`` that need a CUDA card and
skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, when the
    test runs, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
