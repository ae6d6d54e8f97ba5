"""pytest set-up of the benchmark's own tests (``python -m pytest
benchmark/tests``): the benchmark's folder and the checkout on the path,
and the ``card`` marker of the tests that need an NVIDIA card, which skip
here with a reason (the ``card`` fixture decides, never at import)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the check runs on the card only")
    return torch.device("cuda", 0)
