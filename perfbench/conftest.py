"""Pytest settings of the benchmark's own tests (``pytest perfbench/tests``):
the ``card`` marker for tests that need an NVIDIA GPU; they skip inside the
``card`` fixture where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
