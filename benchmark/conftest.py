"""pytest settings of the benchmark's own tests (``python3 -m pytest
benchmark``): the `gpu` marker, and the `card` fixture that skips a test
where no CUDA card is visible."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    return torch.device("cuda", 0)
