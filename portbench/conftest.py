"""The benchmark's own tests (``python -m pytest portbench/tests``). Tests
that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is present; on the card:
``python -m pytest portbench/tests -m card``."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
