"""The benchmark's own tests, on the CPU at a tiny lattice; a test that
needs the card is marked ``cuda`` and skips itself without one (decided
inside the test, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself without one")


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
