"""The benchmark's own tests. ``card``: a test that needs a CUDA card; it
skips inside the test (the ``card`` fixture) where there is none, never
while a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
