"""Settings of the benchmark's own CPU tests (``python -m pytest nbbench``)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; each test skips itself when none is present")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)
