"""pytest settings of the benchmark's own tests (``cardbench/tests``): the
``card`` marker, for tests that need a CUDA card and skip without one, and
the fixtures they share. Run: ``python -m pytest cardbench/tests -q``; on the
card the marked tests run too."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while a module is
    imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def one_thread():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
