"""Tests of the benchmark harness. They run on the CPU at tiny sizes;
a test marked `card` needs a CUDA device and skips without one (decided
inside the test, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest benchmark/tests -m card on the card)")
    return torch.device("cuda")
