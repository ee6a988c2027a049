"""The harness's own tests: CPU tests at small sizes, and tests marked
``cuda`` that need the card (they decide inside the ``cuda_device``
fixture whether there is one, and skip here). Imports no JAX."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs the cell on the card)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs only on the card")
    return "cuda"
