"""pytest settings of the benchmark's own tests (``python -m pytest benchmark/tests``):
the repository's root on the path, and the ``card`` marker of the tests that
need a CUDA card (they skip without one; the card is looked for inside a
fixture, never while a module is imported)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with python -m pytest benchmark/tests")
    return torch.device("cuda")
