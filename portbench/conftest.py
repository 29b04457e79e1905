"""pytest settings of the benchmark's own tests (``portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; the check is made
inside the fixture, never when a module is imported."""
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")
