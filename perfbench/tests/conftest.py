"""The benchmark's own tests: the harness on the CPU at small sizes (its
plain paths), the card-only ones marked `cuda` and skipped here.

    python -m pytest perfbench/tests -q            # CPU
    python -m pytest perfbench/tests -q -m cuda    # on the card
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return "cuda"
