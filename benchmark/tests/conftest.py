"""The benchmark's own tests: on the CPU at a tiny size, and (marker
``cuda``) on the card.  Run from the repo root:

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -q -m cuda    # on a card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the CPU tests' size: parcels and a coarse grid
TINY = {"n_parcels": 4096, "grid": {"nx": 36, "ny": 19, "nz": 8}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.device("cuda")
