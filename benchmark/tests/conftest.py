"""The benchmark's own tests.  Tests that need a CUDA card carry the
``card`` marker and ask for the ``card`` fixture, which skips them when no
card is present; the decision is made there, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# A size the CPU renders in seconds through the port's plain versions.
TINY = {"width": 8, "height": 8, "spp": 4, "depth": 4, "check_block": 2, "check_requests": 2,
        "warmup": 1, "trace_seconds": 0.2}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the harness measures the port on the card")
