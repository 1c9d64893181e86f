"""The benchmark's own tests.  CPU tests run anywhere; tests marked
``card`` need a CUDA card and skip without one (the decision is made in
the ``card`` fixture, when a test runs, never at import)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs measure the card")
    return "cuda:0"


def tiny(cell, size=16, **traffic):
    """A cell at a size the CPU runs in seconds."""
    cell.traffic = dict(cell.traffic, image_size=[size, size], check_pixels=64, check_frames=2, trace_units=1,
                        **traffic)
    return cell
