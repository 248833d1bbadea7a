"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``card`` that need a CUDA card (they skip without one). Run them from the
repository's root:

    python -m pytest benchmark/tests -q --confcutdir=benchmark

and on a machine with a card, the marked ones alone with ``-m card``
(``--confcutdir`` keeps the repository's root conftest.py, which imports
JAX, out).
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def tiny_cell(name="low.stage2"):
    """A cell at a size the CPU runs in seconds: 128x128 (64 tiles, the
    bucketed window path), S = 3, 200 fg + 300 bg Gaussians, cap 256,
    16 query tracks at 2 target frames; its limits as committed."""
    from harness import spec

    cell = spec.load_cell(name)
    cell.config.update(
        frame={"width": 128, "height": 128, "intrinsics_divisor": 8.0},
        num_fg=200, num_bg=300, num_exposure=3, tile_cap=256)
    cell.traffic.update(query_tracks=16, track_targets=2, schedule_steps=32)
    return cell
