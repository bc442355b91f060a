"""Shared set-up of the benchmark's tests: the benchmark's folder and the
checkout on the path, the ``card`` marker, and small versions of the cells
for the CPU."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a cell's traffic cut to what a CPU test holds: the same generator and
#: sizes of a clip, four clips a batch
SMALL = {"batch": 4, "backlog_batches": 2, "warmup_batches": 1, "trace_batches": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_cell(name: str):
    from harness.spec import cell, load_benchmark

    c = cell(load_benchmark(), name)
    c["mix"].update(SMALL)
    c["config"]["check_clips"] = 8  # every clip of the small backlog
    return c


def run_small(name: str, seed: int = 2**31 + 11, seconds: float = 0.5, trace: bool = False):
    """One run of cell ``name`` on the CPU at the small size, through the
    harness's own run (its look for a card skipped)."""
    import torch

    import run

    return run.run_cell(small_cell(name), seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter())
