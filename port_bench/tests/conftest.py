"""Helpers of the benchmark's own tests: a cell cut to a size the CPU runs
in seconds, and the card fixture of the tests marked ``cuda``.

Run them from the checkout's root: ``python -m pytest port_bench/tests -q``
(the CPU ones), ``python -m pytest port_bench/tests -q -m cuda`` on the card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 3000000019     # above 2**31, as the driver's seeds may be

TINY_CONFIG = dict(n_gaussians=3000, width=96, height=64, n_views=6)
TINY_TRAFFIC = {
    "train": dict(warmup_steps=6, trace_steps=3, blocking_steps=2,
                  checked_rows=500),
    "serve": dict(warmup_requests=1, trace_requests=2, checked_pixels=500),
}


def tiny(cell, **config):
    """``cell`` at the tiny size, its limits and metrics as they are."""
    kind = cell.traffic["entry"]
    return cell._replace(config=dict(cell.config, **TINY_CONFIG, **config),
                         traffic=dict(cell.traffic, **TINY_TRAFFIC[kind]))


def run_tiny(cell, seconds=0.5, trace=False, seed=SEED):
    from port_bench import run
    import time
    return run.run_cell(tiny(cell), seed, seconds, trace,
                        torch.device("cpu"), time.perf_counter())


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
