"""Small runs of the benchmark's cells on the CPU, for the tests.

A small run keeps every cell's traffic, comparison and limits and shrinks
only what makes a CPU run slow: three grid levels (16, 32, 48 channels),
2000 points a cloud, two clouds a batch, 32 proposals and 8 dense grids.
"""

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402


def small_run(workload: str, seed: int = 7, device: str = "cpu", seconds: float = 0.0):
    run = harness.make_run(harness.benchmark(), workload, seed, seconds, False, time.perf_counter())
    run.device = device
    m = run.config["model"]
    m.update(channels=[16, 32, 48], level_capacity_divisors=[1, 2, 4], max_points=2000,
             max_proposals=32, dense_grid_capacity=8)
    run.traffic["num_points"] = 2000
    if run.traffic["kind"] == "train_steps":
        run.traffic["batch"] = 2
    else:
        run.traffic.update(pool=2, compared=2)
    return run


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return "cuda"
