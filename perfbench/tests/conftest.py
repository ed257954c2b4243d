"""The benchmark's own tests: the repository root on sys.path, and the
marker of tests that need a CUDA card (they skip without one)."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


# one thread a test process: the suite runs with several workers
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
