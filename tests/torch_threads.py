"""A module fixture for the port's CPU tests: torch on one intra-op thread.

The tier-1 command runs the suite in several worker processes on the
CPU's cores, next to JAX's own thread pools; torch's per-process thread
team then only oversubscribes the cores, and its threads' waits slow every
worker.  The port's results do not depend on the thread count (its math is
integer, its float costs elementwise)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
