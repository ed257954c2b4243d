"""A short run of every cell on the card (skips where there is none).

    python3 -m pytest -q perfbench/tests -m card
"""

import time

import pytest

from perfbench import harness


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ultrafast-1080p.live",
                                      "medium-zerolatency-1080p.ch8"])
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = harness.run_cell(workload, 2 ** 31 + 99, 5.0, False,
                           time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["fps"]["value"] > 0
