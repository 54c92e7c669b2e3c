"""On the card: each cell at its own size, one request, holds its limits,
and its control (the reference in float8) fails one. Run there with

    python -m pytest --noconftest -m cuda perfbench/tests/test_perfbench_card.py
"""

import pytest

from perfbench.lib import bench


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")
    bench.set_cache_dirs()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["motion-clip256", "shape-latents50"])
def test_cell_is_correct_and_its_control_is_not(card, cell):
    r = bench.run_cell(cell, 2 ** 31 + 99, 0.0, False, 0.0, control=True)
    assert r["correct"] is True, r["compared"]
    limits = {k: v["limit"] for k, v in r["compared"].items()}
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
