"""The tiny cells on the card, through the kernels (run on the chip:
``python -m pytest port_bench/tests -m cuda``)."""

import pytest
import torch

import bench_fixture as bf


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.prefill", "tiny.batch4"])
def test_tiny_cell_on_the_card(card, tmp_path, cell):
    rc, res = bf.run_cell(bf.make_copy(tmp_path), cell, trace=1)
    assert rc == 0 and res["correct"], res
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
