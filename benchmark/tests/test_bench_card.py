"""On the card, at each cell's own size: each control, put in the
program's place, and each fault the cell can have come out not correct
through the harness's own comparison. Run on the chip with ``python -m
pytest benchmark/tests/test_bench_card.py -m cuda``; here they skip."""

import pytest
import torch

from benchmark import control

CELLS = ["x4-video-bf16", "x4-video-int8ups"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,arm", [(c, a) for c in CELLS for a in control.arms(c)])
def test_control_and_fault_are_not_correct(cell, arm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = control.reading(cell, 2**31 + 101, 2.0, arm)
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = control.reading(cell, 2**31 + 107, 2.0, "program")
    assert result["correct"] is True, result["checks"]
