"""The control on the card: the plain reference put in the program's
place one precision below the configuration's (fp8 under bfloat16, TF32
under float32) comes out not correct under each cell's limits, at the
cell's own size. Marked ``gpu``: it skips without a card."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, readings

CELLS = ("ssl-bf16.train-online", "c4c-fp32.train-online",
         "c4c-fp32.eval-closed-loop")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [3900000001, 3900000002, 3900000003])
def test_the_control_is_not_correct(cell_name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(cell_name)
    reading = readings.read(cell, "control", seed, 1.0,
                            torch.device("cuda", 0))
    assert reading["correct"] is False, reading["numbers"]
