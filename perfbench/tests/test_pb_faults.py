"""Runs of the tiny cells on the CPU with the timed path broken
underneath (:func:`perfbench.readings.planted`): each fault a cell can
have makes ``correct`` false under the cell's limits, and the run left
alone stays correct. The configurations run in float32 here: the faults
do not depend on the precision, and float32 keeps the sound runs far
inside the limits at batch 4."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, readings
from perfbench.tests import tiny

CPU = torch.device("cpu")
CASES = [("ssl-bf16.train-online", m)
         for m in ("program", "unchanged", "half_batch")]
CASES += [("c4c-fp32.train-online", m)
          for m in ("program", "unchanged", "half_batch")]
CASES += [("c4c-fp32.eval-closed-loop", m)
          for m in ("program", "answer", "prediction")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny.make_root(tmp_path_factory.mktemp("faults"), dtype="float32")
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell_name,mode", CASES)
def test_a_fault_makes_the_run_incorrect(root, cell_name, mode):
    cell = harness.Cell(cell_name, root)
    reading = readings.read(cell, mode, 2147483713, 0.3, CPU)
    assert reading["correct"] is (mode == "program"), reading["numbers"]
