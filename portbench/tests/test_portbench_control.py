"""The control of `correct`, on the card: at each cell's own size and load,
the program with its own int8 path switched on (the precision below the
configurations' bf16) comes out not correct on three seeds, and the
program as configured comes out correct on the same seeds. Needs a CUDA
device; skips without one.

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import pytest
import torch

from portbench import readings

CELLS = ("s640-knee80", "n416-knee80")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control runs at the cells' "
                    "own sizes on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_int8_control_fails_where_the_program_passes(card, cell):
    seeds = [2**31 + 101, 2**31 + 202, 2**31 + 303]
    rows = readings.read(cell, 3.0, seeds, seeds)
    for row in rows:
        assert row["correct"] == (row["variant"] == "program"), row
