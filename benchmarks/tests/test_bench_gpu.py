"""On the card, at each cell's own size with a short window: a run is
correct, and the control (the reference in bfloat16 in the program's
place) is not."""

from __future__ import annotations

import pytest

from benchmarks import harness

CELLS = ["two_straight.mpc", "three_bend.mpc", "two_straight.sweep"]


@pytest.mark.gpu
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_size(card, cell, control):
    line = harness.run_cell(harness.load_cell(cell), 2**32 + 17, 3, False, "cuda",
                            control=control)
    assert line["correct"] is (not control), line["checks"]
