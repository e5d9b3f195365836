"""The control at a size a test run holds: the plain reference with its
float32 products rounded to TF32 (the card's TF32, emulated on the CPU),
read against the float32 reference, comes out above each cell's limit on
one of its numbers, where the program comes out below all of them."""

import pytest

from bp_tiny import tiny_cell, tiny_run

CELLS = ["v2-pieces-fp32", "v2-train-b4-fp32"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    run = tiny_run(tiny_cell(name), control=True)
    assert run.correct(), run.checks
    over = [k for k, (_, limit) in run.checks.items() if run.control_readings[k] > limit]
    assert over, (run.control_readings, run.checks)
