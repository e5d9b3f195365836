"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have (``benchlib/faults.py``), the whole run (set-up,
window, check) at a tiny size on the CPU, without the harness's look for a
card."""

import pytest

from benchlib import faults
from bp_tiny import tiny_cell, tiny_run

CASES = [("v2-pieces-fp32", fault) for fault in faults.TRANSCRIPTION]
CASES += [("v2-train-b4-fp32", fault) for fault in faults.TRAINING]


def test_sound_runs_are_correct():
    for name in ("v2-pieces-fp32", "v2-train-b4-fp32"):
        run = tiny_run(tiny_cell(name))
        assert run.correct(), (name, run.checks)


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}: {f}" for c, f in CASES])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    getattr(faults, fault)(monkeypatch.setattr)
    run = tiny_run(tiny_cell(cell))
    assert not run.correct(), run.checks
