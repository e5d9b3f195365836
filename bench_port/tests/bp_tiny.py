"""Tiny cells for the harness's CPU tests: the benchmark's own cells with
their configurations cut to a few thousand parameters and their traffic to
a few seconds, run through the same drivers on the CPU."""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import manifest, runner  # noqa: E402

TINY_V2 = {"f_min": 30, "f_max": 1900, "n_mels": 32, "hopSize": 64, "windowSize": 256, "fs": 4000,
           "nExtraWins": 2, "baseSize": 8, "nHead": 2, "nLayers": 2, "scoringExpansionFactor": 2,
           "segmentSizeInSecond": 2.0, "segmentHopSizeInSecond": 1.0,
           # dropout as the published configuration has it
           "scoreDropoutProb": 0.1, "contextDropoutProb": 0.0, "velocityDropoutProb": 0.1,
           "refinedOFDropoutProb": 0.1}


def tiny_cell(name: str, root: str = ROOT, here: str = BENCH) -> manifest.Cell:
    cell = manifest.load_cell(root, name, here)
    cell.config = {**cell.config, **TINY_V2, "overrides": {"scorer.map.0.bias[-1]": -2.0}}
    t = dict(cell.traffic)
    if t["kind"] == "corpus":
        t.update(pool=3, seconds_min=20, seconds_max=30, validation_seconds=5)
    else:
        t.update(pool=4, seconds_min=3, seconds_max=12)
    cell.traffic = t
    cell.params = {**cell.params, "warm_steps": 4}
    return cell


def tiny_run(cell: manifest.Cell, seed: int = 2**33 + 5, seconds: float = 1.0, control: bool = False):
    """Measure and check ``cell`` on the CPU; returns the run."""
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    run = runner.Run(args, cell, time.perf_counter(), ROOT, device="cpu")
    run.control = control
    driver = manifest.load_module("drivers", cell.params["driver"])
    try:
        driver.measure(run)
        driver.check(run)
    finally:
        run.cleanup()
    return run
