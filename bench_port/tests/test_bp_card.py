"""One short run of each cell on the card (``-m gpu``; skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from bp_tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["v2-pieces-fp32", "v2-train-b4-fp32"])
def test_cell_runs_correct(card, workload):
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", workload, "--seed", "2718281828",
                          "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
