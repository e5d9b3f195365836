"""A cell added by files and manifest entries alone: a new configuration,
traffic mix, cell file and per-layer reader in a copy of the benchmark,
run there at a tiny size on the CPU, with no existing file changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from bp_tiny import BENCH, ROOT, TINY_V2


def _hashes(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_cell_from_files_only(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(tmp_path)
    b = tmp_path / "bench_port"
    config = {**TINY_V2, "model": "v2", "precision": "fp32", "overrides": {"scorer.map.0.bias[-1]": -2.0}}
    (b / "configs" / "tiny-v2.json").write_text(json.dumps(config))
    with open(b / "traffic" / "pieces-maestro.json") as f:
        traffic = {**json.load(f), "pool": 3, "seconds_min": 3, "seconds_max": 9}
    (b / "traffic" / "tiny-pieces.json").write_text(json.dumps(traffic))
    (b / "cells" / "tiny-v2-pieces.json").write_text(json.dumps(
        {"driver": "transcribe_many", "trace_seconds": 1,
         "check": {"sample": 2, "tolerance_s": 0.001, "note_mismatch": 0.01}}))
    (b / "metrics" / "notes_per_segment.py").write_text(
        "def read(run):\n    return run.counters.get('notes_per_segment')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-v2", "source": "https://example.org/tiny", "file":
                             "bench_port/configs/tiny-v2.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-v2-pieces", "config": "tiny-v2", "traffic": "tiny-pieces",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "transcribe_rtf":
            m["workloads"].append("tiny-v2-pieces")
    bench["per_layer"].append({"name": "notes_per_segment", "unit": "notes", "better": "higher",
                               "source": "program_counter", "layer": "finish", "moves": "transcribe_rtf",
                               "workloads": ["tiny-v2-pieces"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import argparse, json, sys, time
sys.path[:0] = [{str(tmp_path)!r}, {str(b)!r}, {ROOT!r}]
from benchlib import manifest, runner
cell = manifest.load_cell({str(tmp_path)!r}, "tiny-v2-pieces")
run = runner.Run(argparse.Namespace(seed=9, seconds=1.0, trace=0), cell, time.perf_counter(),
                 {str(tmp_path)!r}, device="cpu")
driver = manifest.load_module("drivers", cell.params["driver"])
driver.measure(run)
driver.check(run)
run.counters["notes_per_segment"] = run.notes["audio_seconds"] and 1.0
print(json.dumps({{"result": runner.result(run, "cpu"), "layer": runner.per_layer(run),
                  "readers": [m["name"] for m in cell.per_layer]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]["correct"] is True
    assert set(got["result"]["metrics"]) == {"transcribe_rtf", "peak_mem_gib", "setup_s"}
    assert got["layer"]["notes_per_segment"]["value"] == 1.0
    assert "notes_per_segment" in got["readers"]
    after = _hashes(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")
