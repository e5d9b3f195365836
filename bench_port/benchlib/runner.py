"""One run of a cell: the state a driver fills in, and the result line."""

from __future__ import annotations

import json
import math
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from . import env, manifest


class Run:
    """What a driver measures and the harness prints.

    A driver fills ``setup_s`` (process start to the window's start),
    ``e2e`` (end-to-end values by name), ``peak_bytes``, ``attempted``,
    ``failed``, ``counters`` (what per-layer readers read), ``summary`` (the
    traced stretch, ``--trace 1`` only) and ``checks`` (name -> (value,
    limit); a value above its limit is not correct)."""

    def __init__(self, args, cell: manifest.Cell, t0: float, root: str, device="cuda"):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.cell = cell
        self.t0 = t0
        self.root = root
        self.device = device
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.peak_bytes = 0
        self.attempted = 0
        self.failed = 0
        self.counters: Dict[str, Any] = {}
        self.summary = None
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.notes: Dict[str, Any] = {}  # said on standard error before the checks
        self.control = False  # also run the control (``control.py`` only)
        self.control_readings: Dict[str, float] = {}
        self._tmp = None

    @property
    def conf(self) -> Dict[str, Any]:
        return self.cell.config

    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self) -> None:
        if self.on_card():
            import torch

            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.on_card():
            import torch

            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        if not self.on_card():
            return 0
        import torch

        return torch.cuda.max_memory_allocated()

    def free(self) -> None:
        import gc

        gc.collect()
        if self.on_card():
            import torch

            torch.cuda.empty_cache()

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def tmpdir(self) -> str:
        """A directory for this run's files under ``TMPDIR``, removed at the
        end of the run."""
        if self._tmp is None:
            self._tmp = tempfile.mkdtemp(prefix="bench_port_")
        return self._tmp

    def cleanup(self) -> None:
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def counter(self, name: str):
        return manifest.load_module("counters", name)

    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(math.isfinite(v) and v <= lim for v, lim in self.checks.values()))


def per_layer(run: Run) -> Dict[str, Dict[str, Any]]:
    """Every per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in run.cell.per_layer:
        value = manifest.load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run, device_kind: str) -> Dict[str, Any]:
    if run.trace:
        metrics = per_layer(run)
    else:
        metrics = {}
        for m in run.cell.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is None:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": run.cell.chips,
              "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": run.correct(), "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = run.summary.busy_s
        device["window_s"] = run.summary.window_s
        out["breakdown"] = run.summary.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def emit(run: Run, device_kind: str) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output; nothing when JAX or the JAX package
    is loaded."""
    found = env.loaded_forbidden()
    if found:
        sys.exit(f"bench_port: modules of JAX or the JAX package are loaded: {', '.join(found)}")
    out = result(run, device_kind)
    for k, v in run.notes.items():
        print(f"bench_port: {k} = {v}", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)

