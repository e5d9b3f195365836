"""Profiling helpers (the port's ``transkun_tpu/utils/profiling.py``): a
real-time-factor meter, an accumulating phase timer, a ``torch.profiler``
trace and a wait for the devices of a tree of tensors.

The clocks are the host's (``time.perf_counter``).  PyTorch returns before
the card finishes, so a span that must cover the card's work synchronizes
the card first: ``RTFMeter.measure(..., device=)`` does, ``PhaseTimer``
times the host alone unless the phase ends in ``block``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class RTFMeter:
    """Seconds of audio processed per second of wall time."""

    def __init__(self):
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, audio_seconds: float, device: Optional[torch.device] = None):
        """Time the block as ``audio_seconds`` of audio; with a card as
        ``device``, synchronize it before each reading of the clock."""
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        self.wall_seconds += time.perf_counter() - t0
        self.audio_seconds += audio_seconds

    @property
    def rtf(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)


class PhaseTimer:
    """Accumulating named phase timer for pipeline breakdowns."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name] * 1e3:.1f} ms total, "
                f"{self.totals[name] / max(self.counts[name], 1) * 1e3:.2f} ms/call "
                f"({self.counts[name]} calls)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card where
    CUDA is available), written to ``log_dir/trace.json`` in the Chrome
    trace format (Perfetto, ``chrome://tracing``).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block(tree):
    """Wait for every card that holds a tensor of ``tree`` (nested lists,
    tuples and dicts of tensors); returns ``tree``."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for d in devices:
        torch.cuda.synchronize(d)
    return tree
