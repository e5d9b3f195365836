"""Profiling helpers (the port's ``transkun_tpu/utils/profiling.py``): the
program's span-and-counter recorder, a real-time-factor meter, a
``torch.profiler`` trace and a wait for the devices of a tree of tensors.

**The recorder** (``span``, ``root``, ``count``; one ``Recorder`` a process,
``RECORDER``).  The program opens a span, named ``transkun.<phase>``,
around each phase of a piece's transcription and of a training iteration
(README, "Timing"), and counts pieces, segments, steps and the like beside
them.  A root span (a piece's dispatch or finish; a training iteration's
input, step, metric fetch, stats pass or save) decides for itself and for
every span opened inside it whether they record: they do when
``TRANSKUN_TPU_TIMING`` is set or a ``torch.profiler`` is recording, read
once, as the root opens.  The second lets a ``torch.profiler`` session
show the program's phases on its timeline without a second switch.

- Off, a span site is one test and returns a shared no-op context: no
  clock read, no ``record_function`` call, no allocation.  A counter is one
  test.
- On, a span reads ``time.perf_counter`` at its ends and enters
  ``torch.profiler.record_function(name)``, so that under a profiler it
  stands on the device trace's clock beside the operations it launched.
  Its record is ``Span(name, key, parent, t0, t1)``: ``key`` is the piece's
  serial number or the training step (a span without one takes its
  parent's), ``parent`` the name of the span it opened in.  The nesting is
  per thread.
- Memory stays bounded: per-name totals (count, seconds) and the counters
  accumulate for the process (``totals``, ``counters``; ``reset`` empties
  them, so a caller can take a window); the records are kept for the last
  root only (``last``) and, for the caller that opened it, on the root's
  own context (``Open.records``).

Nothing of the recorder goes to the device.

The other clocks are the host's too.  PyTorch returns before the card
finishes, so a span that must cover the card's work synchronizes the card
first: ``RTFMeter.measure(..., device=)`` does; a recorder span times the
host's enqueue unless what it covers waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

ENV = "TRANSKUN_TPU_TIMING"


class Span(NamedTuple):
    name: str
    key: Optional[int]
    parent: Optional[str]
    t0: float
    t1: float


class _Noop:
    """The span of a site that does not record."""

    __slots__ = ()
    records: Tuple[Span, ...] = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Thread(threading.local):
    on = False  # the open root records (read as it opened)

    def __init__(self):
        self.stack: List["Open"] = []


class Open:
    """A recording span: a context manager, entered once."""

    __slots__ = ("_rec", "name", "key", "parent", "t0", "records", "_rf")

    def __init__(self, rec: "Recorder", name: str, key: Optional[int]):
        self._rec, self.name, self.key = rec, name, key

    def __enter__(self) -> "Open":
        stack = self._rec._local.stack
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.name
        if self.key is None and up is not None:
            self.key = up.key
        # a root's records, shared by every span inside it
        self.records = [] if up is None else up.records
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        rec = self._rec
        local = rec._local
        local.stack.pop()
        record = Span(self.name, self.key, self.parent, self.t0, t1)
        self.records.append(record)
        with rec._lock:
            total = rec._totals.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] += t1 - self.t0
            if self.parent is None:
                rec._last = self.records
        if not local.stack:
            local.on = False  # a span outside any root records nothing
        return False


def enabled() -> bool:
    """Whether a root opened now records: ``TRANSKUN_TPU_TIMING`` set, or
    a ``torch.profiler`` recording."""
    return bool(os.environ.get(ENV)) or torch.autograd._profiler_enabled()


class Recorder:
    """Spans and counters of the program (the module's docstring)."""

    def __init__(self):
        self._local = _Thread()
        self._lock = threading.Lock()
        self._totals: Dict[str, List[float]] = {}
        self._counters: Dict[str, int] = {}
        self._last: List[Span] = []

    def root(self, name: str, key: Optional[int] = None):
        """A span that decides, as it opens, whether it and the spans inside
        it record; inside another root, a span of that root."""
        local = self._local
        if not local.stack:
            local.on = enabled()
        return self.span(name, key)

    def span(self, name: str, key: Optional[int] = None):
        """A span of the open root: a context manager yielding ``Open``
        where it records, ``NOOP`` where it does not."""
        if not self._local.on:
            return NOOP
        return Open(self, name, key)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` where the open root records."""
        if not self._local.on:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """Span name -> (count, host seconds) since the last ``reset``."""
        with self._lock:
            return {k: (int(c), s) for k, (c, s) in self._totals.items()}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def last(self) -> List[Span]:
        """The records of the last root to close, in the order they closed."""
        with self._lock:
            return list(self._last)

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counters.clear()
            self._last = []


RECORDER = Recorder()
root = RECORDER.root
span = RECORDER.span
count = RECORDER.count
totals = RECORDER.totals
counters = RECORDER.counters
last = RECORDER.last
reset = RECORDER.reset


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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card where
    CUDA is available), written to ``log_dir/trace.json`` in the Chrome
    trace format (Perfetto, ``chrome://tracing``).  Yields the profiler.
    The program's spans record under it and name its host rows."""
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
