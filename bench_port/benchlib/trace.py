"""A traced stretch: ``torch.profiler`` over a few seconds of the cell's
traffic, summarized in memory (nothing exported): the device operations'
intervals, their union (busy time), the harness spans the host was in, and
the idle gaps named by those spans.

Where a driver marks its hand-overs (``mark``), the summary covers the
stretch from the first mark to the last: the steady part of a closed loop,
without the drain of the items still in flight once the feed has
stopped."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from . import stats

STRETCH = "bench_port.stretch"
MARK = "bench_port.handover"
# harness spans that name what the host was doing
SPANS = ("dispatch", "finish", "step", "input", "stats")
ANNOTATIONS = set(SPANS) | {STRETCH, MARK}


def _on_card(ev) -> bool:
    dt = getattr(ev, "device_type", None)
    return dt is not None and getattr(dt, "name", str(dt)).upper().endswith("CUDA")


@contextlib.contextmanager
def span(name: str, on: bool = True):
    """A named host span that appears in the trace (a no-op when off)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def mark(on: bool = True) -> None:
    """An instant in the trace that bounds the summarized stretch."""
    if on:
        import torch

        with torch.profiler.record_function(MARK):
            pass


@dataclass
class Summary:
    window_s: float  # the summarized stretch's wall time, from the trace's clock
    busy_s: float  # union of the device operations' intervals
    by_name: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name -> (count, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host span, seconds), longest first
    traced_s: float = 0.0  # the whole profiled stretch, marks or not

    def kernel_time(self, needles) -> Tuple[int, float]:
        """(launches, device seconds) of operations whose name holds any of
        ``needles``."""
        n, s = 0, 0.0
        for name, (c, t) in self.by_name.items():
            if any(k in name for k in needles):
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> Dict[str, list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[name[:160], t] for name, (_, t) in top],
                "idle_gaps": [[name, t] for name, t in self.gaps[:10]]}


def _interval(ev):
    tr = ev.time_range
    return tr.start * 1e-6, tr.end * 1e-6


def _is_device(ev) -> bool:
    """An operation that ran on the card: a kernel, copy or fill, and not
    the card-side mirror of a host span (a user annotation)."""
    dt = getattr(ev, "device_type", None)
    if dt is None or not getattr(dt, "name", str(dt)).upper().endswith("CUDA"):
        return False
    return not getattr(ev, "is_user_annotation", False) and ev.name not in ANNOTATIONS


class Tracer:
    """``torch.profiler`` over a stretch begun and ended by calls (the
    stretch may span calls of a loop the harness does not own).  Both ends
    synchronize the card."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(STRETCH)
        self.span.__enter__()

    def stop(self) -> "Summary":
        import torch

        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        out = summarize(self.prof.events())
        del self.prof
        return out


@contextlib.contextmanager
def stretch(result: list):
    """Profile the block; append its ``Summary`` to ``result``."""
    tracer = Tracer()
    tracer.start()
    yield
    result.append(tracer.stop())


def summarize(events) -> Summary:
    window = None
    spans, ops, marks = [], [], []
    for ev in events:
        if _is_device(ev):
            a, b = _interval(ev)
            ops.append((ev.name, a, b))
        elif ev.name == STRETCH and not _on_card(ev):
            window = _interval(ev)
        elif ev.name in SPANS and not _on_card(ev):
            spans.append((ev.name,) + _interval(ev))
        elif ev.name == MARK and not _on_card(ev):
            marks.append(_interval(ev)[0])
    if window is None:
        raise RuntimeError("the trace holds no stretch span")
    lo, hi = window
    traced = hi - lo
    if len(marks) >= 2:
        lo, hi = max(lo, min(marks)), min(hi, max(marks))
    # whole launches that start in the stretch, by name; busy time clipped to it
    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for n, a, b in ops:
        if lo <= a < hi:
            by_name[n][0] += 1
            by_name[n][1] += b - a
    ops = [(n, max(a, lo), min(b, hi)) for n, a, b in ops if b > lo and a < hi]
    busy = stats.union_length((a, b) for _, a, b in ops)
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time in the traced stretch")
    named = []
    for g0, g1 in stats.gaps(((a, b) for _, a, b in ops), lo, hi):
        inside = [s for s in spans if s[1] <= g0 < s[2]]
        # the innermost span the host was in when the card fell idle
        name = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "other"
        named.append((name, g1 - g0))
    named.sort(key=lambda x: -x[1])
    return Summary(hi - lo, busy, {k: (v[0], v[1]) for k, v in by_name.items()}, named, traced)
