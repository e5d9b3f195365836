"""The benchmark's arithmetic: rates over a whole window, and busy time as
the union of intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(amount: float, seconds: float) -> float:
    """Work over the whole window's wall time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return amount / seconds


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by a set of intervals, overlaps counted once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
