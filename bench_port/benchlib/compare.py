"""The comparisons that decide ``correct``."""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, Sequence, Tuple

import torch


def note_mismatch(got: Sequence[Tuple[float, float, int, int]], want: Sequence[Tuple[float, float, int, int]],
                  tol_s: float) -> float:
    """Share of the two note lists left unpaired: a note of ``got`` pairs
    with one of ``want`` of the same pitch and velocity whose onset and
    offset both lie within ``tol_s``; each note pairs once, in time order.
    (unpaired got + unpaired want) / (len(got) + len(want)); 0 for two empty
    lists."""
    if not got and not want:
        return 0.0
    by_key = defaultdict(lambda: ([], []))
    for s, e, p, v in got:
        by_key[(p, v)][0].append((s, e))
    for s, e, p, v in want:
        by_key[(p, v)][1].append((s, e))
    paired = 0
    for a, b in by_key.values():
        a.sort()
        b.sort()
        used = [False] * len(b)
        j0 = 0
        for s, e in a:
            while j0 < len(b) and b[j0][0] < s - tol_s:
                j0 += 1
            j = j0
            while j < len(b) and b[j][0] <= s + tol_s:
                if not used[j] and abs(b[j][1] - e) <= tol_s:
                    used[j] = True
                    paired += 1
                    break
                j += 1
    return (len(got) + len(want) - 2 * paired) / (len(got) + len(want))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap between two norms: |got - want| over the larger of
    want's norm of that leaf and the median leaf's."""
    floor = statistics.median(want[k] for k in keep)
    return {k: abs(got[k] - want[k]) / max(want[k], floor) for k in keep}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's gap; (gap, leaf)."""
    gaps = leaf_gaps(got, want, keep)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: Sequence[str]) -> float:
    """The median leaf's gap: steady from seed to seed where the worst
    leaf's swings with one small leaf."""
    return statistics.median(leaf_gaps(got, want, keep).values())


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}
