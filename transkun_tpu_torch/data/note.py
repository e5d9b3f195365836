"""The note record of decoded events and the invariants they keep.

Copy of the part of ``transkun_tpu/data/note.py`` that transcription uses:
``Note``, ``resolve_overlapping`` and ``validate_notes``.  The port's
transcription path imports nothing of the JAX package, so it carries these
few lines itself; the CLI still writes MIDI with ``transkun_tpu.data.midi``,
which takes any object with these fields.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Note:
    """A note or pedal event.  Negative pitch encodes a pedal as -CC number
    (64 sustain, 67 una corda); velocity in 0..127.  hasOnset/hasOffset mark
    whether an endpoint is real or an artifact of segment truncation."""

    __slots__ = ("start", "end", "pitch", "velocity", "hasOnset", "hasOffset")

    def __init__(self, start, end, pitch, velocity, hasOnset=True, hasOffset=True):
        self.start = start
        self.end = end
        self.pitch = pitch
        self.velocity = velocity
        self.hasOnset = hasOnset
        self.hasOffset = hasOffset

    def __repr__(self):
        return str({k: getattr(self, k) for k in self.__slots__})

    def __eq__(self, other):
        return isinstance(other, Note) and all(
            getattr(self, k) == getattr(other, k) for k in self.__slots__
        )


def resolve_overlapping(note_events: List[Note]) -> List[Note]:
    """Truncate same-pitch overlaps at the next onset and drop zero-length
    notes; the result is sorted by (start, end, pitch).

    The sort, the same-pitch successor scan, the filter and the check run
    as numpy array ops; only the truncated notes are touched one by one (a
    piece ends with 10^3-10^4 events)."""
    n_ev = len(note_events)
    s = np.array([n.start for n in note_events], np.float64)
    e = np.array([n.end for n in note_events], np.float64)
    p = np.array([n.pitch for n in note_events], np.int64)
    order = np.lexsort((p, e, s))  # (start, end, pitch), ties stable
    s, e, p = s[order], e[order], p[order]
    # same-pitch successor in sorted order: a stable sort by pitch keeps the
    # (start, end) order within each pitch
    byp = np.lexsort((np.arange(n_ev), p))
    same = p[byp[1:]] == p[byp[:-1]]
    prev_i, next_i = byp[:-1][same], byp[1:][same]
    trunc = e[prev_i] > s[next_i]
    for pi, ni in zip(prev_i[trunc].tolist(), next_i[trunc].tolist()):
        note_events[order[pi]].end = s[ni]
        e[pi] = s[ni]
    keep = s < e
    out_order = np.lexsort((p[keep], e[keep], s[keep]))
    out = [note_events[i] for i in order[keep][out_order].tolist()]
    # per-pitch monotonicity on the final arrays; positive length is `keep`
    sk, ek, pk = s[keep][out_order], e[keep][out_order], p[keep][out_order]
    byp = np.lexsort((np.arange(len(out)), pk))
    same = pk[byp[1:]] == pk[byp[:-1]]
    if not np.all(sk[byp[1:][same]] >= ek[byp[:-1][same]]):
        raise AssertionError("same-pitch notes overlap after resolution")
    return out


def validate_notes(notes: Sequence[Note]) -> None:
    """Per-pitch monotonicity and positive length."""
    last = {}
    for n in notes:
        if n.pitch in last:
            assert n.start >= last[n.pitch].end, f"{n} overlaps {last[n.pitch]}"
        assert n.start < n.end, n
        last[n.pitch] = n
