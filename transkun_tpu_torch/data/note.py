"""Note/event data model and MIDI-event utilities.

Counterpart of the event-processing half of the reference data layer
(``transkun/Data.py:20-229``): the ``Note`` record (negative pitch = pedal CC
number), control-change switch parsing, sustain-pedal note extension,
same-pitch overlap resolution, and invariant validation.

The port's own copy of ``transkun_tpu/data/note.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence


class Note:
    """A note or pedal event.  Negative pitch encodes a pedal as -CC number
    (64 sustain, 66 sostenuto, 67 una corda); velocity in 0..127.  The
    hasOnset/hasOffset flags mark whether the endpoint is real or an artifact
    of segment/chunk truncation (ref ``Data.py:20-30``)."""

    __slots__ = ("start", "end", "pitch", "velocity", "hasOnset", "hasOffset")

    def __init__(self, start, end, pitch, velocity, hasOnset=True, hasOffset=True):
        self.start = start
        self.end = end
        self.pitch = pitch
        self.velocity = velocity
        self.hasOnset = hasOnset
        self.hasOffset = hasOffset

    def copy(self) -> "Note":
        return Note(
            self.start, self.end, self.pitch, self.velocity, self.hasOnset, self.hasOffset
        )

    def __repr__(self):
        return str(
            {
                "start": self.start,
                "end": self.end,
                "pitch": self.pitch,
                "velocity": self.velocity,
                "hasOnset": self.hasOnset,
                "hasOffset": self.hasOffset,
            }
        )

    def __eq__(self, other):
        return (
            isinstance(other, Note)
            and self.start == other.start
            and self.end == other.end
            and self.pitch == other.pitch
            and self.velocity == other.velocity
            and self.hasOnset == other.hasOnset
            and self.hasOffset == other.hasOffset
        )


def _sort_key(n: Note):
    return (n.start, n.end, n.pitch)


class ControlChange:
    """Minimal CC record: (number, value, time)."""

    __slots__ = ("number", "value", "time")

    def __init__(self, number, value, time):
        self.number = number
        self.value = value
        self.time = time

    def __repr__(self):
        return f"CC({self.number}, {self.value}, {self.time})"


def parse_control_change_switch(
    cc_seq: Sequence[ControlChange],
    control_number: int,
    on_threshold: int = 64,
    end_t: Optional[float] = None,
) -> List[Note]:
    """CC stream -> on/off interval events at the on/off threshold
    (ref ``Data.py:32-74``).  Pedal events carry velocity 127 and
    pitch = -control_number."""
    running = False
    events: List[Note] = []
    current: Optional[Note] = None
    time = 0.0
    for c in cc_seq:
        status = running
        if c.number == control_number:
            time = c.time
            status = c.value >= on_threshold
        if running != status:
            if status:
                current = Note(time, None, -control_number, 127)
            else:
                current.end = time
                # zero-length switch events (on/off at the same quantized
                # tick) are degenerate — drop them so downstream invariants
                # hold even for pathological inputs
                if current.end > current.start:
                    events.append(current)
        running = status
    if running and end_t is not None:
        current.end = max(end_t, time)
        if current.end > current.start:
            events.append(current)
    return events


def extend_pedal(note_events: List[Note], pedal_events: List[Note]) -> List[Note]:
    """Extend each note's offset to the release of the sustain pedal holding
    it; re-truncate on re-onset of the same pitch (ref ``Data.py:130-168``)."""
    note_events = sorted(note_events, key=_sort_key)
    pedal_events = sorted(pedal_events, key=_sort_key)
    out: List[Note] = []
    buffer_idx = {}
    n_in = len(note_events)
    for i, n in enumerate(note_events):
        if n.pitch in buffer_idx:
            prev = out[buffer_idx[n.pitch]]
            if prev.end > n.start:
                prev.end = n.start
        for pedal in pedal_events:
            if pedal.start < n.end < pedal.end:
                n.end = pedal.end
        buffer_idx[n.pitch] = i
        out.append(n)
    out.sort(key=_sort_key)
    assert len(out) == n_in
    out = resolve_overlapping(out)
    validate_notes(out)
    return out


def resolve_overlapping(note_events: List[Note]) -> List[Note]:
    """Truncate same-pitch overlaps at the next onset and drop zero-length
    notes (ref ``Data.py:170-215``)."""
    if len(note_events) > 512:
        return _resolve_overlapping_vec(note_events)
    return _resolve_overlapping_scalar(note_events)


def _resolve_overlapping_scalar(note_events: List[Note]) -> List[Note]:
    note_events = sorted(note_events, key=_sort_key)
    out: List[Note] = []
    buffer_idx = {}
    for i, n in enumerate(note_events):
        if n.pitch in buffer_idx:
            prev = out[buffer_idx[n.pitch]]
            if prev.end > n.start:
                prev.end = n.start
        buffer_idx[n.pitch] = i
        out.append(n)
    out.sort(key=_sort_key)
    out = [n for n in out if n.start < n.end]
    validate_notes(out)
    return out


def _resolve_overlapping_vec(note_events: List[Note]) -> List[Note]:
    """Vectorized ``resolve_overlapping``: identical semantics, but the sort,
    the same-pitch successor scan, the zero-length filter, and the validation
    run as numpy array ops — only the (rare) actual truncations touch Note
    objects.  O(n log n) array work instead of Python loops; matters at the
    end of ``TransKun.transcribe`` where dense pieces carry 10^3-10^4 events
    on a slow host."""
    import numpy as np

    n_ev = len(note_events)
    s = np.array([n.start for n in note_events], np.float64)
    e = np.array([n.end for n in note_events], np.float64)
    p = np.array([n.pitch for n in note_events], np.int64)
    order = np.lexsort((p, e, s))  # (start, end, pitch), ties stable
    s, e, p = s[order], e[order], p[order]
    # same-pitch successor in sorted order: stable sort by pitch keeps the
    # (start, end) order within each pitch group
    byp = np.lexsort((np.arange(n_ev), p))
    same = p[byp[1:]] == p[byp[:-1]]
    prev_i, next_i = byp[:-1][same], byp[1:][same]
    trunc = e[prev_i] > s[next_i]
    for pi, ni in zip(prev_i[trunc].tolist(), next_i[trunc].tolist()):
        note_events[order[pi]].end = s[ni]
        e[pi] = s[ni]
    keep = s < e
    # final order with the truncated ends
    out_order = np.lexsort((p[keep], e[keep], s[keep]))
    kept = order[keep]
    out = [note_events[i] for i in kept[out_order].tolist()]
    # validate (ref ``Data.py:218-227``): positive length is `keep` by
    # construction; per-pitch monotonicity on the final arrays
    sk, ek, pk = s[keep][out_order], e[keep][out_order], p[keep][out_order]
    byp = np.lexsort((np.arange(len(out)), pk))
    same = pk[byp[1:]] == pk[byp[:-1]]
    assert np.all(sk[byp[1:][same]] >= ek[byp[:-1][same]]), "overlap"
    return out


def validate_notes(notes: Sequence[Note]) -> None:
    """Per-pitch monotonicity and positive-length invariants
    (ref ``Data.py:218-227``)."""
    last = {}
    for n in notes:
        if n.pitch in last:
            assert n.start >= last[n.pitch].end, f"{n} overlaps {last[n.pitch]}"
        assert n.start < n.end, n
        last[n.pitch] = n


def parse_event_all(
    notes_list: Sequence[Note],
    cc_list: Sequence[ControlChange],
    supported_cc: Sequence[int] = (64, 66, 67),
    extend_sustain_pedal: bool = True,
    pedal_ext_offset: float = 0.0,
) -> List[Note]:
    """Notes + CC streams -> unified event list with pedal tracks and optional
    sustain-pedal note extension (ref ``Data.py:76-128``)."""
    notes_list = [n.copy() for n in notes_list]
    notes_list.sort(key=_sort_key)
    for n in notes_list:
        assert n.start < n.end
    last_t = max(n.end for n in notes_list)

    if extend_sustain_pedal:
        sustain = parse_control_change_switch(cc_list, 64, end_t=last_t)
        sustain.sort(key=_sort_key)
        if pedal_ext_offset != 0.0:
            for n in sustain:
                n.start += pedal_ext_offset
                n.end += pedal_ext_offset
        notes_list = extend_pedal(notes_list, sustain)
    else:
        notes_list = resolve_overlapping(notes_list)
    validate_notes(notes_list)

    event_seqs = [notes_list]
    for cc in supported_cc:
        event_seqs.append(parse_control_change_switch(cc_list, cc, end_t=last_t))
    events = [e for seq in event_seqs for e in seq]
    events.sort(key=_sort_key)
    return events


def create_index_events(event_list: Sequence[Note]):
    """Host-side interval index over events for range queries during data
    loading.  Replaces the reference's ncls dependency (``Data.py:231-248``)
    with a numpy sweep index: events sorted by start + running max of ends."""
    import numpy as np

    starts = np.array([e.start for e in event_list], np.float64)
    ends = np.array([e.end for e in event_list], np.float64)
    order = np.argsort(starts, kind="stable")
    starts_s = starts[order]
    ends_s = ends[order]
    max_end = np.maximum.accumulate(ends_s)
    return starts_s, ends_s, max_end, order


def query_interval(start: float, end: float, index) -> List[int]:
    """All events overlapping [start, end) — strict half-open overlap
    (s < end and e > start), matching the reference interval tree."""
    import numpy as np

    starts_s, ends_s, max_end, order = index
    hi = np.searchsorted(starts_s, end, side="left")
    res = []
    # walk backwards; prune once the running max end falls below `start`
    for i in range(hi - 1, -1, -1):
        if max_end[i] <= start:
            break
        if ends_s[i] > start:
            res.append(int(order[i]))
    res.reverse()
    return res
