"""Standard MIDI file IO in pure Python (no pretty_midi dependency).

Covers what the framework needs end to end: reading single-instrument piano
MIDI (notes + control changes, tempo-map-aware tick->seconds conversion) for
dataset construction and evaluation, and writing transcription output
(ref ``transkun/Data.py:427-454``: notes as note on/off, pedals as CC on/off
pairs at velocity 127/0, Acoustic Grand Piano).

The port's own copy of ``transkun_tpu/data/midi.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from .note import ControlChange, Note, validate_notes

DEFAULT_TEMPO = 500000  # microseconds per quarter note (120 bpm)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _var_len(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _track_chunk(events: List[Tuple[int, bytes]]) -> bytes:
    events.sort(key=lambda e: e[0])
    data = bytearray()
    last = 0
    for tick, payload in events:
        data += _var_len(tick - last)
        data += payload
        last = tick
    data += _var_len(0) + b"\xff\x2f\x00"  # end of track
    return b"MTrk" + struct.pack(">I", len(data)) + bytes(data)


def write_midi(
    notes: Sequence[Note], path: str, resolution: int = 960, program: int = 0
) -> None:
    """Write notes/pedals to a format-1 SMF (ref ``writeMidi``)."""
    validate_notes(list(notes))
    ticks_per_sec = resolution * 1e6 / DEFAULT_TEMPO

    def t2k(t: float) -> int:
        return max(0, int(round(t * ticks_per_sec)))

    meta_events = [
        (0, b"\xff\x51\x03" + struct.pack(">I", DEFAULT_TEMPO)[1:]),  # tempo
        (0, b"\xff\x58\x04\x04\x02\x18\x08"),  # 4/4 time signature
    ]
    events: List[Tuple[int, bytes]] = [(0, bytes([0xC0, program]))]
    for n in notes:
        if n.pitch > 0:
            v = int(max(1, min(127, n.velocity)))
            events.append((t2k(n.start), bytes([0x90, int(n.pitch), v])))
            events.append((t2k(n.end), bytes([0x80, int(n.pitch), 0])))
        else:
            cc = -int(n.pitch)
            events.append((t2k(n.start), bytes([0xB0, cc, int(min(127, n.velocity))])))
            events.append((t2k(n.end), bytes([0xB0, cc, 0])))

    header = b"MThd" + struct.pack(">IHHH", 6, 1, 2, resolution)
    with open(path, "wb") as f:
        f.write(header)
        f.write(_track_chunk(meta_events))
        f.write(_track_chunk(events))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def var_len(self) -> int:
        v = 0
        while True:
            b = self.u8()
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                return v

    def eof(self) -> bool:
        return self.pos >= len(self.data)


class MidiFile:
    """Parsed MIDI: merged-track note/CC lists with absolute times in seconds."""

    def __init__(self, notes: List[Note], control_changes: List[ControlChange]):
        self.notes = notes
        self.control_changes = control_changes


def read_midi(path: str) -> MidiFile:
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    assert r.read(4) == b"MThd", "not a MIDI file"
    hlen = struct.unpack(">I", r.read(4))[0]
    fmt, n_tracks, division = struct.unpack(">HHH", r.read(6))
    r.read(hlen - 6)
    assert division & 0x8000 == 0, "SMPTE time division unsupported"

    # pass 1: collect raw (tick, kind, ...) events from all tracks
    tempo_events: List[Tuple[int, int]] = [(0, DEFAULT_TEMPO)]
    raw: List[Tuple[int, int, Tuple]] = []  # (tick, order, payload)
    order = 0
    for _ in range(n_tracks):
        assert r.read(4) == b"MTrk"
        tlen = struct.unpack(">I", r.read(4))[0]
        tr = _Reader(r.read(tlen))
        tick = 0
        status = 0
        while not tr.eof():
            tick += tr.var_len()
            b = tr.u8()
            if b == 0xFF:
                meta = tr.u8()
                length = tr.var_len()
                payload = tr.read(length)
                if meta == 0x51:
                    tempo_events.append(
                        (tick, int.from_bytes(payload, "big"))
                    )
                continue
            if b in (0xF0, 0xF7):  # sysex
                length = tr.var_len()
                tr.read(length)
                continue
            if b & 0x80:
                status = b
                d1 = tr.u8()
            else:
                d1 = b
            kind = status & 0xF0
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d2 = tr.u8()
            elif kind in (0xC0, 0xD0):
                d2 = 0
            else:
                continue
            raw.append((tick, order, (kind, status & 0x0F, d1, d2)))
            order += 1

    # tempo map: tick -> seconds
    tempo_events.sort()
    seg_ticks = [t for t, _ in tempo_events]
    seg_secs = [0.0]
    for i in range(1, len(tempo_events)):
        dt = seg_ticks[i] - seg_ticks[i - 1]
        seg_secs.append(seg_secs[-1] + dt * tempo_events[i - 1][1] / 1e6 / division)

    import bisect

    def tick2sec(tick: int) -> float:
        i = bisect.bisect_right(seg_ticks, tick) - 1
        return seg_secs[i] + (tick - seg_ticks[i]) * tempo_events[i][1] / 1e6 / division

    raw.sort(key=lambda e: (e[0], e[1]))
    end_tick = raw[-1][0] if raw else 0
    notes: List[Note] = []
    ccs: List[ControlChange] = []
    open_notes = {}  # (channel, pitch) -> list of (start_tick, velocity)
    for tick, _, (kind, ch, d1, d2) in raw:
        if kind == 0x90 and d2 > 0:
            open_notes.setdefault((ch, d1), []).append((tick, d2))
        elif kind == 0x80 or (kind == 0x90 and d2 == 0):
            key = (ch, d1)
            remaining = []
            for start_tick, vel in open_notes.get(key, []):
                if start_tick == tick:
                    remaining.append((start_tick, vel))
                else:
                    notes.append(
                        Note(tick2sec(start_tick), tick2sec(tick), d1, vel)
                    )
            if remaining:
                open_notes[key] = remaining
            elif key in open_notes:
                del open_notes[key]
        elif kind == 0xB0:
            ccs.append(ControlChange(d1, d2, tick2sec(tick)))

    # dangling note-ons (no matching note-off) are held to the end of the
    # file, pretty_midi-style, instead of being silently dropped
    for (_ch, pitch), opens in open_notes.items():
        for start_tick, vel in opens:
            if start_tick < end_tick:
                notes.append(
                    Note(tick2sec(start_tick), tick2sec(end_tick), pitch, vel)
                )
    notes.sort(key=lambda n: (n.start, n.end, n.pitch))
    ccs.sort(key=lambda c: c.time)
    return MidiFile(notes, ccs)
