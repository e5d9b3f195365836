"""Synthetic piano-like audio from a seed: decaying sine notes over low
noise, written note by note into slices (linear in length), rounded to the
int16 grid.  Also a MAESTRO-layout corpus (wav, MIDI, meta.csv) of such
pieces for training."""

from __future__ import annotations

import csv
import math
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

TICKS_PER_SECOND = 1920  # 960 ticks a beat at 500000 us a beat


def piece_lengths(spec: Dict, count: int) -> List[float]:
    """A fixed set of ``count`` lengths, whole seconds, at the midpoints of
    equal shares of [min, max]: the same for every seed."""
    lo, hi = spec["seconds_min"], spec["seconds_max"]
    return [float(round(lo + (hi - lo) * (i + 0.5) / count)) for i in range(count)]


def interleaved_order(lengths: List[float], rng: np.random.Generator) -> List[int]:
    """Shortest and longest alternately, rotated by the seed: any run of
    consecutive items mixes short and long ones."""
    idx = sorted(range(len(lengths)), key=lengths.__getitem__)
    order = []
    while idx:
        order.append(idx.pop(0))
        if idx:
            order.append(idx.pop())
    k = int(rng.integers(len(order)))
    return order[k:] + order[:k]


def draw_notes(seconds: float, spec: Dict, rng: np.random.Generator) -> List[Tuple[float, float, int, int]]:
    """(start, end, pitch, velocity) of a piece: onsets a random gap apart,
    random pitch and length; no two notes of a pitch overlap where the mix
    asks for it; times on the MIDI tick grid."""
    notes, t, busy = [], spec["first_onset_s"], {}
    p_lo, p_hi = spec["pitch"]
    d_lo, d_hi = spec["duration_s"]
    g_lo, g_hi = spec["gap_s"]
    v_lo, v_hi = spec["velocity"]
    while t < seconds - 1.0:
        pitch = int(rng.integers(p_lo, p_hi + 1))
        dur = float(rng.uniform(d_lo, d_hi))
        vel = int(rng.integers(v_lo, v_hi + 1))
        if spec["distinct_pitch_overlap"] and t < busy.get(pitch, 0.0):
            t += spec["retry_s"]
            continue
        s = round(t * TICKS_PER_SECOND) / TICKS_PER_SECOND
        e = round((t + dur) * TICKS_PER_SECOND) / TICKS_PER_SECOND
        busy[pitch] = e
        notes.append((s, e, pitch, vel))
        t += float(rng.uniform(g_lo, g_hi))
    return notes


def render(notes, seconds: float, fs: int, spec: Dict, rng: np.random.Generator) -> np.ndarray:
    """int16 samples of the notes over noise."""
    n = int(seconds * fs)
    x = rng.standard_normal(n, dtype=np.float32) * np.float32(spec["noise"])
    longest = int(math.ceil(spec["duration_s"][1] * fs)) + 2
    tt = np.arange(longest, dtype=np.float32) / np.float32(fs)
    env = np.exp(-np.float32(spec["decay"]) * tt).astype(np.float32)
    tables = {}
    for s, e, p, _ in notes:
        if p not in tables:
            f0 = 440.0 * 2.0 ** ((p - 69) / 12.0)
            tables[p] = (np.float32(spec["amplitude"]) * np.sin(2 * np.pi * f0 * tt) * env).astype(np.float32)
        a, b = int(s * fs), min(int(e * fs), n)
        x[a:b] += tables[p][:b - a]
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)


def pool(spec: Dict, fs: int, seed: int):
    """The traffic's items: (lengths in seconds, int16 waves, the order in
    which they are played)."""
    rng = np.random.default_rng(seed)
    lengths = piece_lengths(spec, spec["pool"])
    waves = [render(draw_notes(sec, spec["notes"], rng), sec, fs, spec["notes"], rng) for sec in lengths]
    return lengths, waves, interleaved_order(lengths, rng)


# -- a MAESTRO-layout corpus --------------------------------------------------


def _vlq(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def write_midi(notes, path: str) -> None:
    """A format-1 SMF, 960 ticks a beat at 120 bpm, piano notes only."""
    events = []
    for s, e, p, v in notes:
        events.append((round(s * TICKS_PER_SECOND), 1, bytes([0x90, p, v])))
        events.append((round(e * TICKS_PER_SECOND), 0, bytes([0x80, p, 0])))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    meta = _vlq(0) + b"\xff\x51\x03" + struct.pack(">I", 500000)[1:] + _vlq(0) + b"\xff\x2f\x00"
    body, last = bytearray(), 0
    for tick, _, msg in events:
        body += _vlq(tick - last) + msg
        last = tick
    body += _vlq(0) + b"\xff\x2f\x00"
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 1, 2, 960))
        for trk in (meta, bytes(body)):
            f.write(b"MTrk" + struct.pack(">I", len(trk)) + trk)


def write_corpus(root: str, spec: Dict, fs: int, seed: int):
    """Pieces of the spec's lengths (the training split) and one short
    validation piece as wav + MIDI + meta.csv under ``root``.  Returns
    (meta path, per training piece (notes, int16 wave))."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    lengths = piece_lengths(spec, spec["pool"])
    rows, pieces = [], []
    os.makedirs(os.path.join(root, "2020"), exist_ok=True)
    split = ["train"] * len(lengths) + ["validation"]
    for i, (sec, part) in enumerate(zip(lengths + [spec["validation_seconds"]], split)):
        notes = draw_notes(sec, spec["notes"], rng)
        wave = render(notes, sec, fs, spec["notes"], rng)
        wav, mid = f"2020/piece{i}.wav", f"2020/piece{i}.midi"
        wavfile.write(os.path.join(root, wav), fs, wave)
        write_midi(notes, os.path.join(root, mid))
        rows.append({"canonical_composer": "synthetic", "canonical_title": f"piece{i}", "split": part,
                     "year": "2020", "midi_filename": mid, "audio_filename": wav, "duration": sec})
        if part == "train":
            pieces.append((notes, wave))
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return meta, pieces
