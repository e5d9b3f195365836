"""Label encoding: notes -> per-pitch-track interval/attribute targets.

Counterpart of the reference ``prepareIntervals`` (``transkun/Data.py:1031-1112``)
plus a padded, static-shape tensorization so the training loss is a fully
regular masked computation on device (no ragged gathers, no recompiles).

The port's own copy of ``transkun_tpu/data/labels.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .note import Note, validate_notes


def prepare_intervals(
    notes: Sequence[Note], hop_size_in_second: float, target_pitch: Sequence[int]
) -> Dict[str, list]:
    """Quantize each note's endpoints to the frame grid by rounding, keeping
    the fractional residuals (in [-0.5, 0.5] frames) as refinement targets and
    the (hasOnset, hasOffset) flags as presence targets.  Notes colliding on
    the quantized grid are merged (ref ``Data.py:1079-1091``)."""
    validate_notes(notes)
    tracks = defaultdict(list)
    for n in notes:
        tracks[n.pitch].append(n)

    intervals_all, velocity_all, refine_all, presence_all = [], [], [], []
    for p in target_pitch:
        intervals, refine, presence, velocity = [], [], [], []
        for n in tracks[p]:
            assert n.start >= 0, n.start
            assert n.end >= 0, n.end
            sq = int(round(n.start / hop_size_in_second))
            eq = int(round(n.end / hop_size_in_second))
            sr = n.start / hop_size_in_second - sq
            er = n.end / hop_size_in_second - eq
            if len(intervals) > 0 and (
                sq < intervals[-1][1]
                or (eq == intervals[-1][1] and intervals[-1][0] == sq)
            ):
                # two notes quantized into the same frame cannot be separated
                # by the interval representation: merge, keep first velocity
                intervals[-1] = (intervals[-1][0], eq)
                refine[-1] = (refine[-1][0], er)
                presence[-1] = (presence[-1][0], n.hasOffset)
            else:
                intervals.append((sq, eq))
                refine.append((sr, er))
                presence.append((n.hasOnset, n.hasOffset))
                velocity.append(n.velocity)
        intervals_all.append(intervals)
        refine_all.append(refine)
        presence_all.append(presence)
        velocity_all.append(velocity)

    return {
        "intervals": intervals_all,
        "endPointRefine": refine_all,
        "endPointPresence": presence_all,
        "velocity": velocity_all,
    }


def prepare_intervals_no_quantize(
    notes: Sequence[Note], target_pitch: Sequence[int]
) -> Dict[str, list]:
    """Continuous-time variant used by framewise evaluation
    (ref ``Data.py:977-1029``)."""
    validate_notes(notes)
    tracks = defaultdict(list)
    for n in notes:
        tracks[n.pitch].append(n)
    intervals_all, velocity_all, refine_all = [], [], []
    for p in target_pitch:
        intervals, refine, velocity = [], [], []
        for n in tracks[p]:
            assert n.start >= 0 and n.end >= 0
            intervals.append((n.start, n.end))
            refine.append((0, 0))
            velocity.append(n.velocity)
        intervals_all.append(intervals)
        refine_all.append(refine)
        velocity_all.append(velocity)
    return {
        "intervals": intervals_all,
        "endPointRefine": refine_all,
        "velocity": velocity_all,
    }


class PaddedLabels:
    """Static-shape label tensors for one batch: everything is [N, P, K]."""

    __slots__ = ("begins", "ends", "mask", "velocity", "refine", "presence")

    def __init__(self, begins, ends, mask, velocity, refine, presence):
        self.begins = begins
        self.ends = ends
        self.mask = mask
        self.velocity = velocity
        self.refine = refine
        self.presence = presence

    def astuple(self):
        return (
            self.begins,
            self.ends,
            self.mask,
            self.velocity,
            self.refine,
            self.presence,
        )


def encode_batch(
    notes_batch: Sequence[Sequence[Note]],
    hop_size_in_second: float,
    target_pitch: Sequence[int],
    max_events: int = 32,
    k_sync=None,
) -> PaddedLabels:
    """Encode a batch of note lists into padded [N, P, K] label tensors.

    K (``max_events``) bounds events per pitch track per chunk; 32 covers a
    16 s chunk with a same-pitch repetition rate of 2 notes/s with margin.
    A denser chunk (pedal CC storm, fast trill) AUTO-GROWS K to the next
    multiple of 16 instead of failing mid-epoch; the grown shape costs one
    extra XLA compile of the train step per bucket, which is why growth is
    bucketed rather than exact.

    ``k_sync``: in MULTI-PROCESS training the grown K must agree across
    processes — each process sees different chunks, and a K that differs by
    rank gives the SPMD step inconsistent global shapes (a crash or
    collective hang, not an error message).  Pass a callable mapping the
    local densest-track count to the global one (e.g. an allgather-max over
    processes; ``cli/train.py`` wires ``multihost_utils.process_allgather``);
    every process then grows to the same bucket.  ``None`` (single-process)
    uses the local count directly.
    """
    n = len(notes_batch)
    p = len(target_pitch)
    per_item = [
        prepare_intervals(notes, hop_size_in_second, target_pitch)
        for notes in notes_batch
    ]
    densest = max(
        (len(ivs) for data in per_item for ivs in data["intervals"]), default=0
    )
    if k_sync is not None:
        densest = int(k_sync(densest))
    k = max_events
    if densest > k:
        k = -(-densest // 16) * 16  # next multiple of 16
        import warnings

        warnings.warn(
            f"a chunk holds {densest} events on one pitch track > "
            f"max_events={max_events}; growing K to {k} (one extra train-step "
            "compile per bucket)",
            stacklevel=2,
        )
    begins = np.zeros((n, p, k), np.int32)
    ends = np.zeros((n, p, k), np.int32)
    mask = np.zeros((n, p, k), bool)
    velocity = np.zeros((n, p, k), np.int32)
    refine = np.zeros((n, p, k, 2), np.float32)
    presence = np.zeros((n, p, k, 2), np.float32)

    for i, data in enumerate(per_item):
        for j in range(p):
            ivs = data["intervals"][j]
            for e_idx, (b, e) in enumerate(ivs):
                begins[i, j, e_idx] = b
                ends[i, j, e_idx] = e
                mask[i, j, e_idx] = True
                velocity[i, j, e_idx] = data["velocity"][j][e_idx]
                refine[i, j, e_idx] = data["endPointRefine"][j][e_idx]
                presence[i, j, e_idx] = data["endPointPresence"][j][e_idx]

    return PaddedLabels(begins, ends, mask, velocity, refine, presence)
