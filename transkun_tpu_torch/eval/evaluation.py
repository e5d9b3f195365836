"""Transcription comparison metrics (counterpart of
``transkun/Evaluation.py``): set-based bracket comparison, interval-
intersection framewise comparison, and the full note/pedal metric dictionary.

The port's own copy of ``transkun_tpu/eval/evaluation.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.labels import prepare_intervals_no_quantize
from ..data.note import Note
from . import matching


def compare_bracket(interval_est, interval_gt) -> Tuple[int, int, int]:
    """Exact-interval set comparison (ref ``Evaluation.py:10-18``)."""
    n_gt = len(interval_gt)
    n_est = len(interval_est)
    union = set(tuple(i) for i in list(interval_est) + list(interval_gt))
    return n_gt, n_est, n_gt + n_est - len(union)


def _intersect_interval_lists(a, b):
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi >= lo:
            if out and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi)
            else:
                out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _interval_length_sum(intervals, count_zero=True):
    s = 0
    if count_zero:
        prev_end = -1
        for e in intervals:
            s += e[1] - e[0]
            if prev_end < e[0]:
                s += 1
            prev_end = e[1]
    else:
        for e in intervals:
            s += e[1] - e[0]
    return s


def compare_framewise(interval_est, interval_gt, count_zero=True):
    """(nGT, nEst, nIntersected) by interval intersection
    (ref ``Evaluation.py:67-74``)."""
    n_est = _interval_length_sum(interval_est, count_zero)
    n_gt = _interval_length_sum(interval_gt, count_zero)
    inter = _intersect_interval_lists(interval_est, interval_gt)
    return n_gt, n_est, _interval_length_sum(inter, count_zero)


def midi_to_freq(midi: int) -> float:
    """MIDI -> Hz; pedals (negative pitch) are shifted far out of the piano
    range (x100) so they never collide in pitch matching
    (ref ``Evaluation.py:79-85``)."""
    if midi >= 0:
        return 2 ** ((midi - 69) / 12) * 440
    return 2 ** ((-midi - 69) / 12) * 440 * 100


def compute_frame_score(estimated, gt, event_types):
    """Continuous framewise (activation-level) P/R/F/overlap
    (ref ``Evaluation.py:91-128``)."""
    ia = prepare_intervals_no_quantize(estimated, event_types)["intervals"]
    ib = prepare_intervals_no_quantize(gt, event_types)["intervals"]
    n_gt = n_est = n_correct = 0.0
    for a, b in zip(ia, ib):
        g, e, c = compare_framewise(a, b, count_zero=False)
        n_gt += g
        n_est += e
        n_correct += c
    p = n_correct / (n_est + 1e-8)
    r = n_correct / (n_gt + 1e-8)
    f = 2 * n_correct / (n_est + n_gt + 1e-8)
    o = n_correct / (n_est + n_gt - n_correct + 1e-8)
    return p, r, f, o


def prepare_data_for_evaluation(
    notes: Sequence[Note], cc_list=(64, 67), split_pedal: bool = False
):
    """Notes -> (intervals, pitches(Hz), velocities) arrays + per-pedal dicts
    (ref ``Evaluation.py:296-346``)."""
    notes = [n for n in notes if -n.pitch in cc_list or n.pitch >= 0]
    sel = [n for n in notes if n.pitch >= 0] if split_pedal else notes
    intervals = np.array([[n.start, n.end] for n in sel]).reshape(-1, 2)
    pitches = np.array([midi_to_freq(n.pitch) for n in sel])
    pitches_midi = np.array([n.pitch for n in sel])
    velocities = np.array([n.velocity for n in sel])

    pedals = {}
    for cc in cc_list:
        ped = [n for n in notes if n.pitch == -cc]
        pedals[cc] = {
            "intervals": np.array([[n.start, n.end] for n in ped]).reshape(-1, 2),
            "pitches": np.array([1.0 for _ in ped]),
            "velocities": np.array([n.velocity for n in ped]),
        }
    return (
        {
            "intervals": intervals,
            "pitches": pitches,
            "pitches_midi": pitches_midi,
            "velocities": velocities,
        },
        pedals,
    )


def compare_transcription(
    estimated: Sequence[Note],
    gt: Sequence[Note],
    split_pedal: bool = False,
    compute_deviations: bool = False,
    **kwargs,
) -> Dict:
    """The full metric dictionary: frame / note / note+velocity / note+offset
    / note+offset+velocity, per-pedal metrics, optional matched deviations
    (ref ``compareTranscription``, ``Evaluation.py:160-290``)."""
    result_est, pedal_est = prepare_data_for_evaluation(estimated, split_pedal=split_pedal)
    result_gt, pedal_gt = prepare_data_for_evaluation(gt, split_pedal=split_pedal)

    metrics: Dict = {}
    metrics["frame"] = compute_frame_score(estimated, gt, list(range(21, 109)))

    n_gt = result_gt["intervals"].shape[0]
    n_est = result_est["intervals"].shape[0]

    metrics["note"] = matching.precision_recall_f1_overlap(
        result_gt["intervals"], result_gt["pitches"],
        result_est["intervals"], result_est["pitches"],
        offset_ratio=None, **kwargs,
    )
    metrics["note+velocity"] = matching.precision_recall_f1_overlap_velocity(
        result_gt["intervals"], result_gt["pitches"], result_gt["velocities"],
        result_est["intervals"], result_est["pitches"], result_est["velocities"],
        offset_ratio=None, **kwargs,
    )
    metrics["note+offset"] = matching.precision_recall_f1_overlap(
        result_gt["intervals"], result_gt["pitches"],
        result_est["intervals"], result_est["pitches"],
        **kwargs,
    )
    metrics["note+velocity+offset"] = matching.precision_recall_f1_overlap_velocity(
        result_gt["intervals"], result_gt["pitches"], result_gt["velocities"],
        result_est["intervals"], result_est["pitches"], result_est["velocities"],
        **kwargs,
    )
    metrics["nGT"] = n_gt
    metrics["nEst"] = n_est

    if compute_deviations:
        matched = matching.match_notes(
            result_gt["intervals"], result_gt["pitches"],
            result_est["intervals"], result_est["pitches"],
            onset_tolerance=0.8, offset_min_tolerance=0.8,
        )
        deviations = []
        for i_gt, i_est in matched:
            diff = result_gt["intervals"][i_gt] - result_est["intervals"][i_est]
            deviations.append([int(result_est["pitches_midi"][i_est])] + diff.tolist())
        metrics["deviations"] = deviations

    if len(pedal_est) > 0:
        for cc in pedal_est:
            cur_est = pedal_est[cc]
            cur_gt = pedal_gt[cc]
            n_gt_pedal = cur_gt["intervals"].shape[0]
            if n_gt_pedal > 0:
                metrics[f"pedal{cc}frame"] = compute_frame_score(
                    estimated, gt, event_types=[-cc]
                )
                metrics[f"pedal{cc}"] = matching.precision_recall_f1_overlap(
                    cur_gt["intervals"], cur_gt["pitches"],
                    cur_est["intervals"], cur_est["pitches"],
                    offset_ratio=None, **kwargs,
                )
                metrics[f"pedal{cc}+offset"] = matching.precision_recall_f1_overlap(
                    cur_gt["intervals"], cur_gt["pitches"],
                    cur_est["intervals"], cur_est["pitches"],
                    **kwargs,
                )
                metrics[f"pedal{cc}nGT"] = n_gt_pedal
                metrics[f"pedal{cc}nEst"] = cur_est["intervals"].shape[0]

    return metrics
