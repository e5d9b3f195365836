"""Note-level matching and precision/recall/F1, semantics of
mir_eval.transcription / transcription_velocity (reimplemented in-repo; the
environment has no mir_eval).  Maximum bipartite matching via scipy csgraph
(Hopcroft-Karp): matched cardinality — hence P/R/F — is identical to
mir_eval's matching; the specific matched pairs may differ on ties.

The port's own copy of ``transkun_tpu/eval/matching.py`` (numpy, scipy and the
standard library only) under the same names: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _max_bipartite_matching(
    pairs: List[Tuple[int, int]], n_ref: int, n_est: int
) -> List[Tuple[int, int]]:
    if not pairs:
        return []
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    rows = np.array([p[0] for p in pairs])
    cols = np.array([p[1] for p in pairs])
    graph = coo_matrix(
        (np.ones(len(pairs), np.int8), (rows, cols)), shape=(n_ref, n_est)
    ).tocsr()
    match = maximum_bipartite_matching(graph, perm_type="column")
    return [(i, int(match[i])) for i in range(n_ref) if match[i] != -1]


def match_notes(
    ref_intervals: np.ndarray,
    ref_pitches: np.ndarray,
    est_intervals: np.ndarray,
    est_pitches: np.ndarray,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05,
    strict: bool = False,
) -> List[Tuple[int, int]]:
    """Maximum matching of reference to estimated notes under onset / pitch /
    (optional) offset tolerances.  Pitches are in Hz; pitch tolerance in cents."""
    ref_intervals = np.asarray(ref_intervals, float).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, float).reshape(-1, 2)
    ref_pitches = np.asarray(ref_pitches, float)
    est_pitches = np.asarray(est_pitches, float)
    if len(ref_pitches) == 0 or len(est_pitches) == 0:
        return []
    cmp = np.less if strict else np.less_equal

    onset_dist = np.abs(ref_intervals[:, None, 0] - est_intervals[None, :, 0])
    onset_hit = cmp(onset_dist, onset_tolerance)
    pitch_dist = 1200.0 * np.abs(
        np.log2(est_pitches[None, :]) - np.log2(ref_pitches[:, None])
    )
    pitch_hit = cmp(pitch_dist, pitch_tolerance)
    hits = onset_hit & pitch_hit
    if offset_ratio is not None:
        ref_dur = ref_intervals[:, 1] - ref_intervals[:, 0]
        offset_tol = np.maximum(offset_ratio * ref_dur, offset_min_tolerance)
        offset_dist = np.abs(ref_intervals[:, None, 1] - est_intervals[None, :, 1])
        hits &= cmp(offset_dist, offset_tol[:, None])

    pairs = list(zip(*np.nonzero(hits)))
    return _max_bipartite_matching(
        [(int(a), int(b)) for a, b in pairs], len(ref_pitches), len(est_pitches)
    )


def precision_recall_f1_overlap(
    ref_intervals,
    ref_pitches,
    est_intervals,
    est_pitches,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05,
    strict: bool = False,
) -> Tuple[float, float, float, float]:
    """(precision, recall, f1, average overlap ratio of matched pairs)."""
    ref_intervals = np.asarray(ref_intervals, float).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, float).reshape(-1, 2)
    if len(ref_intervals) == 0 or len(est_intervals) == 0:
        return 0.0, 0.0, 0.0, 0.0
    matched = match_notes(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        onset_tolerance, pitch_tolerance, offset_ratio, offset_min_tolerance,
        strict,
    )
    precision = len(matched) / len(est_intervals)
    recall = len(matched) / len(ref_intervals)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    if matched:
        ratios = []
        for i, j in matched:
            lo = max(ref_intervals[i, 0], est_intervals[j, 0])
            hi = min(ref_intervals[i, 1], est_intervals[j, 1])
            lo2 = min(ref_intervals[i, 0], est_intervals[j, 0])
            hi2 = max(ref_intervals[i, 1], est_intervals[j, 1])
            ratios.append((hi - lo) / (hi2 - lo2) if hi2 > lo2 else 0.0)
        avg_overlap = float(np.mean(ratios))
    else:
        avg_overlap = 0.0
    return precision, recall, f1, avg_overlap


def match_notes_with_velocity(
    ref_intervals,
    ref_pitches,
    ref_velocities,
    est_intervals,
    est_pitches,
    est_velocities,
    velocity_tolerance: float = 0.1,
    **kwargs,
) -> List[Tuple[int, int]]:
    """Velocity-aware matching (mir_eval.transcription_velocity semantics):
    match ignoring velocity, least-squares rescale estimated velocities onto
    the reference over the matched pairs, normalize by the max matched
    reference velocity, then keep pairs within ``velocity_tolerance``."""
    matched = match_notes(
        ref_intervals, ref_pitches, est_intervals, est_pitches, **kwargs
    )
    if not matched:
        return []
    ref_v = np.asarray(ref_velocities, float)[[m[0] for m in matched]]
    est_v = np.asarray(est_velocities, float)[[m[1] for m in matched]]
    # least-squares slope/intercept of est -> ref
    a = np.vstack([est_v, np.ones_like(est_v)]).T
    coef, *_ = np.linalg.lstsq(a, ref_v, rcond=None)
    est_scaled = a @ coef
    norm = ref_v.max() if ref_v.max() > 0 else 1.0
    ok = np.abs(est_scaled - ref_v) / norm <= velocity_tolerance
    return [m for m, keep in zip(matched, ok) if keep]


def precision_recall_f1_overlap_velocity(
    ref_intervals,
    ref_pitches,
    ref_velocities,
    est_intervals,
    est_pitches,
    est_velocities,
    velocity_tolerance: float = 0.1,
    **kwargs,
) -> Tuple[float, float, float, float]:
    ref_intervals = np.asarray(ref_intervals, float).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, float).reshape(-1, 2)
    if len(ref_intervals) == 0 or len(est_intervals) == 0:
        return 0.0, 0.0, 0.0, 0.0
    matched = match_notes_with_velocity(
        ref_intervals, ref_pitches, ref_velocities,
        est_intervals, est_pitches, est_velocities,
        velocity_tolerance, **kwargs,
    )
    precision = len(matched) / len(est_intervals)
    recall = len(matched) / len(ref_intervals)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    if matched:
        ratios = []
        for i, j in matched:
            lo = max(ref_intervals[i, 0], est_intervals[j, 0])
            hi = min(ref_intervals[i, 1], est_intervals[j, 1])
            lo2 = min(ref_intervals[i, 0], est_intervals[j, 0])
            hi2 = max(ref_intervals[i, 1], est_intervals[j, 1])
            ratios.append((hi - lo) / (hi2 - lo2) if hi2 > lo2 else 0.0)
        avg_overlap = float(np.mean(ratios))
    else:
        avg_overlap = 0.0
    return precision, recall, f1, avg_overlap
