"""Plain semi-CRF over interval scores, in PyTorch and NumPy.

Scores are ``S [T, T, L]`` in ``[end, begin, lane]`` order (the lower
triangle, ``begin <= end``, is read) and a skip score ``noise [T-1, L]``
for each step that no interval covers.  A singleton ``(t, t)`` enters the
partition function as ``softplus(S[t, t])``: it is either present or not.

Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def log_z(score: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """log partition function [L] by the forward recursion, differentiable
    by autograd.  ``score [T, T, L]``, ``noise [T-1, L]``."""
    t = score.shape[0]
    diag = torch.diagonal(score).t()  # [T, L]
    sp = F.softplus(diag)
    alphas = [sp[0]]
    for i in range(1, t):
        prev = torch.stack(alphas)  # [i, L]
        through = torch.logsumexp(prev + score[i, :i], dim=0)
        skip = alphas[-1] + noise[i - 1]
        alphas.append(torch.logaddexp(skip, through) + sp[i])
    return alphas[-1]


def path_score(score: torch.Tensor, noise: torch.Tensor, begins: torch.Tensor,
               ends: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Score of a set of intervals on each lane: the intervals' scores plus
    the skip scores of the steps they leave uncovered.  ``begins``,
    ``ends``, ``mask`` [L, K]."""
    t, _, lanes = score.shape
    zero = noise.new_zeros(1, lanes)
    ncum = torch.cat([zero, noise.cumsum(0)])  # [T, L]
    b, e = begins.long(), ends.long()
    lane = torch.arange(lanes, device=score.device)[:, None].expand_as(b)
    vals = score[e, b, lane]
    covered = ncum[e, lane] - ncum[b, lane]
    return torch.where(mask, vals - covered, torch.zeros_like(vals)).sum(1) + ncum[-1]


def viterbi_backward(score_be: torch.Tensor, noise: torch.Tensor,
                     diag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-to-left max recursion on ``score_be [T, T, L]`` in ``[begin,
    end, lane]`` order, ``noise [T-1, L]`` and the singleton scores ``diag
    [T, L]`` (a singleton is taken where its score is positive).

    Returns (ptr [T-1, L] int64: the move leaving each step, -1 a skip, e
    an interval to the end e; present [T, L] bool: the singletons taken).
    A skip wins a tie with an interval; among intervals the nearest end
    wins."""
    t, _, lanes = score_be.shape
    dev = score_be.device
    gain = torch.clamp(diag, min=0.0)
    best_to_end = torch.empty(t, lanes, dtype=torch.float32, device=dev)
    ptr = torch.empty(t - 1, lanes, dtype=torch.int64, device=dev)
    best_to_end[t - 1] = gain[t - 1]
    for p in range(t - 2, -1, -1):
        cand = best_to_end[p + 1:] + score_be[p, p + 1:]  # [T-1-p, L], ends p+1..T-1
        best, arg = cand.max(dim=0)
        # torch.max returns the first maximal index: the nearest end
        skip = best_to_end[p + 1] + noise[p]
        ptr[p] = torch.where(skip >= best, torch.full_like(arg, -1), arg + p + 1)
        best_to_end[p] = torch.maximum(skip, best) + gain[p]
    return ptr, diag > 0


def walk(ptr: np.ndarray, present: np.ndarray, start: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Intervals of each lane from ``start[lane]`` on, following the
    pointers: a taken singleton at a visited step, then the move."""
    tm1, lanes = ptr.shape
    t = tm1 + 1
    lane_ids = np.arange(lanes)
    pos = np.asarray(start, np.int64).copy()
    found = []  # (lane, order, begin, end) arrays, every lane stepping at once
    step = 0
    while True:
        active = pos < t - 1
        if not active.any():
            break
        j = np.minimum(pos, t - 2)
        single = active & present[j, lane_ids]
        move = ptr[j, lane_ids]
        interval = active & (move >= 0)
        found.append((lane_ids[single], np.full(single.sum(), 2 * step), j[single], j[single]))
        found.append((lane_ids[interval], np.full(interval.sum(), 2 * step + 1), j[interval],
                      move[interval]))
        pos = np.where(active, np.where(move < 0, j + 1, move), pos)
        step += 1
    last = present[t - 1]
    found.append((lane_ids[last], np.full(last.sum(), 2 * step), np.full(last.sum(), t - 1),
                  np.full(last.sum(), t - 1)))
    lane_a, order, b, e = (np.concatenate(a) for a in zip(*found))
    sort = np.lexsort((order, lane_a))
    out: List[List[Tuple[int, int]]] = [[] for _ in range(lanes)]
    for lane, bb, ee in zip(lane_a[sort].tolist(), b[sort].tolist(), e[sort].tolist()):
        out[lane].append((bb, ee))
    return out


def interval_arrays(tracks: Sequence[Sequence[Tuple[int, int]]], k: int = 0):
    """Ragged interval lists -> (begins, ends, mask) [L, K] numpy arrays."""
    k = max(k, max((len(c) for c in tracks), default=0), 1)
    begins = np.zeros((len(tracks), k), np.int64)
    ends = np.zeros((len(tracks), k), np.int64)
    mask = np.zeros((len(tracks), k), bool)
    for i, c in enumerate(tracks):
        for j, (b, e) in enumerate(c):
            begins[i, j], ends[i, j], mask[i, j] = b, e, True
    return begins, ends, mask
