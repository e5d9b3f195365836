"""Semi-Markov CRF decode: constants, the plain Viterbi tables and the host
pointer walk.

Port of the decode half of ``transkun_tpu/ops/semicrf.py``.  ``score[T, T, N]``
scores every closed interval in ``[end, begin, batch]`` layout (lower
triangle); the diagonal holds singleton scores, included in a decode iff
positive.  The padded decode-layout tables, which the CUDA kernel computes,
live in ``ops/viterbi.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .viterbi import viterbi_backward_tables_plain

# Large-negative instead of -inf: keeps masked lanes NaN-free.
NEG = -1e30

# Padding of the decode-layout score tensor: positions to a multiple of
# PALLAS_KP, lanes to a multiple of PALLAS_LN (the JAX package's block sizes,
# kept so both packages pad to the same shapes).
PALLAS_KP = 8
PALLAS_LN = 128


def viterbi_backward_tables(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-to-left Viterbi DP on unpadded ``score [T, T, N]`` (end, begin)
    and ``noise [T-1, N]``.

    Returns (ptr [T-1, N] int32, diag_pos [T, N] bool).  ``ptr[p]`` is the
    best move leaving ``p``: -1 = skip to p+1, s >= 0 = interval
    (p, p+1+s).  Skip wins ties; among intervals the smallest end wins.
    """
    t = score.shape[0]
    score = score.float()
    diag = torch.diagonal(score).transpose(0, 1)  # [T, N]
    # the same DP as the padded decode layout, with Tp = T: the noise row
    # T-1 is never read
    noise_t = torch.nn.functional.pad(noise.float(), (0, 0, 0, 1))
    ptr = viterbi_backward_tables_plain(
        score.transpose(0, 1), noise_t, diag * (diag > 0)
    )
    return ptr[: t - 1], diag > 0


def backtrack_backward(
    ptr: np.ndarray,
    diag_pos: np.ndarray,
    forced_start: Optional[Sequence[int]] = None,
) -> List[List[Tuple[int, int]]]:
    """Host pointer walk for the right-to-left DP (ref ``:61-104``).

    ``forced_start[b]`` pins the first visited frame of track b (carries the
    last confirmed offset across segments).  Default 0.
    """
    tm1, n = ptr.shape
    t = tm1 + 1
    if forced_start is None:
        forced_start = [0] * n
    results: List[List[Tuple[int, int]]] = []
    for b in range(n):
        j = int(forced_start[b])
        out: List[Tuple[int, int]] = []
        while j < t - 1:
            sel = int(ptr[j, b])
            if diag_pos[j, b]:
                out.append((j, j))
            if sel < 0:
                j += 1
            else:
                e = j + 1 + sel
                out.append((j, e))
                j = e
        if diag_pos[t - 1, b]:
            out.append((t - 1, t - 1))
        results.append(out)
    return results
