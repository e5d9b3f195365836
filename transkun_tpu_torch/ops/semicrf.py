"""Semi-Markov CRF over time intervals: partition function with its exact
marginals, path scores, Viterbi tables and the host pointer walk.

Port of ``transkun_tpu/ops/semicrf.py``.  ``score[T, T, N]`` scores every
closed interval in ``[end, begin, batch]`` layout (lower triangle); the
diagonal holds singleton scores, marginalized through ``softplus`` in logZ
and included in a decode iff positive.  ``noise[T-1, N]`` scores the skip
t -> t+1.  The partition recursion is

    v[i] = logaddexp(v[i-1] + noise[i-1], logsumexp_{j<i} v[j] + S[i,j])
           + softplus(S[i,i])

Everything here is plain PyTorch and is the test oracle.  The padded tables
that the CUDA kernels compute live in ``ops/logz.py`` (alpha and beta, for
training) and ``ops/viterbi.py`` (decode); ``viterbi_backward_tables`` pads
and transposes onto the latter, so on a CUDA tensor it runs the kernel.
``log_z_best`` and ``viterbi_backward_tables_best`` (the V1 model's routes,
with a learned noise) pick by the tensor's device: the kernels on the card,
the plain routes on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .viterbi import viterbi_backward_tables_padded

# Large-negative instead of -inf: keeps masked lanes NaN-free.
NEG = -1e30

# Padding of the decode-layout score tensor: positions to a multiple of
# PALLAS_KP, lanes to a multiple of PALLAS_LN (the JAX package's block sizes,
# kept so both packages pad to the same shapes).
PALLAS_KP = 8
PALLAS_LN = 128


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _diag(score: torch.Tensor) -> torch.Tensor:
    """Diagonal of score[T, T, N] -> [T, N]."""
    return torch.diagonal(score).transpose(0, 1)


def _logsumexp_rows(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over axis 0, max-shifted, with the ``+1e-38`` before the log
    that the JAX package's scan and kernels add."""
    m = x.max(dim=0).values
    return m + torch.log(torch.exp(x - m).sum(dim=0) + 1e-38)


def _alpha_scan(score: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward (alpha) DP: score [T, T, N] (end, begin, batch), noise
    [T-1, N] -> the full table v [T, N]; logZ = v[-1].  Differentiable
    (``log_z_slow``): the in-place row writes touch no tensor a backward
    reads."""
    t, _, n = score.shape
    score = score.float()
    noise = noise.float()
    spdiag = torch.nn.functional.softplus(_diag(score))
    v = torch.zeros(t, n, dtype=torch.float32, device=score.device)
    v[0] = spdiag[0]
    for i in range(1, t):
        interval = _logsumexp_rows(v[:i] + score[i, :i])
        skip = v[i - 1] + noise[i - 1]
        v[i] = torch.logaddexp(skip, interval) + spdiag[i]
    return v


def _flip_score(score: torch.Tensor) -> torch.Tensor:
    """Time-reverse a score tensor: out[e, b] = score[T-1-b, T-1-e].  The
    forward recursion on the flipped tensor gives the backward (beta)
    quantities of the original."""
    return score.flip(0, 1).transpose(0, 1)


def _forward_backward(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha and beta in one scan over the doubled batch (the flip trick).
    Returns (logZ [N], v [T, N], q [T, N])."""
    score_fb = torch.cat([score, _flip_score(score)], dim=-1)
    noise_fb = torch.cat([noise, noise.flip(0)], dim=-1)
    v, q = _alpha_scan(score_fb, noise_fb).chunk(2, dim=-1)
    return v[-1], v, q.flip(0)


def _marginals(
    score: torch.Tensor, noise: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
    logz: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact posterior marginals, the gradient of logZ:

    grad[e, b]   = exp(v[b] + q[e] + S[e,b] - logZ - 2*softplus(S)[diag only])
                   on the lower triangle, 0 above it;
    gradNoise[i] = exp(v[i] + q[i+1] + noise[i] - logZ).

    One [T, T, N] buffer, built in place: nothing differentiates through
    this function."""
    t = score.shape[0]
    g = score.float() + v[None, :, :]
    g += q[:, None, :]
    g -= logz
    # softplus in the score's dtype, as the JAX package takes it here (a
    # bf16 score gives a bf16-rounded term; fp32 is unchanged)
    spdiag = torch.nn.functional.softplus(_diag(score)).float()
    torch.diagonal(g).sub_(2.0 * spdiag.t())
    upper = torch.ones(t, t, dtype=torch.bool, device=g.device).triu_(1)
    g.masked_fill_(upper[:, :, None], NEG).exp_()
    grad_noise = torch.exp(v[:-1] + q[1:] + noise.float() - logz)
    return g, grad_noise


class _LogZ(torch.autograd.Function):
    """logZ [N] whose backward is the exact marginals times the cotangent,
    without keeping the [T, T, N] marginals between the passes."""

    @staticmethod
    def forward(ctx, score, noise):
        logz, v, q = _forward_backward(score.detach(), noise.detach())
        ctx.save_for_backward(score, noise, v, q, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        score, noise, v, q, logz = ctx.saved_tensors
        grad, grad_noise = _marginals(score, noise, v, q, logz)
        return (grad * g).to(score.dtype), (grad_noise * g).to(noise.dtype)


def log_z(score: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Log partition function: [T, T, N], [T-1, N] -> [N], with the exact
    marginals as its gradient."""
    return _LogZ.apply(score, noise)


def log_z_slow(score: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """logZ by autograd through one forward scan (test oracle)."""
    return _alpha_scan(score, noise)[-1]


def marginals(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logZ [N], interval marginals [T, T, N], noise marginals [T-1, N])."""
    with torch.no_grad():
        logz, v, q = _forward_backward(score, noise)
        grad, grad_noise = _marginals(score, noise, v, q, logz)
    return logz, grad, grad_noise


# ---------------------------------------------------------------------------
# Path scoring
# ---------------------------------------------------------------------------


def eval_path_padded(
    score: torch.Tensor,
    noise: torch.Tensor,
    begins: torch.Tensor,
    ends: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Unnormalized score of interval sets: begins/ends [N, K] frame indices
    of closed intervals, mask [N, K] -> [N].  The sum of the interval scores
    plus the noise over the uncovered steps.  Gathers straight from the
    contiguous [T, T, N] tensor (no transposed copy)."""
    t, _, n = score.shape
    ncum = torch.cat(
        [torch.zeros(1, n, dtype=noise.dtype, device=noise.device), noise.cumsum(0)]
    )  # [T, N]
    b = begins.long().clamp(0, t - 1)
    e = ends.long().clamp(0, t - 1)
    lane = torch.arange(n, device=score.device)[:, None]
    vals = score.reshape(-1)[(e * t + b) * n + lane]
    ncum_t = ncum.t()
    span = torch.gather(ncum_t, 1, e) - torch.gather(ncum_t, 1, b)
    contrib = torch.where(mask.bool(), vals - span, torch.zeros_like(vals))
    return contrib.sum(1) + ncum[-1]


def eval_path_slow(
    intervals: Sequence[Sequence[Tuple[int, int]]], score: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Per-interval path scoring (ref ``evalPathSlow``), the readable oracle
    of ``eval_path_padded``."""
    ncum = torch.cat(
        [torch.zeros(1, noise.shape[1], dtype=noise.dtype, device=noise.device), noise.cumsum(0)]
    )
    out = []
    for idx, cur in enumerate(intervals):
        v = ncum[-1, idx]
        for b, e in cur:
            v = v + score[e, b, idx] - ncum[e, idx] + ncum[b, idx]
        out.append(v)
    return torch.stack(out, dim=-1)


def pad_intervals(
    intervals: Sequence[Sequence[Tuple[int, int]]], k: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged per-track interval lists -> padded (begins, ends, mask)
    [N, K]; K defaults to the next power of two of the longest track."""
    n = len(intervals)
    kmax = max((len(c) for c in intervals), default=0)
    if k is None:
        k = 1
        while k < max(kmax, 1):
            k *= 2
    if kmax > k:
        raise ValueError(f"a track holds {kmax} intervals, more than k={k}")
    begins = np.zeros((n, k), np.int32)
    ends = np.zeros((n, k), np.int32)
    mask = np.zeros((n, k), bool)
    for i, cur in enumerate(intervals):
        for j, (b, e) in enumerate(cur):
            begins[i, j] = b
            ends[i, j] = e
            mask[i, j] = True
    return begins, ends, mask


def eval_path(
    intervals: Sequence[Sequence[Tuple[int, int]]], score: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """List-of-lists form of ``eval_path_padded``."""
    begins, ends, mask = (
        torch.from_numpy(a).to(score.device) for a in pad_intervals(intervals)
    )
    return eval_path_padded(score, noise, begins, ends, mask)


# ---------------------------------------------------------------------------
# Viterbi: pointer tables on the device, walk on the host
# ---------------------------------------------------------------------------


def viterbi_backward_tables(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-to-left Viterbi DP on unpadded ``score [T, T, N]`` (end, begin)
    and ``noise [T-1, N]``.

    Returns (ptr [T-1, N] int32, diag_pos [T, N] bool).  ``ptr[p]`` is the
    best move leaving ``p``: -1 = skip to p+1, s >= 0 = interval
    (p, p+1+s).  Skip wins ties; among intervals the smallest end wins.

    Pads to the decode layout of ``viterbi_backward_tables_padded`` (NEG
    scores, zero noise, positions to a multiple of PALLAS_KP, lanes to a
    multiple of PALLAS_LN) and transposes to [begin, end, lane], so a CUDA
    tensor runs the kernel.  The padded DP is an exact extension: no
    interval touches the padding and padded skips weigh zero.  A bf16 score
    is padded and handed on as bf16 (the kernel upcasts as it reads); any
    other dtype goes through fp32.
    """
    t, _, n = score.shape
    s_t, noise_pad, gate = decode_layout(score, noise)
    ptr = viterbi_backward_tables_padded(s_t, noise_pad, gate)
    return ptr[: t - 1, :n], gate[:t, :n] > 0


def decode_layout(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unpadded ``score [T, T, N]`` (end, begin) and ``noise [T-1, N]`` ->
    the inputs of ``viterbi_backward_tables_padded``: (s_t [Tp, Tp, NBp]
    in [begin, end, lane] layout, NEG-padded, bf16 kept and any other dtype
    as fp32; noise [Tp, NBp] with zero rows from T-1; the gated diagonal
    [Tp, NBp] fp32)."""
    t, _, n = score.shape
    tp, nbp = _pad_to(t, PALLAS_KP), _pad_to(n, PALLAS_LN)
    if score.dtype != torch.bfloat16:
        score = score.float()
    diag = _diag(score).float()
    s_t = torch.full((tp, tp, nbp), NEG, dtype=score.dtype, device=score.device)
    s_t[:t, :t, :n] = score.transpose(0, 1)
    noise_pad = torch.zeros(tp, nbp, dtype=torch.float32, device=score.device)
    noise_pad[: t - 1, :n] = noise
    gate = torch.zeros(tp, nbp, dtype=torch.float32, device=score.device)
    gate[:t, :n] = diag * (diag > 0)
    return s_t, noise_pad, gate


def _check_kernel_device(score: torch.Tensor) -> None:
    if score.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no semi-CRF route for device {score.device}")


def viterbi_backward_tables_best(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``viterbi_backward_tables`` by the tensor's device (the JAX
    package's name for its kernel route): the CUDA kernel on a CUDA tensor,
    the plain padded DP on a CPU tensor; any other device raises.  A kernel
    that fails to build or launch raises: there is no fallback."""
    _check_kernel_device(score)
    return viterbi_backward_tables(score, noise)


def log_z_best(score: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """logZ [N] of unpadded ``score [T, T, N]`` and ``noise [T-1, N]`` by
    the tensor's device: on a CUDA tensor ``ops.logz.log_z`` (the alpha and
    beta kernels, the JAX package's ``semicrf_pallas.log_z``), on a CPU
    tensor the scan ``log_z``; any other device raises.  Both backwards are
    the exact marginals, for the score and the noise.  A kernel that fails to
    build or launch raises: there is no fallback."""
    _check_kernel_device(score)
    if score.device.type == "cuda":
        from . import logz

        return logz.log_z(score, noise)
    return log_z(score, noise)


def viterbi_forward_tables(
    score: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-to-right Viterbi DP on unpadded ``score [T, T, N]`` (end, begin)
    and ``noise [T-1, N]``, one position at a time (ref ``viterbi``).

    Returns (ptr [T-1, N] int32, diag_pos [T, N] bool).  ``ptr[i-1]`` is the
    best move into position ``i``: -1 = skip from i-1, j >= 0 = interval
    (j, i).  Skip wins ties; among intervals the smallest begin wins.  Plain
    PyTorch on any device: the JAX package has no kernel for this direction
    either."""
    t, _, n = score.shape
    dev = score.device
    score = score.float()
    noise = noise.float()
    diag = _diag(score)
    diag_gate = diag * (diag > 0)
    v = torch.zeros(t, n, dtype=torch.float32, device=dev)
    v[0] = diag_gate[0]
    ptr = torch.empty(t - 1, n, dtype=torch.int32, device=dev)
    begins = torch.arange(t, dtype=torch.int32, device=dev)[:, None]
    no_begin = torch.tensor(t, dtype=torch.int32, device=dev)
    for i in range(1, t):
        cand = v[:i] + score[i, :i]
        best = cand.max(dim=0).values
        best_b = torch.where(cand == best, begins[:i], no_begin).min(dim=0).values
        skip = v[i - 1] + noise[i - 1]
        ptr[i - 1] = torch.where(skip >= best, -1, best_b)
        v[i] = torch.maximum(skip, best) + diag_gate[i]
    return ptr, diag > 0


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


def backtrack_forward(
    ptr: np.ndarray,
    diag_pos: np.ndarray,
    forced_start: Optional[Sequence[int]] = None,
) -> List[List[Tuple[int, int]]]:
    """Host pointer walk for the left-to-right DP (ref ``:157-202``), from
    ``forced_start[b]`` (default T-1) down to 0; intervals in time order."""
    tm1, n = ptr.shape
    t = tm1 + 1
    if forced_start is None:
        forced_start = [t - 1] * n
    results: List[List[Tuple[int, int]]] = []
    for b in range(n):
        j = int(forced_start[b])
        out: List[Tuple[int, int]] = []
        while j > 0:
            sel = int(ptr[j - 1, b])
            if diag_pos[j, b]:
                out.append((j, j))
            if sel < 0:
                j -= 1
            else:
                out.append((sel, j))
                j = sel
        if diag_pos[0, b]:
            out.append((0, 0))
        out.reverse()
        results.append(out)
    return results


def walk_backward_device(
    ptr: torch.Tensor,
    diag_pos: torch.Tensor,
    forced_start: torch.Tensor,
    k_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``backtrack_backward`` for every track at once, in tensors: the same
    events in the same order (port of the JAX package's
    ``walk_backward_device``, ``ops/semicrf.py:450``).

    ptr [T-1, NB] int (-1 = skip to t+1, s >= 0 = interval (t, t+1+s)),
    diag_pos [T, NB] bool, forced_start [NB] int -> (begins [NB, K] int32,
    ends [NB, K] int32, zeros past the count; count [NB] int32 clamped to
    K = ``k_max``; overflow [NB] bool, where a track emitted more than K).

    Two phases, as the JAX package writes them: a sweep over the positions
    that moves each track's cursor when the sweep reaches it and records the
    visited positions, then an exclusive cumsum of the emission flags and a
    one-hot [2T, NB, K] compaction.  The plain version of the walk kernel
    (``ops/walk.py``); on the card the kernel walks instead."""
    t, nb = diag_pos.shape
    dev = diag_pos.device
    ptr_pad = torch.cat([ptr.to(torch.int32), torch.full((1, nb), -1, dtype=torch.int32, device=dev)])
    t_col = torch.arange(t, dtype=torch.int32, device=dev)[:, None]
    # where a cursor at each position moves: two operations a position below
    nxt = torch.where(ptr_pad < 0, t_col + 1, t_col + 1 + ptr_pad)
    j = forced_start.to(torch.int32)
    visited = torch.empty(t, nb, dtype=torch.bool, device=dev)
    for p in range(t - 1):
        torch.eq(j, p, out=visited[p])
        j = torch.where(visited[p], nxt[p], j)
    torch.eq(j, t - 1, out=visited[t - 1])

    s_do = visited & diag_pos
    i_do = visited & (ptr_pad >= 0) & (t_col < t - 1)
    t_b = t_col.expand(t, nb)
    # singleton before interval at the same position, as the host walk emits
    do = torch.stack([s_do, i_do], dim=1).reshape(2 * t, nb)
    b_val = torch.stack([t_b, t_b], dim=1).reshape(2 * t, nb)
    e_val = torch.stack([t_b, t_b + 1 + ptr_pad], dim=1).reshape(2 * t, nb)
    doi = do.to(torch.int32)
    k_of = torch.cumsum(doi, dim=0, dtype=torch.int32) - doi  # exclusive: each event's slot
    count = k_of[-1] + doi[-1]
    oh = (k_of[..., None] == torch.arange(k_max, dtype=torch.int32, device=dev)) & do[..., None]
    begins = torch.where(oh, b_val[..., None], 0).sum(dim=0, dtype=torch.int32)
    ends = torch.where(oh, e_val[..., None], 0).sum(dim=0, dtype=torch.int32)
    return begins, ends, torch.clamp(count, max=k_max), count > k_max


class NeuralSemiCRFInterval:
    """Stateless wrapper bundling a score pair with the CRF operations (ref
    ``NeuralSemiCRFInterval``)."""

    def __init__(self, score: torch.Tensor, noiseScore: torch.Tensor):
        self.score = score
        self.noiseScore = noiseScore

    def decode(
        self, forcedStartPos: Optional[Sequence[int]] = None, forward: bool = False
    ) -> List[List[Tuple[int, int]]]:
        """The best interval set of every track.  ``forward`` runs the
        left-to-right DP and walks it from ``forcedStartPos`` (default T-1)
        down; otherwise the right-to-left DP, walked from ``forcedStartPos``
        (default 0) up."""
        if forward:
            ptr, diag = viterbi_forward_tables(self.score, self.noiseScore)
            return backtrack_forward(ptr.cpu().numpy(), diag.cpu().numpy(), forcedStartPos)
        ptr, diag = viterbi_backward_tables(self.score, self.noiseScore)
        return backtrack_backward(ptr.cpu().numpy(), diag.cpu().numpy(), forcedStartPos)

    def evalPath(self, intervals) -> torch.Tensor:
        return eval_path(intervals, self.score, self.noiseScore)

    def computeLogZ(self, noBackward: bool = False) -> torch.Tensor:
        """logZ [N]: on a CUDA tensor through the alpha and beta kernels
        (``log_z_best``), on a CPU tensor the scan; ``noBackward`` takes
        autograd through the plain scan (``log_z_slow``)."""
        if noBackward:
            return log_z_slow(self.score, self.noiseScore)
        return log_z_best(self.score, self.noiseScore)

    def logProb(self, intervals, noBackward: bool = False) -> torch.Tensor:
        return self.evalPath(intervals) - self.computeLogZ(noBackward=noBackward)
