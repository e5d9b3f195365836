"""The stitching chain of a group of segments: the CUDA kernel
``csrc/decode_walk.cu`` and its plain PyTorch version.

Not the port of a TPU kernel: it replaces the XLA code of the JAX package's
decode, ``walk_backward_device`` (``transkun_tpu/ops/semicrf.py:450``) and the
per-segment chain of ``TransKun._fused_group_traced``
(``transkun_tpu/models/transkun.py:1031-1063``).  For each of the group's n
segments in turn, every track walks its Viterbi pointers from its forced
start, keeps its first ``k_max`` events, takes lastP (the end of the last
event whose offset is real) and hands ``max(lastP - step_frames, 0)`` to the
next segment as its forced start.

Inputs: ptr [n, t-1, P] int32, diag [n, t, P] bool, bpres [n, P, t, n_edge]
bool (the offset presence of the intervals ending in the last n_edge frames),
start [P] int32.  Returns (begins [n, P, k_max] int32, ends [n, P, k_max]
int32, zeros past the count; count [n, P] int32 clamped to k_max; overflow
[n, P] bool, count > k_max before the clamp; the next group's start [P]
int32).  ``onset_bound`` >= 0 keeps only the events beginning before it in
lastP (the events themselves are all returned, as in the JAX package).

On a CPU tensor ``walk_group`` runs the plain version; on a CUDA tensor it
launches the kernel or raises, and never falls back.  A sequential pointer
chase of ~700 steps a segment: in plain PyTorch on the card it would be
thousands of tiny launches a segment, so the card has only the kernel.

The kernel gives each CTA a tile of tracks, stages the tile's columns of
ptr and diag in shared memory and walks from there, and writes every slot
of begins and ends itself (``launch_plan``; the design is in the source's
note).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import _build, semicrf

# Kernel launches made by walk_group_cuda; nothing else changes it except a
# caller resetting it to 0.
launches = 0

Walk = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# Tracks a CTA.  A CTA's staging costs it about the same at any tile (a line
# or two of every row), and a wider tile adds bytes and the walks of more
# tracks to the walker warp: on the flagship's first group (an H100, 700 W;
# scripts/study_walk.py) the kernel took 9.4 us of device time at 1 track a
# CTA, 12.5 at 2, 13.9 at 4, 19.5 at 8, 29.5 at 16 and 54.3 at 32.  The
# kernel takes any power of two up to 32 (one walker warp); the study sets
# TILE to sweep them.
TILE = 1


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """``blocks`` CTAs (of 128 threads: warp 0 walks, the others stage and
    write the outputs), each walking ``tile`` tracks (the last tile may be
    ragged); ``slots`` segments of the tile's ptr, diag and bpres columns
    staged in shared memory at once (0: the walk reads them from global
    memory); events through a buffer in shared memory (``buffered``) or
    stored to global memory; ``smem`` bytes of dynamic shared memory a CTA."""

    tile: int
    blocks: int
    slots: int
    buffered: bool
    smem: int


def smem_bytes(t: int, tile: int, slots: int, buffered: bool, k_max: int, n_edge: int = 2) -> int:
    """Dynamic shared memory of a CTA (``csrc/decode_walk.cu``'s
    ``smem_bytes``): mbarriers (slots + 4) and counts [2, tile] int32, padded
    to 16 bytes; two parities of [tile, k_max] (begin, end) int32 pairs if
    buffered; and for each of ``slots`` segments ptr [t-1, tile] int32, diag
    [t, row] bytes and bpres [tile, t, n_edge] bytes, a diag row and the
    bpres run being the aligned 4-byte words that can cover them from any
    offset."""
    header = -(-(8 * (slots + 4) + 8 * tile) // 16) * 16
    diag_row = 4 * ((tile + 6) // 4)
    bpres_run = 4 * ((tile * t * n_edge + 6) // 4)
    return (header + (16 * tile * k_max if buffered else 0)
            + slots * ((t - 1) * tile * 4 + t * diag_row + bpres_run))


def launch_plan(n: int, t: int, p: int, k_max: int, n_edge: int = 2) -> LaunchPlan:
    """The kernel's plan for a group of ``n`` segments of ``t`` positions,
    ``p`` tracks in tiles of ``TILE``, ``k_max`` events a track, ``n_edge``
    presence bits a position (the flagship's 2).  The first that fits in a
    CTA's shared memory (``_build.SMEM_LIMIT``), in this order: events
    buffered, then stored to global memory; for each, all n segments
    staged, then fewer, down to one; and last the same with the tables read
    from global memory."""
    if min(n, p, k_max, n_edge) < 1 or t < 2:
        raise ValueError(f"n={n}, t={t}, P={p}, k_max={k_max}, n_edge={n_edge}")
    for slot_counts in (range(n, 0, -1), (0,)):
        for buffered in (True, False):
            for slots in slot_counts:
                smem = smem_bytes(t, TILE, slots, buffered, k_max, n_edge)
                if smem <= _build.SMEM_LIMIT:
                    return LaunchPlan(TILE, -(-p // TILE), slots, buffered, smem)
    raise ValueError(f"no launch plan fits n={n}, t={t}, P={p}, k_max={k_max}")


def walk_group_plain(
    ptr: torch.Tensor, diag: torch.Tensor, bpres: torch.Tensor, start: torch.Tensor,
    k_max: int, last_frame_idx: int, step_frames: int, onset_bound: int = -1,
) -> Walk:
    """The chain in torch operations: ``semicrf.walk_backward_device`` a
    segment, then lastP and the next start as the JAX package computes
    them."""
    n, n_edge = ptr.shape[0], bpres.shape[-1]
    k_range = torch.arange(k_max, device=ptr.device)
    out = []
    start = start.to(torch.int32)
    for gi in range(n):
        b, e, cnt, ovf = semicrf.walk_backward_device(ptr[gi], diag[gi], start, k_max)
        valid = k_range[None, :] < cnt[:, None]
        if onset_bound >= 0:
            valid = valid & (b < onset_bound)
        # an event touching the segment's edge has a real offset only if its
        # presence bit says so
        bp_b = torch.take_along_dim(bpres[gi], b[:, :, None].long(), dim=1)  # [P, K, n_edge]
        edge = torch.clamp(e - last_frame_idx, 0, n_edge - 1)
        bp = torch.take_along_dim(bp_b, edge[:, :, None].long(), dim=2)[..., 0]
        ok = (e < last_frame_idx) | bp
        last_p = torch.where(valid & ok, e, 0).amax(dim=-1)  # ends rise along a track
        out.append((b, e, cnt, ovf))
        start = torch.clamp(last_p - step_frames, min=0).to(torch.int32)
    begins, ends, count, overflow = (torch.stack(a) for a in zip(*out))
    return begins, ends, count, overflow, start


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("decode_walk")
    lib.decode_walk.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.decode_walk.restype = ctypes.c_int
    lib.decode_walk_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.decode_walk_smem_bytes.restype = ctypes.c_longlong
    lib.decode_walk_error_string.argtypes = [ctypes.c_int]
    lib.decode_walk_error_string.restype = ctypes.c_char_p
    return lib


def walk_group_cuda(
    ptr: torch.Tensor, diag: torch.Tensor, bpres: torch.Tensor, start: torch.Tensor,
    k_max: int, last_frame_idx: int, step_frames: int, onset_bound: int = -1,
) -> Walk:
    """Launch the kernel on the current stream with ``launch_plan``'s plan:
    one launch for the group, nothing else.  Raises on anything the kernel does not take; allocates only the
    outputs, uninitialised: the kernel writes every slot."""
    global launches
    if ptr.dim() != 3 or diag.dim() != 3 or bpres.dim() != 4 or start.dim() != 1:
        raise ValueError(f"ranks: ptr {ptr.dim()}, diag {diag.dim()}, bpres {bpres.dim()}, "
                         f"start {start.dim()}: want 3, 3, 4, 1")
    n, t, p = diag.shape
    n_edge = bpres.shape[-1]
    if ptr.shape != (n, t - 1, p) or bpres.shape[:3] != (n, p, t) or start.shape != (p,):
        raise ValueError(
            f"shapes ptr {tuple(ptr.shape)}, diag {tuple(diag.shape)}, bpres {tuple(bpres.shape)}, "
            f"start {tuple(start.shape)}: want [n,t-1,P], [n,t,P], [n,P,t,n_edge], [P]")
    for name, a, dtype in (("ptr", ptr, torch.int32), ("diag", diag, torch.bool),
                           ("bpres", bpres, torch.bool), ("start", start, torch.int32)):
        if a.device != ptr.device or a.device.type != "cuda":
            raise ValueError(f"{name} is on {a.device}, ptr on {ptr.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1 or t < 2 or p < 1 or n_edge < 1 or k_max < 1 or last_frame_idx < 0 or step_frames < 0:
        raise ValueError(f"n={n}, t={t}, P={p}, n_edge={n_edge}, k_max={k_max}, "
                         f"last_frame_idx={last_frame_idx}, step_frames={step_frames}")
    plan = launch_plan(n, t, p, k_max, n_edge)
    lib = _library()
    dev = ptr.device
    begins = torch.empty(n, p, k_max, dtype=torch.int32, device=dev)
    ends = torch.empty_like(begins)
    count = torch.empty(n, p, dtype=torch.int32, device=dev)
    overflow = torch.empty(n, p, dtype=torch.bool, device=dev)
    start_out = torch.empty(p, dtype=torch.int32, device=dev)
    err = lib.decode_walk(
        ptr.data_ptr(), diag.data_ptr(), bpres.data_ptr(), start.data_ptr(),
        begins.data_ptr(), ends.data_ptr(), count.data_ptr(), overflow.data_ptr(),
        start_out.data_ptr(), n, t, p, n_edge, k_max, last_frame_idx, step_frames,
        onset_bound, plan.tile.bit_length() - 1, plan.slots, int(plan.buffered), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_walk launch failed: {lib.decode_walk_error_string(err).decode()}")
    launches += 1
    return begins, ends, count, overflow, start_out


def walk_group(
    ptr: torch.Tensor, diag: torch.Tensor, bpres: torch.Tensor, start: torch.Tensor,
    k_max: int, last_frame_idx: int, step_frames: int, onset_bound: int = -1,
) -> Walk:
    """The group's chain: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if ptr.device.type == "cpu":
        return walk_group_plain(ptr, diag, bpres, start, k_max, last_frame_idx, step_frames,
                                onset_bound)
    if ptr.device.type == "cuda":
        return walk_group_cuda(ptr, diag, bpres, start, k_max, last_frame_idx, step_frames,
                               onset_bound)
    raise ValueError(f"no walk kernel for device {ptr.device}")
