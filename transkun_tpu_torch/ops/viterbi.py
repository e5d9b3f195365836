"""Viterbi pointer tables in the padded decode layout: the CUDA kernel
``csrc/viterbi_bwd.cu`` and its plain PyTorch version.

Port of ``viterbi_backward_tables_padded`` (``transkun_tpu/ops/
semicrf_pallas.py:143``), whose TPU kernel is ``_viterbi_bwd_kernel``
(``:67``).  Inputs: ``s_t [Tp, Tp, NBp]`` f32 or bf16 in [begin, end, lane]
layout, NEG-padded, upcast to f32 as it is read; ``noise [Tp, NBp]`` f32;
``diag_gate [Tp, NBp]`` f32, already gated (``diag * (diag > 0)``).  Output: int32 ``ptr [Tp, NBp]``, -1 = skip
to p+1, s >= 0 = interval (p, p+1+s).

On a CPU tensor the wrapper runs the plain version.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  The kernel is bounded
by its chain of Tp dependent positions (see the note in the CUDA source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Kernel launches made by viterbi_backward_tables_padded; nothing else
# changes it except a caller resetting it to 0.
launches = 0

# exported C function for each score dtype the kernel takes
_KERNEL_OF = {torch.float32: "viterbi_bwd", torch.bfloat16: "viterbi_bwd_bf16"}


def viterbi_backward_tables_plain(
    s_t: torch.Tensor, noise: torch.Tensor, diag_gate: torch.Tensor
) -> torch.Tensor:
    """The right-to-left max-semiring DP, one position at a time.

    Skip wins ties (``skip >= best``); among intervals the smallest end
    wins.  Works on any device and any Tp >= 1."""
    tp, _, nb = s_t.shape
    dev = s_t.device
    q = torch.empty(tp, nb, dtype=torch.float32, device=dev)
    ptr = torch.empty(tp, nb, dtype=torch.int32, device=dev)
    q[tp - 1] = diag_gate[tp - 1]
    ptr[tp - 1] = -1
    ends = torch.arange(tp, dtype=torch.int32, device=dev)[:, None]
    no_end = torch.tensor(tp, dtype=torch.int32, device=dev)
    for p in range(tp - 2, -1, -1):
        cand = q[p + 1 :] + s_t[p, p + 1 :].float()
        best = cand.max(dim=0).values
        best_e = torch.where(cand == best, ends[p + 1 :], no_end).min(dim=0).values
        skip = q[p + 1] + noise[p]
        ptr[p] = torch.where(skip >= best, -1, best_e - (p + 1))
        q[p] = torch.maximum(skip, best) + diag_gate[p]
    return ptr


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("viterbi_bwd")
    for name in _KERNEL_OF.values():
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.viterbi_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.viterbi_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.viterbi_bwd_lanes_per_block.argtypes = []
    lib.viterbi_bwd_lanes_per_block.restype = ctypes.c_int
    lib.viterbi_bwd_error_string.argtypes = [ctypes.c_int]
    lib.viterbi_bwd_error_string.restype = ctypes.c_char_p
    return lib


def viterbi_backward_tables_cuda(
    s_t: torch.Tensor, noise: torch.Tensor, diag_gate: torch.Tensor
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream.  Raises on anything
    the kernel does not take; allocates only the output."""
    global launches
    lib = _library()
    tp, tp2, nbp = s_t.shape
    lanes = lib.viterbi_bwd_lanes_per_block()
    if s_t.dtype not in _KERNEL_OF:
        raise TypeError(f"s_t must be float32 or bfloat16, got {s_t.dtype}")
    for name, a in (("s_t", s_t), ("noise", noise), ("diag_gate", diag_gate)):
        if a.device != s_t.device or a.device.type != "cuda":
            raise ValueError(f"{name} is on {a.device}, s_t on {s_t.device}")
        if a is not s_t and a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tp2 != tp or noise.shape != (tp, nbp) or diag_gate.shape != (tp, nbp):
        raise ValueError(
            f"shapes s_t {tuple(s_t.shape)}, noise {tuple(noise.shape)}, "
            f"diag_gate {tuple(diag_gate.shape)}: want [Tp,Tp,NBp], [Tp,NBp]"
        )
    # the decode layout pads positions to a multiple of 8 (PALLAS_KP)
    if tp % 8 or nbp % lanes or tp == 0 or nbp == 0:
        raise ValueError(f"Tp={tp} must be a multiple of 8, NBp={nbp} of {lanes}")
    smem = lib.viterbi_bwd_smem_bytes(tp)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"Tp={tp} needs {smem} B of shared memory, above {_build.SMEM_LIMIT} B: "
            "segment too long for the kernel"
        )
    ptr = torch.empty(tp, nbp, dtype=torch.int32, device=s_t.device)
    err = getattr(lib, _KERNEL_OF[s_t.dtype])(
        s_t.data_ptr(), noise.data_ptr(), diag_gate.data_ptr(), ptr.data_ptr(),
        tp, nbp, s_t.device.index,
        torch.cuda.current_stream(s_t.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"viterbi_bwd launch failed: {lib.viterbi_bwd_error_string(err).decode()}"
        )
    launches += 1
    return ptr


def viterbi_backward_tables_padded(
    s_t: torch.Tensor, noise: torch.Tensor, diag_gate: torch.Tensor
) -> torch.Tensor:
    """Viterbi pointer tables from pre-padded, pre-transposed inputs.
    The plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if s_t.device.type == "cpu":
        return viterbi_backward_tables_plain(s_t, noise, diag_gate)
    if s_t.device.type == "cuda":
        return viterbi_backward_tables_cuda(s_t, noise, diag_gate)
    raise ValueError(f"no Viterbi kernel for device {s_t.device}")
