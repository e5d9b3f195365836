"""Fused multi-head attention over flat ``[B, S, H*dh]`` inputs: the CUDA
kernels ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` with their
plain PyTorch versions, and ``fused_attention``, the autograd function that
joins them.

Port of ``transkun_tpu/ops/attention_pallas.py``, whose TPU kernels are
``_fwd_kernel`` (``:78``) and ``_bwd_kernel`` (``:127``).  Heads are column
slices of the last axis; q is ``[B, Sq, H*dh]``, k and v ``[B, Skv, H*dh]``.
Logits, softmax and every product accumulate in fp32.  The backward
recomputes the softmax from q and k and takes ``delta = rowsum(do * o)``
from the saved output, so nothing of size ``[Sq, Skv]`` is kept.

The route is opt-in, as in the JAX package: ``use_fused_attention`` reads
``TRANSKUN_TPU_FUSED_ATTN`` (and ``TRANSKUN_TPU_NO_PALLAS``, which turns it
off) at call time.  The flag alone selects the route.  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel or
raises, and never falls back.  fp32 or bf16 tensors, all of one type; the
outputs come in that type (the kernels, like the plain versions, take the
inputs to fp32 first).

Each source holds three variants (``VARIANTS``) and the library picks one by
shape: the tensor-core kernel where a row of logits fits a thread's
registers (Skv <= 160, head_dim <= 64), the streaming kernels for any other
length at head_dim <= 64 (the "0All" and "FT" branches' 13261 keys a
segment, ``downsampleF=False``'s 320), and the general kernel for a wider
head_dim, where k and v fit its shared memory.  Only a shape that no
variant takes is refused.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from . import _build

# Kernel launches made by attention_fwd_cuda / attention_bwd_cuda, by the
# variant that ran; nothing else changes them except a caller resetting them
# to 0.
fwd_launches_by_variant = {"mma": 0, "general": 0, "stream": 0}
bwd_launches_by_variant = {"mma": 0, "general": 0, "stream": 0}


def reset_launches() -> None:
    """Every launch count to 0."""
    for counts in (fwd_launches_by_variant, bwd_launches_by_variant):
        for variant in counts:
            counts[variant] = 0


def use_fused_attention() -> bool:
    """The JAX package's gate (``use_pallas_attention``) without its backend
    test: off unless ``TRANSKUN_TPU_FUSED_ATTN`` is set, and off whenever
    ``TRANSKUN_TPU_NO_PALLAS`` is."""
    if os.environ.get("TRANSKUN_TPU_NO_PALLAS"):
        return False
    return bool(os.environ.get("TRANSKUN_TPU_FUSED_ATTN"))


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*dh] -> [B, H, S, dh] fp32 (a view where x is fp32)."""
    b, s, d = x.shape
    return x.float().reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> [B, S, H*dh]."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _softmax_parts(q, k, num_heads: int, scale: float):
    """(q*scale, k, exp(logits - rowmax), its row sum) per head, fp32."""
    qs, kh = _heads(q, num_heads) * scale, _heads(k, num_heads)
    logits = torch.matmul(qs, kh.transpose(-1, -2))  # [B, H, Sq, Skv]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return qs, kh, p, p.sum(dim=-1, keepdim=True)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """softmax((q*scale) k^T) v per head, as the TPU forward kernel takes
    it: fp32 logits from the scaled q, row max, exp, sum, weighted sum, one
    division."""
    _, _, p, s = _softmax_parts(q, k, num_heads, scale)
    o = torch.matmul(p, _heads(v, num_heads)) / s
    return _flat(o).to(q.dtype)


def attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, num_heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_plain`` written out, as the TPU backward
    kernel takes it: the softmax recomputed, delta = rowsum(do*o),
    dl = p*(dp - delta), dq = dl k * scale, dk = dl^T (q*scale), dv = p^T do."""
    qs, kh, p, s = _softmax_parts(q, k, num_heads, scale)
    pn = p / s
    doh = _heads(do, num_heads)
    delta = (doh * _heads(o, num_heads)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(doh, _heads(v, num_heads).transpose(-1, -2))
    dl = pn * (dp - delta)
    dq = torch.matmul(dl, kh) * scale
    dk = torch.matmul(dl.transpose(-1, -2), qs)
    dv = torch.matmul(pn.transpose(-1, -2), doh)
    return _flat(dq).to(q.dtype), _flat(dk).to(k.dtype), _flat(dv).to(v.dtype)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}  # exported name suffix
# The library picks a variant by shape (None); a caller may force one.
VARIANTS = {None: -1, "mma": 0, "general": 1, "stream": 2}
_VARIANT_NAMES = {v: k for k, v in VARIANTS.items() if k}
# pointer arguments: q, k, v, o / q, k, v, o, do, dq, dk, dv and the
# streaming kernels' statistics scratch
_N_TENSORS = {"attention_fwd": 4, "attention_bwd": 9}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for suffix in _DTYPES.values():
        fn = getattr(lib, name + suffix)
        # tensors, then b, sq, skv, heads, head_dim, scale, variant, device,
        # stream and where the variant that ran is written
        fn.argtypes = [_PTR] * _N_TENSORS[name] + [_INT] * 5 + [
            ctypes.c_float, _INT, _INT, _PTR, ctypes.POINTER(_INT)]
        fn.restype = _INT
    getattr(lib, name + "_smem_bytes").argtypes = [_INT] * 4
    getattr(lib, name + "_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, name + "_variant").argtypes = [_INT] * 3
    getattr(lib, name + "_variant").restype = _INT
    getattr(lib, name + "_error_string").argtypes = [_INT]
    getattr(lib, name + "_error_string").restype = ctypes.c_char_p
    return lib


def kernel_variant(name: str, sq: int, skv: int, head_dim: int) -> str:
    """Which kernel of ``name`` ("attention_fwd" or "attention_bwd") the
    library picks at this shape: "mma", "general" or "stream"."""
    return _VARIANT_NAMES[getattr(_library(name), name + "_variant")(sq, skv, head_dim)]


def _launch(name: str, inputs, n_out: int, num_heads: int, scale: float, variant=None):
    """Check ``inputs`` (q, k, v and, for the backward, o and do), allocate
    the outputs in their type (and the backward's statistics scratch) and
    launch ``name`` on the current stream.
    Returns (the outputs, the variant that ran)."""
    q, k, v = inputs[:3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for arg, a in zip(("q", "k", "v", "o", "do"), inputs):
        if a.dtype != q.dtype:
            raise TypeError(f"{arg} is {a.dtype}, q {q.dtype}: one type for all")
    for arg, a in zip(("q", "k", "v", "o", "do"), inputs):
        if a.device != q.device or a.device.type != "cuda":
            raise ValueError(f"{arg} is on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must be [B, S, H*dh]")
    b, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, d) or v.shape != k.shape or any(a.shape != q.shape for a in inputs[3:]):
        raise ValueError(
            f"shapes {[tuple(a.shape) for a in inputs]}: want q, o, do [B, Sq, D] "
            "and k, v [B, Skv, D]"
        )
    if num_heads < 1 or d % num_heads or 0 in (b, sq, skv, d):
        raise ValueError(f"D={d} must be a positive multiple of num_heads={num_heads}, B and S positive")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {list(VARIANTS)}, got {variant!r}")
    lib = _library(name)
    dh = d // num_heads
    smem = getattr(lib, name + "_smem_bytes")(sq, skv, dh, VARIANTS[variant])
    if smem < 0:  # only a variant asked for can refuse the shape
        raise ValueError(f"the {variant} kernel does not take Sq={sq}, Skv={skv}, head_dim={dh}")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"Sq={sq}, Skv={skv}, head_dim={dh} need {smem} B of shared "
            f"memory, above {_build.SMEM_LIMIT} B: sequence too long for the kernel"
        )
    outs = [torch.empty_like(a) for a in ((q,) if n_out == 1 else (q, k, v))]
    pointers = [a.data_ptr() for a in (*inputs, *outs)]
    if name == "attention_bwd":
        # the streaming kernels' [3, B*H, Sq] row statistics (3/head_dim of
        # dq's values), allocated whatever variant runs, so that no call has
        # to ask which one will
        stats = torch.empty(3 * b * num_heads * sq, dtype=torch.float32, device=q.device)
        pointers.append(stats.data_ptr())
    ran = _INT(-1)
    err = getattr(lib, name + _DTYPES[q.dtype])(
        *pointers, b, sq, skv, num_heads, dh, float(scale), VARIANTS[variant],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(ran),
    )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {getattr(lib, name + '_error_string')(err).decode()}"
        )
    return outs, _VARIANT_NAMES[ran.value]


def attention_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    variant=None,
) -> torch.Tensor:
    """Launch the forward kernel (fp32 or bf16 tensors, all of one type);
    raises on anything it does not take.  ``variant`` forces "mma",
    "general" or "stream"; by default the library picks by shape."""
    (o,), ran = _launch("attention_fwd", (q, k, v), 1, num_heads, scale, variant)
    fwd_launches_by_variant[ran] += 1
    return o


def attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, num_heads: int, scale: float, variant=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (fp32 or bf16 tensors, all of one type);
    raises on anything it does not take.  ``variant`` as in the forward.
    The streaming variant is two launches on the stream (its passes over
    query rows and over keys), counted as one call of the kernel."""
    (dq, dk, dv), ran = _launch("attention_bwd", (q, k, v, o, do), 3, num_heads, scale, variant)
    bwd_launches_by_variant[ran] += 1
    return dq, dk, dv


def _by_device(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no attention kernel for device {x.device}")


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        o = _by_device(q, attention_plain, attention_fwd_cuda)(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        bwd = _by_device(q, attention_bwd_plain, attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, o, do.to(q.dtype).contiguous(), ctx.num_heads, ctx.scale)
        return dq, dk, dv, None, None


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """softmax((q @ k^T) * scale) @ v per head; q/k/v ``[B, S, H*dh]``.  The
    plain versions for CPU tensors, the CUDA kernels for CUDA tensors, in
    the forward and in the backward."""
    return _FusedAttention.apply(q, k, v, num_heads, scale)
