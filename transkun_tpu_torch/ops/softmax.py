"""Row softmax of attention logits, forward and backward: the CUDA kernels
of ``csrc/softmax_rows.cu`` with their plain PyTorch versions, and
``softmax_rows``, the autograd function that joins them.

Port of ``transkun_tpu/ops/softmax_pallas.py``, whose TPU kernels are
``_fwd_kernel`` (``:54``) and ``_bwd_kernel`` (``:62``).  ``l [R, C]`` is fp32
or bf16; the output has its dtype; row max, exp, sum and delta are fp32.  The
backward recomputes the probabilities from the saved logits:
``dl = p * (do - rowsum(do * p))``.

A study kernel, as in the JAX package: no model code calls it.  Its caller
is the explicit-softmax attention core (``softmax_last`` between two
``torch.matmul`` calls).  The route is opt-in: ``use_fused_softmax`` reads
``TRANSKUN_TPU_FUSED_SOFTMAX`` (and ``TRANSKUN_TPU_NO_PALLAS``, which turns it
off) at call time, and with it unset ``softmax_last`` is ``torch.softmax``.
The flag alone selects the route.  On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches its kernel or raises, and never
falls back.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _build

# Kernel launches made by softmax_fwd_cuda / softmax_bwd_cuda; nothing else
# changes them except a caller resetting them to 0.
fwd_launches = 0
bwd_launches = 0

# suffix of the exported C functions for each dtype the kernels take
_SUFFIX_OF = {torch.float32: "_f32", torch.bfloat16: "_bf16"}


def use_fused_softmax() -> bool:
    """The JAX package's gate (``use_pallas_softmax``) without its backend
    test: off unless ``TRANSKUN_TPU_FUSED_SOFTMAX`` is set, and off whenever
    ``TRANSKUN_TPU_NO_PALLAS`` is."""
    if os.environ.get("TRANSKUN_TPU_NO_PALLAS"):
        return False
    return bool(os.environ.get("TRANSKUN_TPU_FUSED_SOFTMAX"))


def _probabilities(l: torch.Tensor) -> torch.Tensor:
    """fp32 exp(l - rowmax) / rowsum, step by step as the TPU kernels."""
    l32 = l.float()
    e = torch.exp(l32 - l32.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def softmax_plain(l: torch.Tensor) -> torch.Tensor:
    """Softmax over the rows of ``l [R, C]`` in fp32, in ``l``'s dtype."""
    return _probabilities(l).to(l.dtype)


def softmax_bwd_plain(l: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``softmax_plain`` at ``l`` for ``do``: the probabilities
    recomputed, delta = rowsum(do * p), dl = p * (do - delta), in fp32."""
    p = _probabilities(l)
    dp = do.float()
    delta = (dp * p).sum(dim=1, keepdim=True)
    return (p * (dp - delta)).to(l.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("softmax_rows")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for suffix in _SUFFIX_OF.values():
        fwd = getattr(lib, "softmax_rows_fwd" + suffix)
        # l, out, rows, cols, device, stream
        fwd.argtypes = [ptr, ptr, ctypes.c_longlong, i, i, ptr]
        fwd.restype = i
        bwd = getattr(lib, "softmax_rows_bwd" + suffix)
        # l, do, dl, rows, cols, device, stream
        bwd.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, i, i, ptr]
        bwd.restype = i
    lib.softmax_rows_error_string.argtypes = [i]
    lib.softmax_rows_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _function(direction: str, dtype: torch.dtype):
    """The exported C function of ``direction`` ("fwd" or "bwd") for ``dtype``."""
    return getattr(_library(), f"softmax_rows_{direction}{_SUFFIX_OF[dtype]}")


def _launch(direction: str, l: torch.Tensor, *more: torch.Tensor) -> torch.Tensor:
    """Check ``l`` (and ``do``), allocate the output and launch the
    ``direction`` ("fwd" or "bwd") kernel on the current stream.  The kernel
    takes about as long as this function, so the checks are written for the
    host's time: one pass, no intermediate lists."""
    dtype, shape, device = l.dtype, l.shape, l.device
    if dtype not in _SUFFIX_OF:
        raise TypeError(f"l must be float32 or bfloat16, got {dtype}")
    if len(shape) != 2 or shape[0] == 0 or shape[1] == 0:
        raise ValueError(f"l {tuple(shape)} must be [R, C] with R, C >= 1")
    if device.type != "cuda":
        raise ValueError(f"l is on {device}: the kernels take CUDA tensors")
    if not l.is_contiguous():
        raise ValueError("l must be contiguous")
    for a in more:
        if a.device != device:
            raise ValueError(f"do is on {a.device}, l on {device}")
        if a.dtype != dtype or a.shape != shape:
            raise TypeError(f"do is {a.dtype} {tuple(a.shape)}, l {dtype} {tuple(shape)}")
        if not a.is_contiguous():
            raise ValueError("do must be contiguous")
    out = torch.empty_like(l)
    err = _function(direction, dtype)(
        l.data_ptr(), *[a.data_ptr() for a in more], out.data_ptr(), shape[0], shape[1],
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"softmax_rows_{direction} launch failed: "
            f"{_library().softmax_rows_error_string(err).decode()}"
        )
    return out


def softmax_fwd_cuda(l: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel; raises on anything it does not take."""
    global fwd_launches
    out = _launch("fwd", l)
    fwd_launches += 1
    return out


def softmax_bwd_cuda(l: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel; raises on anything it does not take."""
    global bwd_launches
    dl = _launch("bwd", l, do)
    bwd_launches += 1
    return dl


def _by_device(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no softmax kernel for device {x.device}")


class _SoftmaxRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l):
        ctx.save_for_backward(l)
        return _by_device(l, softmax_plain, softmax_fwd_cuda)(l)

    @staticmethod
    def backward(ctx, do):
        (l,) = ctx.saved_tensors
        return _by_device(l, softmax_bwd_plain, softmax_bwd_cuda)(l, do.contiguous())


def softmax_rows(l: torch.Tensor) -> torch.Tensor:
    """Softmax over the rows of a contiguous ``l [R, C]``: the plain versions
    for a CPU tensor, the CUDA kernels for a CUDA tensor, in the forward and
    in the backward."""
    return _SoftmaxRows.apply(l)


def softmax_last(l: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, any leading shape: ``softmax_rows`` when
    ``use_fused_softmax()``, ``torch.softmax`` otherwise.  A non-contiguous
    input is copied to a contiguous one first."""
    if not use_fused_softmax():
        return torch.softmax(l, dim=-1)
    return softmax_rows(l.reshape(-1, l.shape[-1]).contiguous()).reshape(l.shape)
