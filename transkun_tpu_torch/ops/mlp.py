"""Fused MLP (Linear -> exact-erf GELU -> Linear) with the hidden activation
kept on chip: the CUDA kernel ``csrc/fused_mlp.cu`` with its plain PyTorch
version, and ``fused_mlp``, the autograd function around them.

Port of ``transkun_tpu/ops/mlp_pallas.py``, whose TPU kernel is
``_mlp_kernel`` (``:86``).  ``x [M, D]``, ``w1 [D, hidden]``, ``b1 [hidden]``,
``w2 [hidden, D]``, ``b2 [D]``: weights are [in, out], the transpose of
``nn.Linear.weight``.  A weight may be row-major [in, out] or the ``.t()``
view of a row-major [out, in] tensor (``nn.Linear.weight.t()``): the kernel
reads either in place, so no caller copies a weight.  The backward recomputes
the plain version under autograd, as the JAX package's does outside any
kernel.

The route is opt-in, as in the JAX package: ``use_fused_mlp`` reads
``TRANSKUN_TPU_FUSED_MLP`` (and ``TRANSKUN_TPU_NO_PALLAS``, which turns it
off) at call time.  The flag alone selects the route.  On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises, and never falls back.  float32 or bfloat16, all five tensors of one
type: both products run on the tensor cores with fp32 sums, bias and GELU in
fp32, and ``g`` and the output are rounded to the input type.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _build

# Kernel launches made by mlp_fwd_cuda; nothing else changes it except a
# caller resetting it to 0.
launches = 0


def use_fused_mlp() -> bool:
    """The JAX package's gate (``use_pallas_mlp``) without its backend test:
    on only when ``TRANSKUN_TPU_FUSED_MLP`` is ``1``, and off whenever
    ``TRANSKUN_TPU_NO_PALLAS`` is set."""
    if os.environ.get("TRANSKUN_TPU_NO_PALLAS"):
        return False
    return os.environ.get("TRANSKUN_TPU_FUSED_MLP", "0") == "1"


def mlp_plain(x, w1, b1, w2, b2):
    """gelu(x w1 + b1) w2 + b2 with the exact-erf GELU taken in fp32
    (``mlp_reference`` of the JAX package); also the backward's body."""
    h = x @ w1 + b1
    g = torch.nn.functional.gelu(h.float()).to(x.dtype)
    return g @ w2 + b2


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_KERNEL_OF = {torch.float32: "fused_mlp", torch.bfloat16: "fused_mlp_bf16"}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    for name in _KERNEL_OF.values():
        fn = getattr(lib, name)
        # x, w1, b1, w2, b2, out, m, d, hidden, w1 layout, w2 layout, device, stream
        fn.argtypes = [_PTR] * 6 + [_INT] * 6 + [_PTR]
        fn.restype = _INT
    lib.fused_mlp_takes.argtypes = [_INT, _INT]
    lib.fused_mlp_takes.restype = _INT
    lib.fused_mlp_plan.argtypes = [_INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
    lib.fused_mlp_plan.restype = _INT
    lib.fused_mlp_error_string.argtypes = [_INT]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def weight_layout(name: str, w: torch.Tensor) -> int:
    """How an [in, out] weight lies in memory: 0 row-major, 1 the ``.t()``
    view of a row-major [out, in] tensor (``nn.Linear``'s).  Anything else
    raises: the kernel reads the weight in place and copies nothing."""
    if w.dim() != 2:
        raise ValueError(f"{name} {tuple(w.shape)} must be [in, out]")
    if w.is_contiguous():
        return 0
    if w.t().is_contiguous():
        return 1
    raise ValueError(
        f"{name} {tuple(w.shape)} with strides {w.stride()} is neither row-major [in, out] "
        "nor the transposed view of a row-major [out, in] tensor"
    )


def check_types(x, w1, b1, w2, b2) -> None:
    """One type for all five tensors, as the JAX package asks of its
    callers ("pre-cast"); checked on any device."""
    for name, a in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if a.dtype != x.dtype:
            raise TypeError(f"{name} is {a.dtype}, x {x.dtype}: one type for all")


def launch_plan(m: int, device: torch.device) -> tuple:
    """(blocks, warps a block) of the kernel's launch for ``m`` rows."""
    blocks, warps = _INT(), _INT()
    lib = _library()
    err = lib.fused_mlp_plan(m, device.index, ctypes.byref(blocks), ctypes.byref(warps))
    if err != 0:
        raise RuntimeError(f"fused_mlp_plan failed: {lib.fused_mlp_error_string(err).decode()}")
    return blocks.value, warps.value


def mlp_fwd_cuda(x, w1, b1, w2, b2) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream.  Raises on anything
    the kernel does not take; allocates only the output."""
    global launches
    if x.dtype not in _KERNEL_OF:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_types(x, w1, b1, w2, b2)
    args = (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))
    for name, a in args:
        if a.device != x.device or a.device.type != "cuda":
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, a in (("x", x), ("b1", b1), ("b2", b2)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} must be [M, D], w1 {tuple(w1.shape)} [D, hidden]")
    m, d = x.shape
    hidden = w1.shape[1]
    if w1.shape != (d, hidden) or b1.shape != (hidden,) or w2.shape != (hidden, d) or b2.shape != (d,):
        raise ValueError(
            f"shapes {[tuple(a.shape) for _, a in args]}: want [M,D], [D,hidden], "
            "[hidden], [hidden,D], [D]"
        )
    layouts = weight_layout("w1", w1), weight_layout("w2", w2)
    lib = _library()
    if m == 0 or not lib.fused_mlp_takes(d, hidden):
        raise ValueError(
            f"M={m}, D={d}, hidden={hidden}: the kernel takes M >= 1, D of 128 or 256 "
            "and hidden a positive multiple of 64"
        )
    out = torch.empty_like(x)
    err = getattr(lib, _KERNEL_OF[x.dtype])(
        *[a.data_ptr() for _, a in args], out.data_ptr(), m, d, hidden, *layouts,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp launch failed: {lib.fused_mlp_error_string(err).decode()}")
    launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        check_types(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return mlp_plain(x, w1, b1, w2, b2)
        if x.device.type == "cuda":
            return mlp_fwd_cuda(x, w1, b1, w2, b2)
        raise ValueError(f"no MLP kernel for device {x.device}")

    @staticmethod
    def backward(ctx, do):
        saved = [a.detach().requires_grad_(need) for a, need in
                 zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = mlp_plain(*saved)
        wanted = [a for a in saved if a.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, do))
        return tuple(next(grads) if a.requires_grad else None for a in saved)


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """gelu(x @ w1 + b1) @ w2 + b2 with the hidden activation kept on chip;
    x ``[M, D]``.  The plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (float32 or bfloat16); the backward recomputes the plain
    version.  One type for all five, ``TypeError`` otherwise, on any device."""
    return _FusedMLP.apply(x, w1, b1, w2, b2)


def mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """``fused_mlp`` over ``[..., D]`` inputs.  The caller holds the gate
    (``use_fused_mlp``).  The weights go to the kernel as they lie, row-major
    or as ``nn.Linear.weight.t()``, and are never copied."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    out = fused_mlp(xf.contiguous(), w1, b1, w2, b2)
    return out.reshape(*lead, out.shape[-1])
