"""The control's precision: float32 products and convolutions taken in
TF32, the step below float32 that a faster path would take.

On the card this is the hardware's TF32 (``allow_tf32``).  On the CPU,
which has no TF32, every operand of a product or convolution is rounded to
TF32's 10-bit mantissa (round to nearest even) and the product accumulates
in float32, which is what the tensor cores do."""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.mm, torch.bmm, torch.nn.functional.linear, torch.nn.functional.conv1d,
             torch.nn.functional.conv2d}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    bits = x.detach().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()  # the rounding passes gradients straight through


class _RoundOperands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
            kwargs = {k: round_tf32(v) if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32(device):
    if torch.device(device).type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    else:
        with _RoundOperands():
            yield
