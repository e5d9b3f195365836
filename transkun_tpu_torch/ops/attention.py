"""Fused multi-head attention over flat ``[B, S, H*dh]`` inputs: the CUDA
kernels ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` with their
plain PyTorch versions, and ``fused_attention``, the autograd function that
joins them.

Port of ``transkun_tpu/ops/attention_pallas.py``, whose TPU kernels are
``_fwd_kernel`` (``:78``) and ``_bwd_kernel`` (``:127``).  Heads are column
slices of the last axis; q is ``[B, Sq, H*dh]``, k and v ``[B, Skv, H*dh]``.
Logits, softmax and every product accumulate in fp32.  The backward
recomputes the softmax from q and k and takes ``delta = rowsum(do * o)``
from the saved output, so nothing of size ``[Sq, Skv]`` is kept; where the
streaming kernels run, the forward also saves each row's max and 1 / sum
(``[2, B*H, Sq]``), and the backward rebuilds the softmax from them instead
of sweeping the keys for them again.

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
variant takes is refused.  The streaming kernels' launch (warps a block,
the split of the keys across blocks where the grid is short of the SMs,
shared memory, scratch) is ``stream_plan``'s, in Python, so that the CPU
tests reach it.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


def attention_stats_plain(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                          scale: float) -> torch.Tensor:
    """The row statistics the streaming forward kernel writes: fp32
    ``[2, B*H, Sq]``, each row's largest logit in log2 units (q k^T * scale
    * log2(e), the kernels' exponent base being 2) and 1 / the sum of
    2^(logit - that max)."""
    logits = torch.matmul(_heads(q, num_heads) * scale, _heads(k, num_heads).transpose(-1, -2))
    logits = logits * LOG2E
    m = logits.amax(dim=-1)
    inv = 1.0 / torch.exp2(logits - m[..., None]).sum(dim=-1)
    return torch.stack([m, inv]).reshape(2, -1, q.shape[1])


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}  # exported name suffix
# The library picks a variant by shape (None); a caller may force one.
VARIANTS = {None: -1, "mma": 0, "general": 1, "stream": 2}
_VARIANT_NAMES = {v: k for k, v in VARIANTS.items() if k}
# pointer arguments: q, k, v, o and the streaming kernel's statistics and
# scratch / q, k, v, o, do, dq, dk, dv and the same two
_N_TENSORS = {"attention_fwd": 6, "attention_bwd": 10}

# The streaming kernels' geometry (csrc/attention_stream.cuh): tiles of
# STREAM_KEYS rows stream through shared memory; a block of the forward and
# of the backward's pass A owns up to STREAM_MAX_WARPS warps of 16 query
# rows, a block of pass B one tile of keys.
STREAM_KEYS = 64
STREAM_MAX_WARPS = 6
# Blocks of the forward and of pass A that the key splits fill the card
# with: two an SM, what the registers leave room for at 6 warps
# (kStreamThreads); more would make a second wave.
STREAM_BLOCKS_AN_SM = 2
LOG2E = 1.4426950408889634


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The streaming kernels' launch for one shape (``stream_plan``)."""
    warps: int            # 16-row warps a block of the forward and of pass A
    q_tiles: int          # query tiles of one (b, h)
    key_tiles: int        # STREAM_KEYS-key tiles
    splits: int           # contiguous runs of key tiles, a block each
    per_split: int        # key tiles a split (the last may have fewer)
    grid: int             # blocks of the forward and of pass A
    keys_grid: int        # blocks of pass B, one a key tile of a (b, h)
    combine_grid: int     # blocks of 256 threads of each combine launch; 0 with one split
    fwd_smem: int         # shared memory of a block, bytes: forward, pass A, pass B
    rows_smem: int
    keys_smem: int
    stats: int            # fp32 values of the forward's row statistics, [2, B*H, Sq]
    fwd_scratch: int      # fp32 values of the forward's partials; 0 with one split
    bwd_scratch: int      # fp32 values of the backward's scratch: delta, dq's partials

    def split_ranges(self):
        """The key tiles [first, end) of each split, as the kernels take them."""
        return [(s * self.per_split, min((s + 1) * self.per_split, self.key_tiles))
                for s in range(self.splits)]


def _stream_geometry(dh: int, dtype: torch.dtype):
    """(bytes a value, elements a tile row, tiles in the ring) of the
    streaming kernels at head_dim ``dh`` (StreamTile)."""
    if dtype not in _DTYPES:
        raise TypeError(f"the streaming kernels take float32 or bfloat16, not {dtype}")
    dhp = 16 if dh <= 16 else 32 if dh <= 32 else 64
    fp32 = dtype == torch.float32
    return (4, dhp + 4, 2) if fp32 else (2, dhp + 8, 3)


@functools.cache
def stream_plan(b: int, heads: int, sq: int, skv: int, dh: int, dtype: torch.dtype,
                sm_count: int) -> StreamPlan:
    """How the streaming kernels run ``q [b, sq, heads*dh]`` against
    ``skv`` keys on a card of ``sm_count`` SMs.

    Up to 96 query rows are one tile of ceil(sq / 16) warps (0All's 89 rows:
    6 warps, no warp idle); more go in tiles of 64.  Where the blocks of (b,
    h, query tile) are fewer than STREAM_BLOCKS_AN_SM an SM, the keys are
    split across blocks in contiguous runs of key tiles, as many splits as
    fill that many blocks an SM without a second wave, as evenly as whole
    tiles allow and none empty, and a second launch joins the partials in
    split order."""
    if not 1 <= dh <= 64:
        raise ValueError(f"the streaming kernels take head_dim <= 64, not {dh}")
    elem, pitch, stages = _stream_geometry(dh, dtype)
    tiles16 = -(-sq // 16)
    warps, q_tiles = (tiles16, 1) if tiles16 <= STREAM_MAX_WARPS else (4, -(-tiles16 // 4))
    key_tiles = -(-skv // STREAM_KEYS)
    base = b * heads * q_tiles
    splits = max(1, min(STREAM_BLOCKS_AN_SM * sm_count // base, key_tiles))
    per_split = -(-key_tiles // splits)
    splits = -(-key_tiles // per_split)
    plane = b * heads * sq
    tile = STREAM_KEYS * pitch * elem
    return StreamPlan(
        warps=warps, q_tiles=q_tiles, key_tiles=key_tiles, splits=splits, per_split=per_split,
        grid=base * splits, keys_grid=b * heads * key_tiles,
        combine_grid=0 if splits == 1 else -(-plane * dh // 256),
        fwd_smem=warps * 16 * pitch * elem + stages * 2 * tile,
        rows_smem=2 * warps * 16 * pitch * elem + stages * 2 * tile,
        keys_smem=2 * tile + stages * (2 * tile + 3 * STREAM_KEYS * 4),
        stats=2 * plane,
        fwd_scratch=0 if splits == 1 else splits * plane * (dh + 2),
        bwd_scratch=plane + (0 if splits == 1 else splits * plane * dh),
    )


def stream_buffers(plan: StreamPlan, device, direction: str):
    """The fp32 buffers the wrapper hands the streaming kernels
    (``torch.empty``: every value they read is written first): the
    forward's statistics and scratch ("fwd"), or the backward's scratch
    ("bwd"); None where the plan needs none."""
    def empty(n):
        return torch.empty(n, dtype=torch.float32, device=device) if n else None

    if direction == "fwd":
        return empty(plan.stats), empty(plan.fwd_scratch)
    return empty(plan.bwd_scratch)


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for suffix in _DTYPES.values():
        fn = getattr(lib, name + suffix)
        # tensors, then b, sq, skv, heads, head_dim, scale, variant, the
        # streaming plan's warps, splits and tiles a split, device, stream
        # and where the variant that ran is written
        fn.argtypes = [_PTR] * _N_TENSORS[name] + [_INT] * 5 + [
            ctypes.c_float] + [_INT] * 5 + [_PTR, ctypes.POINTER(_INT)]
        fn.restype = _INT
    getattr(lib, name + "_smem_bytes").argtypes = [_INT] * 4
    getattr(lib, name + "_smem_bytes").restype = ctypes.c_longlong
    stream_smem = getattr(lib, name + "_stream_smem_bytes")
    stream_smem.argtypes = [_INT] * (3 if name == "attention_fwd" else 4)
    stream_smem.restype = ctypes.c_longlong
    getattr(lib, name + "_variant").argtypes = [_INT] * 3
    getattr(lib, name + "_variant").restype = _INT
    getattr(lib, name + "_error_string").argtypes = [_INT]
    getattr(lib, name + "_error_string").restype = ctypes.c_char_p
    return lib


@functools.cache
def kernel_variant(name: str, sq: int, skv: int, head_dim: int) -> str:
    """Which kernel of ``name`` ("attention_fwd" or "attention_bwd") the
    library picks at this shape: "mma", "general" or "stream"."""
    return _VARIANT_NAMES[getattr(_library(name), name + "_variant")(sq, skv, head_dim)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _checked(inputs) -> Tuple[int, int, int, int]:
    """Check ``inputs`` (q, k, v and, for the backward, o and do) for what
    every kernel takes; returns (B, Sq, Skv, D)."""
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
    return b, sq, skv, d


def _prepared(name: str, inputs, num_heads: int, variant):
    """Check ``inputs`` (q, k, v and, for the backward, o and do) for what
    ``name``'s kernels take; returns (B, Sq, Skv, head_dim, the variant to
    run: ``variant`` or the library's pick)."""
    b, sq, skv, d = _checked(inputs)
    if num_heads < 1 or d % num_heads or 0 in (b, sq, skv, d):
        raise ValueError(f"D={d} must be a positive multiple of num_heads={num_heads}, B and S positive")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {list(VARIANTS)}, got {variant!r}")
    dh = d // num_heads
    variant = variant or kernel_variant(name, sq, skv, dh)
    if variant == "stream" and dh > 64:
        raise ValueError(f"the stream kernel does not take head_dim={dh}")
    return b, sq, skv, dh, variant


def _launch(name: str, inputs, outs, buffers, plan, num_heads: int, scale: float, variant: str):
    """Launch ``variant`` of ``name`` on the current stream on ``inputs``
    (checked by ``_prepared``) into ``outs``; the streaming variant with its
    ``plan`` and ``buffers`` (statistics, scratch).  Returns the variant
    that ran."""
    q, k = inputs[0], inputs[1]
    b, sq, d = q.shape
    skv, dh = k.shape[1], d // num_heads
    lib = _library(name)
    if variant == "stream":
        smem = max(plan.fwd_smem, plan.rows_smem, plan.keys_smem)
    else:
        smem = getattr(lib, name + "_smem_bytes")(sq, skv, dh, VARIANTS[variant])
        if smem < 0:  # only a variant asked for can refuse the shape
            raise ValueError(f"the {variant} kernel does not take Sq={sq}, Skv={skv}, head_dim={dh}")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"Sq={sq}, Skv={skv}, head_dim={dh} need {smem} B of shared "
            f"memory, above {_build.SMEM_LIMIT} B: sequence too long for the kernel"
        )
    pointers = [a.data_ptr() for a in (*inputs, *outs)] + [
        None if a is None else a.data_ptr() for a in buffers]
    plan_args = (plan.warps, plan.splits, plan.per_split) if plan is not None else (0, 0, 0)
    ran = _INT(-1)
    err = getattr(lib, name + _DTYPES[q.dtype])(
        *pointers, b, sq, skv, num_heads, dh, float(scale), VARIANTS[variant], *plan_args,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(ran),
    )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {getattr(lib, name + '_error_string')(err).decode()}"
        )
    return _VARIANT_NAMES[ran.value]


def attention_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    variant=None, with_stats: bool = False,
):
    """Launch the forward kernel (fp32 or bf16 tensors, all of one type);
    raises on anything it does not take.  ``variant`` forces "mma",
    "general" or "stream"; by default the library picks by shape.  The
    streaming variant runs ``stream_plan``'s launch and also writes each row's statistics, fp32 ``[2, B*H,
    Sq]`` (as ``attention_stats_plain``: the max of the logits in log2 units,
    1 / the sum), which the backward takes; ``with_stats`` returns them
    beside o (None from the other variants)."""
    b, sq, skv, dh, variant = _prepared("attention_fwd", (q, k, v), num_heads, variant)
    o = torch.empty_like(q)
    plan, buffers = None, (None, None)
    if variant == "stream":
        plan = stream_plan(b, num_heads, sq, skv, dh, q.dtype, _sm_count(q.device.index))
        stats, scratch = stream_buffers(plan, q.device, "fwd")
        buffers = (stats.view(2, b * num_heads, sq), scratch)
    ran = _launch("attention_fwd", (q, k, v), (o,), buffers, plan, num_heads, scale, variant)
    fwd_launches_by_variant[ran] += 1
    return (o, buffers[0]) if with_stats else o


def attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, num_heads: int, scale: float, variant=None, stats=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (fp32 or bf16 tensors, all of one type);
    raises on anything it does not take.  ``variant`` as in the forward.  The streaming variant is two launches on the stream (its
    passes over query rows and over keys; a third adds dq's partials where
    the keys are split), counted as one call of the kernel.  It takes the
    forward's row statistics ``stats``; without them it gets them from a
    call of ``attention_fwd_cuda`` (counted as a forward launch), which gives
    the same bits.  The other variants ignore ``stats``."""
    b, sq, skv, dh, variant = _prepared("attention_bwd", (q, k, v, o, do), num_heads, variant)
    dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
    plan, buffers = None, (None, None)
    if variant == "stream":
        plan = stream_plan(b, num_heads, sq, skv, dh, q.dtype, _sm_count(q.device.index))
        if stats is None:
            _, stats = attention_fwd_cuda(q, k, v, num_heads, scale, "stream", True)
        if stats.dtype != torch.float32 or stats.device != q.device or \
                stats.shape != (2, b * num_heads, sq) or not stats.is_contiguous():
            raise ValueError(f"stats must be a contiguous fp32 [2, B*H, Sq] tensor on {q.device}, "
                             f"got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
        buffers = (stats, stream_buffers(plan, q.device, "bwd"))
    ran = _launch("attention_bwd", (q, k, v, o, do), (dq, dk, dv), buffers, plan, num_heads,
                  scale, variant)
    bwd_launches_by_variant[ran] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """The forward saves q, k, v, o and, where the streaming kernel ran, its
    row statistics, which the backward kernel takes instead of sweeping the
    keys for the softmax's max and sum.  On the CPU the plain versions run
    and nothing is handed: the plain backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        if q.device.type == "cpu":
            o, stats = attention_plain(q, k, v, num_heads, scale), None
        elif q.device.type == "cuda":
            o, stats = attention_fwd_cuda(q, k, v, num_heads, scale, with_stats=True)
        else:
            raise ValueError(f"no attention kernel for device {q.device}")
        ctx.save_for_backward(q, k, v, o, stats)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, stats = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = attention_bwd_cuda(q, k, v, o, do, ctx.num_heads, ctx.scale, stats=stats)
        else:
            dq, dk, dv = attention_bwd_plain(q, k, v, o, do, ctx.num_heads, ctx.scale)
        return dq, dk, dv, None, None


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """softmax((q @ k^T) * scale) @ v per head; q/k/v ``[B, S, H*dh]``.  The
    plain versions for CPU tensors, the CUDA kernels for CUDA tensors, in
    the forward and in the backward."""
    return _FusedAttention.apply(q, k, v, num_heads, scale)
