"""V2 transformer building blocks, channels-last.

Port of ``transkun_tpu/models/layers.py``.  Module and parameter names follow
the reference PyTorch model, so its state_dict keys load as they are (see
``utils/convert.py``).  ``BasicBlock`` has every branch of the JAX
package's: the "F" and "T" axial attentions of the flagship, the "All0" /
"0All" aggregation-track attentions and the full "FT" attention.

Dropout draws its masks from an explicit ``torch.Generator`` (set with
``set_dropout_generator``), so a training step's masks follow from its seed
and a recomputed (checkpointed) layer can replay them.

``dtype`` on a module is flax's ``dtype=``: parameters stay fp32 and are cast
where they are used, and the module computes in that dtype (``None``: the
input's).  The casts are written out at the places where the JAX package
rounds, not left to ``torch.autocast``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import attention as attention_ops
from ..ops import mlp as mlp_ops
from ..ops.semicrf import NEG


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from ``self.generator`` (the global
    RNG when it is None).  ``tied_dims`` share one mask entry along those
    axes: ``(2, 3)`` on NCHW drops whole channels, as ``nn.Dropout2d``."""

    def __init__(self, p: float, tied_dims: Tuple[int, ...] = ()):
        super().__init__()
        self.p = p
        self.tied_dims = tied_dims
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = [1 if d in self.tied_dims else n for d, n in enumerate(x.shape)]
        keep = 1.0 - self.p
        mask = torch.empty(shape, dtype=x.dtype, device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        return x * mask / keep


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Point every module under ``module`` that draws random numbers (the
    ``Dropout`` layers, and the backbone that replays them on recompute) at
    ``generator``."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMSNorm, statistics in fp32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``lin(x)`` computed in ``dtype`` as flax's ``Dense(dtype=...)``: input,
    weight and bias cast, the product rounded, then the bias added (two
    roundings).  ``None`` is ``lin(x)`` as it stands."""
    if dtype is None:
        return lin(x)
    return x.to(dtype) @ lin.weight.t().to(dtype) + lin.bias.to(dtype)


def grid_coords(*axes: torch.Tensor) -> torch.Tensor:
    """meshgrid(indexing='ij') + stack(-1): [len(a0), ..., n_axes]."""
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def mlp(hidden_in: int, hidden: int, out: int, dropout: float) -> nn.Sequential:
    """Linear -> exact-erf GELU -> Dropout -> Linear (indices 0 and 3 hold
    the weights, as in the reference)."""
    return nn.Sequential(
        nn.Linear(hidden_in, hidden), nn.GELU(), Dropout(dropout),
        nn.Linear(hidden, out),
    )


class SpatialPositionEmbedding(nn.Module):
    """Random-Fourier-feature position embedding with an MLP on top:
    cos(proj(coord)) / sqrt(d/2), then Linear-GELU-Linear."""

    def __init__(self, embed_size: int, coord_dim: int, dropout: float = 0.0):
        super().__init__()
        self.embed_size = embed_size
        self.proj = nn.Linear(coord_dim, embed_size)
        self.mlp = mlp(embed_size, 4 * embed_size, embed_size, dropout)

    def forward(self, coord: torch.Tensor) -> torch.Tensor:
        z = torch.cos(self.proj(coord.float())) / math.sqrt(self.embed_size / 2)
        return self.mlp(z)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Per-head softmax(q k^T * scale) v over axis -2, written out in the
    order of the JAX package's ``attention_xla``: fp32 logits (q and k go
    to fp32, exact for bf16 values), the row max held constant under
    autograd, exp, p rounded to the value dtype, the weighted sum and the
    row sum both of the rounded p, one division in the value dtype.  The
    JAX package takes the row sum from a ones column of the same product:
    the fp32 sum of the rounded p, rounded once, as here.
    q [..., Sq, H*dh], k/v [..., Sk, H*dh]."""
    d = q.shape[-1]
    head_dim = d // num_heads

    def split(x):
        return x.reshape(*x.shape[:-1], num_heads, head_dim).transpose(-2, -3)

    qh, kh, vh = split(q), split(k), split(v)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach()).to(vh.dtype)
    row_sum = p.sum(dim=-1, keepdim=True, dtype=torch.float32).to(vh.dtype)
    o = torch.matmul(p, vh) / row_sum
    o = o.transpose(-2, -3)  # [..., Sq, heads, head_dim]
    return o.reshape(*o.shape[:-2], d).to(q.dtype)


class MultiHeadAttention(nn.Module):
    """Unbiased q/k/v projections stored [in, out] and a biased out
    projection; attends over axis -2.  head_dim =
    ceil(ceil(hidden_factor * embed) / num_heads)."""

    def __init__(self, embed_dim: int, num_heads: int, hidden_factor: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.head_dim = int(math.ceil(math.ceil(hidden_factor * embed_dim) / num_heads))
        hidden = self.head_dim * num_heads
        self.q_proj_weight = nn.Parameter(torch.empty(embed_dim, hidden))
        self.k_proj_weight = nn.Parameter(torch.empty(embed_dim, hidden))
        self.v_proj_weight = nn.Parameter(torch.empty(embed_dim, hidden))
        self.out_proj = nn.Linear(hidden, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.q_proj_weight, self.k_proj_weight, self.v_proj_weight
        if self.dtype is not None:
            query, key, wq, wk, wv = (a.to(self.dtype) for a in (query, key, wq, wk, wv))
        q = query @ wq
        k = key @ wk
        v = key @ wv
        scale = 1.0 / math.sqrt(self.head_dim)
        if attention_ops.use_fused_attention():
            # the fused route wants flat [B, S, hidden]: broadcast the
            # leading dims of the query against the key/value's explicitly
            lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
            hidden = q.shape[-1]
            flat = [
                x.expand(*lead, *x.shape[-2:]).reshape(-1, x.shape[-2], hidden).contiguous()
                for x in (q, k, v)
            ]
            out = attention_ops.fused_attention(*flat, self.num_heads, scale)
            out = out.reshape(*lead, q.shape[-2], hidden)
        else:
            out = attention(q, k, v, self.num_heads, scale)
        return dense(self.out_proj, out, self.dtype)


class AttnResBlock(nn.Module):
    """x + dropout(MHA(rms_norm(x), mem)) * scale (LayerScale, init 1e-2)."""

    def __init__(self, size: int, num_heads: int, hidden_factor_attn: float, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.full((size,), 1e-2))
        self.module = MultiHeadAttention(size, num_heads, hidden_factor_attn, dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        q_in = rms_norm(x).to(self.dtype or x.dtype)
        h = self.drop(self.module(q_in, mem))
        return x + (h * self.scale).to(x.dtype)


class FFNResBlock(nn.Module):
    """x + dropout(MLP(rms_norm(x))) * scale."""

    def __init__(self, size: int, hidden_factor: float, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.full((size,), 1e-2))
        hidden = int(math.ceil(size * hidden_factor))
        self.module = mlp(size, hidden, size, dropout)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        xin = rms_norm(x).to(dt)
        lin1, act, mid_drop, lin2 = self.module
        if mlp_ops.use_fused_mlp() and (not self.training or mid_drop.p == 0.0):
            # the hidden activation stays on chip; the mid-FFN dropout is a
            # no-op under this condition.  nn.Linear stores [out, in], the
            # fused route takes [in, out]: the transposed views go in as they
            # lie (no copy at fp32, only the casts at bf16)
            h = mlp_ops.mlp(xin, lin1.weight.to(dt).t(), lin1.bias.to(dt),
                            lin2.weight.to(dt).t(), lin2.bias.to(dt))
        else:
            h = dense(lin2, mid_drop(act(dense(lin1, xin, self.dtype))), self.dtype)
        return x + (self.drop(h) * self.scale).to(x.dtype)


class BasicBlock(nn.Module):
    """Factorized axial attention over a [N, T, F, D] lattice (the JAX
    package's ``BasicBlock``), in the order F, T, All0/0All, FT:

    - "F" attends along frequency/tracks within each time step, "T" along
      time within each column;
    - "All0": tracks 1: attend to track 0's row; "0All": track 0 attends to
      the whole flattened lattice.  Both use the one ``mhaBlockAll0``, and
      one ``fnnBlockAll0`` runs after them;
    - "FT" attends over the flattened F x T lattice.

    Every attention reads the block's input as keys/values (directly,
    transposed, sliced or flattened)."""

    def __init__(
        self,
        size: int,
        num_heads: int,
        hidden_factor: float = 2.0,
        hidden_factor_attn: float = 1.0,
        enabled: Sequence[str] = ("F", "T", "All0", "0All"),
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.enabled = tuple(enabled)
        tags = [tag for tag in ("F", "T") if tag in self.enabled]
        if "All0" in self.enabled or "0All" in self.enabled:
            tags.append("All0")  # one block for both aggregation directions
        if "FT" in self.enabled:
            tags.append("FT")
        for tag in tags:
            self.add_module(
                f"mhaBlock{tag}",
                AttnResBlock(size, num_heads, hidden_factor_attn, dropout, dtype),
            )
            self.add_module(f"fnnBlock{tag}", FFNResBlock(size, hidden_factor, dropout, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mem = x
        h = x
        if "F" in self.enabled:
            h = self.fnnBlockF(self.mhaBlockF(h, mem))
        h = h.transpose(-3, -2)  # [N, F, T, D]
        mem_t = mem.transpose(-3, -2)
        if "T" in self.enabled:
            h = self.fnnBlockT(self.mhaBlockT(h, mem_t))
        if "All0" in self.enabled or "0All" in self.enabled:
            h0, h1 = h[..., :1, :, :], h[..., 1:, :, :]
            if "All0" in self.enabled:
                h1 = self.mhaBlockAll0(h1, mem_t[..., 0:1, :, :])
            if "0All" in self.enabled:
                flat = mem_t.reshape(*mem_t.shape[:-3], 1, -1, mem_t.shape[-1])
                h0 = self.mhaBlockAll0(h0, flat)
            h = self.fnnBlockAll0(torch.cat([h0, h1], dim=-3))
        if "FT" in self.enabled:
            nf, nt, d = h.shape[-3:]
            hf = h.reshape(*h.shape[:-3], nf * nt, d)
            memf = mem_t.reshape(*mem_t.shape[:-3], nf * nt, d)
            h = self.fnnBlockFT(self.mhaBlockFT(hf, memf)).reshape(h.shape)
        return h.transpose(-3, -2)


class ScaledInnerProductIntervalScorer(nn.Module):
    """S[e, b] = <q_e, k_b> * |e - b| + diag on e == b; the skip (noise)
    score is identically zero in V2.

    No dropout: the JAX scorer has a ``dropout`` field that it never
    applies, and the reference's ``scoreDropoutProb`` therefore changes
    nothing.  ``map`` stays a ``Sequential`` so its key is ``scorer.map.0``.

    ``score_dtype`` (the JAX package's field of that name): the fp32 map's q,
    k and diag are rounded to it, the product is emitted in it, and so is
    the length factor |e - b|.  In bf16 a length above 256 is itself
    rounded (8 significant bits); that rounding is part of the result.
    ``noise`` and the diag that ``decode_scores`` returns stay fp32."""

    def __init__(self, in_size: int, size: int, expansion_factor: int = 1,
                 score_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.e = size * expansion_factor
        self.score_dtype = score_dtype
        self.map = nn.Sequential(nn.Linear(in_size, 2 * self.e + 1))

    def _qkd(self, ctx: torch.Tensor):
        mapped = self.map(ctx)
        q, k, diag = torch.split(mapped, [self.e, self.e, 1], dim=-1)
        q = q / math.sqrt(self.e)
        if self.score_dtype is not None:
            q, k, diag = (a.to(self.score_dtype) for a in (q, k, diag))
        return q, k, diag

    def forward(self, ctx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ctx [N, P, T, D] -> (S [T, T, N, P] in [end, begin] layout,
        noise [T-1, N, P] zeros): the alpha layout without padding."""
        n, p, t, _ = ctx.shape
        s, noise, _ = self._padded_scores(ctx, t, p, False)
        return s.reshape(t, t, n, p), noise[:-1].reshape(t - 1, n, p).to(s.dtype)

    def _padded_scores(
        self, ctx: torch.Tensor, t_pad: int, p_pad: int, transposed: bool
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The padded, NEG-masked score tensor [t_pad, t_pad, N*p_pad],
        contiguous: [end, begin, lane] (alpha layout) or, ``transposed``,
        [begin, end, lane] (decode layout).  Also returns noise zeros
        [t_pad, N*p_pad] and diag [N, p_pad, t_pad] un-gated, zero in the
        padding.

        The length scale, diag add and padding mask run in place on the one
        [N, p_pad, t_pad, t_pad] product before its single transpose.  That
        is right under autograd too: the product is no saved input of any
        backward (matmul keeps q and k, the scale keeps the constant
        lengths), so the in-place writes only route the gradient."""
        q, k, diag = self._qkd(ctx)  # [N, P, T, E], diag [N, P, T, 1]
        n, p, t, _ = q.shape
        pad = (0, 0, 0, t_pad - t, 0, p_pad - p)
        q = torch.nn.functional.pad(q, pad)
        k = torch.nn.functional.pad(k, pad)
        a, c = (k, q) if transposed else (q, k)
        s = torch.matmul(a, c.transpose(-1, -2))  # [N, Pp, axis0, axis1]
        idx = torch.arange(t_pad, device=ctx.device)
        s.mul_((idx[:, None] - idx[None, :]).abs().to(s.dtype))
        diag_pad = torch.nn.functional.pad(diag[..., 0], (0, t_pad - t, 0, p_pad - p))
        s.diagonal(dim1=-2, dim2=-1).add_(diag_pad)
        s[:, p:] = NEG
        s[:, :, t:] = NEG
        s[:, :, :, t:] = NEG
        s = s.permute(2, 3, 0, 1).reshape(t_pad, t_pad, n * p_pad).contiguous()
        noise = torch.zeros(t_pad, n * p_pad, dtype=torch.float32, device=ctx.device)
        return s, noise, diag_pad

    def decode_scores(
        self, ctx: torch.Tensor, t_pad: int, p_pad: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode-layout scores for the Viterbi kernel: (s_t [t_pad, t_pad,
        N*p_pad] f32 or ``score_dtype``, [begin, end, lane], NEG outside
        t x t and P; noise [t_pad, N*p_pad] f32 zeros; diag [t_pad, N*p_pad]
        f32 un-gated, zero in the padding), all contiguous."""
        s_t, noise, diag_pad = self._padded_scores(ctx, t_pad, p_pad, True)
        diag_t = diag_pad.permute(2, 0, 1).reshape(t_pad, -1).float().contiguous()
        return s_t, noise, diag_t

    def train_scores(
        self, ctx: torch.Tensor, t_pad: int, p_pad: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Alpha-layout [end, begin, N*p_pad] scores for the logZ kernels
        (``ops/logz.log_z_padded``) and ``semicrf.eval_path_padded``, with
        noise zeros [t_pad, N*p_pad]."""
        s, noise, _ = self._padded_scores(ctx, t_pad, p_pad, False)
        return s, noise
