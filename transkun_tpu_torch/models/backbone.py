"""Axial-attention backbone.

Port of ``transkun_tpu/models/backbone.py``: ``downsample_f`` either way,
and the full upsample stack (``upsample_proj_only=False``, ``UpConv1d``)
beside the projection.  The public layout is the JAX package's: mel
features ``[N, T, F, C]`` channels-last in, ``ctx [N, P, T, D]`` out.  The
convolutions run in PyTorch's NCHW with H = time and W = frequency.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from .layers import BasicBlock, Dropout, SpatialPositionEmbedding, grid_coords


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv(x)`` computed in ``dtype`` as flax's ``Conv(dtype=...)``: input,
    weight and bias cast, the convolution rounded, then the bias added.
    ``None`` is ``conv(x)`` as it stands."""
    if dtype is None:
        return conv(x)
    y = torch.nn.functional.conv2d(
        x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding
    )
    return y + conv.bias.to(dtype)[:, None, None]


def conv1d(conv: nn.Conv1d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv2d`` for an ``nn.Conv1d``."""
    if dtype is None:
        return conv(x)
    y = torch.nn.functional.conv1d(
        x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding
    )
    return y + conv.bias.to(dtype)[:, None]


class DownConv(nn.Sequential):
    """Strided conv patchifier, 8x in time and 4x in frequency (strides
    (2, 1), (2, 2), (2, 2)), with the explicit asymmetric zero padding (4, 3)
    in time and (2, 1) in frequency; with ``downsample_f=False`` 8x in time
    only (strides (2, 1) three times) and no padding in frequency.  Weights
    sit at indices 1, 2, 5, 6, 9, 10, 13, 14 as in the reference.

    With a ``dtype`` the convolutions run in it and each GroupNorm, which
    has none in the JAX package, takes its input back to fp32 and returns
    fp32: the stack alternates the two."""

    def __init__(self, base_size: int, dropout: float, dtype: Optional[torch.dtype] = None,
                 downsample_f: bool = True):
        b = base_size
        if downsample_f:
            layers, strides = [nn.ZeroPad2d((2, 1, 4, 3))], ((2, 1), (2, 2), (2, 2))
        else:
            layers, strides = [nn.ZeroPad2d((0, 0, 4, 3))], ((2, 1),) * 3
        c_in = b
        for c, s in zip((2 * b, 4 * b, 4 * b), strides):
            layers += [
                nn.Conv2d(c_in, c, 3, stride=s, padding=1),
                nn.GroupNorm(4, c, eps=1e-5),
                nn.GELU(),
                Dropout(dropout, tied_dims=(2, 3)),
            ]
            c_in = c
        layers += [nn.Conv2d(4 * b, 4 * b, 3, padding=1), nn.GroupNorm(4, 4 * b, eps=1e-5)]
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                h = conv2d(layer, h, self.dtype)
            elif isinstance(layer, nn.GroupNorm):
                h = layer(h.float())
            else:
                h = layer(h)
        return h


class UpConvSkip(nn.Module):
    """A temporal upsample by ``steps`` (8 for ``upConv1dSkip``, 2 in each
    stage of ``UpConv1d``): a transposed conv with kernel == stride ==
    steps, i.e. a dense map from ``d`` inputs to ``steps`` steps of ``out``
    outputs.

    ``weight`` keeps the reference ``ConvTranspose1d`` layout [in, out,
    steps].  ``bias`` is [steps*out] in step-major order (entry s*out + o is
    step s, channel o), one free bias per step as in the JAX package's
    Dense.  A reference state_dict holds the tied [out] form; loading tiles
    it ``steps`` times."""

    def __init__(self, d: int, out: int, steps: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out, self.steps, self.dtype = out, steps, dtype
        self.weight = nn.Parameter(torch.empty(d, out, steps))
        self.bias = nn.Parameter(torch.zeros(steps * out))
        self._register_load_state_dict_pre_hook(self._tile_tied_bias)

    def _tile_tied_bias(self, state_dict, prefix, *_args):
        bias = state_dict.get(prefix + "bias")
        if bias is not None and bias.shape == (self.out,):
            state_dict[prefix + "bias"] = bias.repeat(self.steps)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h [B, T, d] -> [B, T * steps, out]."""
        d = self.weight.shape[0]
        w = self.weight.permute(0, 2, 1).reshape(d, self.steps * self.out)
        bias = self.bias
        if self.dtype is not None:
            h, w, bias = h.to(self.dtype), w.to(self.dtype), bias.to(self.dtype)
        up = h @ w + bias
        return up.reshape(h.shape[0], h.shape[1] * self.steps, self.out)


class UpConv1d(nn.Sequential):
    """The full 8x upsample stack (the JAX package's ``UpConv1d``): three
    stages of a transposed conv with kernel == stride == 2, a conv with
    kernel 3, GroupNorm and GELU, the last stage without norm or
    activation; channels 4b -> 4b -> 2b -> b.  The transposed convs, convs
    and norms sit at the reference's indices 0, 1, 2 / 4, 5, 6 / 8, 9.
    Channels-last in and out: [B, T, 4b] -> [B, 8T, b].  With a ``dtype``
    the convolutions run in it and each GroupNorm returns fp32, as in
    ``DownConv``."""

    def __init__(self, base_size: int, dtype: Optional[torch.dtype] = None):
        b = base_size
        layers, c_in = [], 4 * b
        for c, last in ((4 * b, False), (2 * b, False), (b, True)):
            layers += [UpConvSkip(c_in, c, steps=2, dtype=dtype), nn.Conv1d(c, c, 3, padding=1)]
            if not last:
                layers += [nn.GroupNorm(4, c, eps=1e-5), nn.GELU()]
            c_in = c
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h.transpose(1, 2)  # [B, C, T] for the convs and the norms
        for layer in self:
            if isinstance(layer, UpConvSkip):
                h = layer(h.transpose(1, 2)).transpose(1, 2)
            elif isinstance(layer, nn.Conv1d):
                h = conv1d(layer, h, self.dtype)
            elif isinstance(layer, nn.GroupNorm):
                h = layer(h.float())
            else:
                h = layer(h)
        return h.transpose(1, 2)


def _replayed(layer: nn.Module, generator: Optional[torch.Generator]):
    """``layer`` as a function that first rewinds ``generator`` to its state
    at this call: a no-op on the forward pass, and on the checkpointed
    recompute it makes the dropout masks those of the forward pass
    (``preserve_rng_state`` covers only the global RNG)."""
    state = generator.get_state() if generator is not None else None

    def run(x):
        if state is not None:
            generator.set_state(state)
        return layer(x)

    return run


class Backbone(nn.Module):
    def __init__(
        self,
        input_size: int,
        base_size: int,
        n_head: int,
        hidden_factor: float = 2.0,
        hidden_factor_attn: float = 1.0,
        expansion_factor: int = 1,
        dropout: float = 0.0,
        n_layers: int = 4,
        enabled_attn: Sequence[str] = ("F", "T"),
        downsample_f: bool = True,
        upsample_proj_only: bool = True,
        use_gradient_checkpoint: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        """``dtype``: the compute dtype of the convolutions, the encoder
        stack and the upsample; the norms, the position embeddings and the
        returned ctx are fp32 (the JAX package's placement).
        ``upsample_proj_only=False`` adds ``UpConv1d`` to the projection,
        which the JAX package allows only with ``expansion_factor`` 1."""
        super().__init__()
        self.dtype = dtype
        if not upsample_proj_only and expansion_factor != 1:
            # the JAX package's assertion, and its message
            raise ValueError(
                "upsample_proj_only=False requires expansion_factor == 1 "
                "(upConv1d ends at baseSize channels, ref "
                "LayersTransformer.py:533,646)"
            )
        b = base_size
        d = 4 * b
        self.out_d = b * expansion_factor
        self.posEmbedBuilder = SpatialPositionEmbedding(b, 1, dropout)
        self.inputConv = nn.Conv2d(input_size, b, 3, padding=1)
        self.downConv = DownConv(b, dropout, dtype, downsample_f)
        self.posEmbedBuilderAttnTF = SpatialPositionEmbedding(d, 2, dropout)
        self.posEmbedBuilderAttnTE = SpatialPositionEmbedding(d, 2, dropout)
        self.encoderLayers = nn.ModuleList(
            BasicBlock(d, n_head, hidden_factor, hidden_factor_attn, enabled_attn, dropout, dtype)
            for _ in range(n_layers)
        )
        self.upConv1dSkip = UpConvSkip(d, self.out_d, dtype=dtype)
        self.upConv1d = None if upsample_proj_only else UpConv1d(b, dtype)
        # recompute each encoder layer in the backward pass (training only)
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.generator: Optional[torch.Generator] = None  # see set_dropout_generator

    def forward(self, x: torch.Tensor, output_indices: torch.Tensor) -> torch.Tensor:
        """x [N, T, F, C] mel features, output_indices [P] raw MIDI
        coordinates -> ctx [N, P, T, D] float32."""
        n, n_t, n_f, _ = x.shape
        dev = x.device
        pos_f = self.posEmbedBuilder(torch.arange(n_f, dtype=torch.float32, device=dev)[:, None])
        h = conv2d(self.inputConv, x.permute(0, 3, 1, 2), self.dtype)  # [N, b, T, F]
        h = h + pos_f.t()[:, None, :]  # fp32: the embedding has no dtype
        h = self.downConv(h.to(self.dtype or h.dtype)).permute(0, 2, 3, 1)  # [N, T', F', 4b]

        # prepend one aggregation step (time) and one aggregation track (freq)
        h = torch.nn.functional.pad(h, (0, 0, 1, 0, 1, 0))
        tp, fp = h.shape[1], h.shape[2]
        coord_t = torch.arange(tp, dtype=torch.float32, device=dev)
        coord_f = torch.arange(fp, dtype=torch.float32, device=dev)
        h = h + self.posEmbedBuilderAttnTF(grid_coords(coord_t, coord_f))
        pos_te = self.posEmbedBuilderAttnTE(grid_coords(coord_t, output_indices.float()))
        h = torch.cat([h, pos_te.expand(n, *pos_te.shape)], dim=-2)  # [N, T', F'+P, 4b]
        # the residual stream runs in the compute dtype through the encoder
        h = h.to(self.dtype or h.dtype)

        remat = self.use_gradient_checkpoint and self.training and torch.is_grad_enabled()
        for layer in self.encoderLayers:
            if remat:
                h = torch.utils.checkpoint.checkpoint(
                    _replayed(layer, self.generator), h, use_reentrant=False
                )
            else:
                h = layer(h)

        h = h[:, 1:, fp:]  # pitch tracks, without the t=0 aggregation step
        p, d = h.shape[2], h.shape[3]
        ht = h.transpose(1, 2).reshape(n * p, tp - 1, d)
        up = self.upConv1dSkip(ht)
        if self.upConv1d is not None:
            up = up + self.upConv1d(ht)
        return up[:, :n_t].reshape(n, p, n_t, self.out_d).float()
