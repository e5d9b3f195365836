"""Axial-attention backbone.

Port of ``transkun_tpu/models/backbone.py`` with ``upsampleProjOnly=True``.
The public layout is the JAX package's: mel features ``[N, T, F, C]``
channels-last in, ``ctx [N, P, T, D]`` out.  The convolutions run in
PyTorch's NCHW with H = time and W = frequency.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from .layers import BasicBlock, Dropout, SpatialPositionEmbedding, grid_coords


def down_conv(base_size: int, dropout: float) -> nn.Sequential:
    """Strided conv patchifier, 8x in time and 4x in frequency, with the
    explicit asymmetric zero padding (4, 3) in time and (2, 1) in frequency.
    Weights sit at indices 1, 2, 5, 6, 9, 10, 13, 14 as in the reference."""
    b = base_size
    layers = [nn.ZeroPad2d((2, 1, 4, 3))]
    c_in = b
    for c, s in zip((2 * b, 4 * b, 4 * b), ((2, 1), (2, 2), (2, 2))):
        layers += [
            nn.Conv2d(c_in, c, 3, stride=s, padding=1),
            nn.GroupNorm(4, c, eps=1e-5),
            nn.GELU(),
            Dropout(dropout, tied_dims=(2, 3)),
        ]
        c_in = c
    layers += [nn.Conv2d(4 * b, 4 * b, 3, padding=1), nn.GroupNorm(4, 4 * b, eps=1e-5)]
    return nn.Sequential(*layers)


class UpConvSkip(nn.Module):
    """The 8x temporal upsample: a transposed conv with kernel == stride ==
    8, i.e. a dense map from ``d`` inputs to 8 steps of ``out`` outputs.

    ``weight`` keeps the reference ``ConvTranspose1d`` layout [in, out, 8].
    ``bias`` is [8*out] in step-major order (entry s*out + o is step s,
    channel o), one free bias per step as in the JAX package's Dense.  A
    reference state_dict holds the tied [out] form; loading tiles it 8x."""

    def __init__(self, d: int, out: int, steps: int = 8):
        super().__init__()
        self.out, self.steps = out, steps
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
        up = h @ w + self.bias
        return up.reshape(h.shape[0], h.shape[1] * self.steps, self.out)


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
    ):
        super().__init__()
        if not downsample_f or not upsample_proj_only:
            raise NotImplementedError(
                "only downsampleF=True, upsampleProjOnly=True are ported"
            )
        b = base_size
        d = 4 * b
        self.out_d = b * expansion_factor
        self.posEmbedBuilder = SpatialPositionEmbedding(b, 1, dropout)
        self.inputConv = nn.Conv2d(input_size, b, 3, padding=1)
        self.downConv = down_conv(b, dropout)
        self.posEmbedBuilderAttnTF = SpatialPositionEmbedding(d, 2, dropout)
        self.posEmbedBuilderAttnTE = SpatialPositionEmbedding(d, 2, dropout)
        self.encoderLayers = nn.ModuleList(
            BasicBlock(d, n_head, hidden_factor, hidden_factor_attn, enabled_attn, dropout)
            for _ in range(n_layers)
        )
        self.upConv1dSkip = UpConvSkip(d, self.out_d)
        # recompute each encoder layer in the backward pass (training only)
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.generator: Optional[torch.Generator] = None  # see set_dropout_generator

    def forward(self, x: torch.Tensor, output_indices: torch.Tensor) -> torch.Tensor:
        """x [N, T, F, C] mel features, output_indices [P] raw MIDI
        coordinates -> ctx [N, P, T, D] float32."""
        n, n_t, n_f, _ = x.shape
        dev = x.device
        pos_f = self.posEmbedBuilder(torch.arange(n_f, dtype=torch.float32, device=dev)[:, None])
        h = self.inputConv(x.permute(0, 3, 1, 2))  # [N, b, T, F]
        h = h + pos_f.t()[:, None, :]
        h = self.downConv(h).permute(0, 2, 3, 1)  # [N, T', F', 4b]

        # prepend one aggregation step (time) and one aggregation track (freq)
        h = torch.nn.functional.pad(h, (0, 0, 1, 0, 1, 0))
        tp, fp = h.shape[1], h.shape[2]
        coord_t = torch.arange(tp, dtype=torch.float32, device=dev)
        coord_f = torch.arange(fp, dtype=torch.float32, device=dev)
        h = h + self.posEmbedBuilderAttnTF(grid_coords(coord_t, coord_f))
        pos_te = self.posEmbedBuilderAttnTE(grid_coords(coord_t, output_indices.float()))
        h = torch.cat([h, pos_te.expand(n, *pos_te.shape)], dim=-2)  # [N, T', F'+P, 4b]

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
        up = self.upConv1dSkip(h.transpose(1, 2).reshape(n * p, tp - 1, d))[:, :n_t]
        return up.reshape(n, p, n_t, self.out_d).float()
