"""Axial-attention backbone.

Port of ``transkun_tpu/models/backbone.py`` with ``upsampleProjOnly=True``.
The public layout is the JAX package's: mel features ``[N, T, F, C]``
channels-last in, ``ctx [N, P, T, D]`` out.  The convolutions run in
PyTorch's NCHW with H = time and W = frequency.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import BasicBlock, SpatialPositionEmbedding, grid_coords


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
            nn.Dropout2d(dropout),
        ]
        c_in = c
    layers += [nn.Conv2d(4 * b, 4 * b, 3, padding=1), nn.GroupNorm(4, 4 * b, eps=1e-5)]
    return nn.Sequential(*layers)


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
        # 8x temporal upsample: a transposed conv with kernel == stride == 8
        self.upConv1dSkip = nn.ConvTranspose1d(d, self.out_d, 8, stride=8)

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

        for layer in self.encoderLayers:
            h = layer(h)

        h = h[:, 1:, fp:]  # pitch tracks, without the t=0 aggregation step
        p, d = h.shape[2], h.shape[3]
        ht = h.transpose(1, 2).reshape(n * p, tp - 1, d)
        # the transposed conv as the dense map it is: [in, out, 8] -> [in, 8*out]
        w = self.upConv1dSkip.weight.permute(0, 2, 1).reshape(d, 8 * self.out_d)
        up = ht @ w + self.upConv1dSkip.bias.repeat(8)
        up = up.reshape(n * p, (tp - 1) * 8, self.out_d)[:, :n_t]
        return up.reshape(n, p, n_t, self.out_d).float()
