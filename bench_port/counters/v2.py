"""Model FLOPs of TransKun V2 from its configuration's shapes, the same
whatever implements the work: 2 per multiply-add of every product and
convolution of the forward pass (the DFT and mel products, the
convolutions, the position-embedding MLPs, the attention projections,
logits and weighted sums, the FFNs, the upsample, the scorer's map and its
[T, T] inner products).

Leaves out elementwise work, normalizations, softmax, the semi-CRF
recurrences and the walk; in transcription also the attribute heads,
which run on the decoded events (data-dependent and small)."""

import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from reference.frontend import _mel_filterbank  # noqa: E402

N_TRACKS = 90


def dft_bins(conf) -> int:
    fb = _mel_filterbank(conf["windowSize"] // 2 + 1, conf["f_min"], conf["f_max"], conf["n_mels"], conf["fs"])
    band = (fb.sum(axis=1) > 0).nonzero()[0]
    return int(band.max() - band.min() + 1)


def _conv_out(n, stride):
    return (n + 2 - 3) // stride + 1


def _pos_mlp(n_coords, coord_dim, d):
    return 2 * n_coords * (coord_dim * d + d * 4 * d + 4 * d * d)


def frontend_flops(conf, t: int) -> int:
    wins = conf["nExtraWins"] + 1
    b = dft_bins(conf)
    return 2 * 2 * t * wins * conf["windowSize"] * b + 2 * t * wins * b * conf["n_mels"]


def segment_flops(conf, t: int, batch: int = 1) -> int:
    """``batch`` items of ``t`` frames through frontend, backbone and scorer
    in one forward pass (the position embeddings are made once a pass)."""
    bs = conf["baseSize"]
    d = 4 * bs
    f = conf["n_mels"]
    wins = conf["nExtraWins"] + 1
    total = frontend_flops(conf, t)
    pos = _pos_mlp(f, 1, bs)
    total += 2 * t * f * bs * wins * 9
    t1, f1 = t + 7, f + 3
    t2, f2 = _conv_out(t1, 2), f1
    t3, f3 = _conv_out(t2, 2), _conv_out(f2, 2)
    t4, f4 = _conv_out(t3, 2), _conv_out(f3, 2)
    total += 2 * t2 * f2 * 2 * bs * bs * 9
    total += 2 * t3 * f3 * 4 * bs * 2 * bs * 9
    total += 2 * t4 * f4 * 4 * bs * 4 * bs * 9 * 2
    tp, fp = t4 + 1, f4 + 1
    cols = fp + N_TRACKS
    pos += _pos_mlp(tp * fp, 2, d) + _pos_mlp(tp * N_TRACKS, 2, d)
    heads = conf["nHead"]
    hidden = math.ceil(math.ceil(conf["hiddenFactorAttn"] * d) / heads) * heads
    ffn = math.ceil(d * conf["hiddenFactor"])
    tokens = tp * cols
    per_axis = 2 * tokens * d * hidden * 3 + 2 * tokens * hidden * d + 2 * tokens * 2 * d * ffn
    attn_f = 2 * 2 * tp * cols * cols * hidden
    attn_t = 2 * 2 * cols * tp * tp * hidden
    total += conf["nLayers"] * (2 * per_axis + attn_f + attn_t)
    out_d = bs * conf["scoringExpansionFactor"]
    total += 2 * N_TRACKS * (tp - 1) * d * 8 * out_d
    total += 2 * N_TRACKS * t * out_d * (2 * out_d + 1)
    total += 2 * N_TRACKS * t * t * out_d
    return batch * total + pos


def heads_flops(conf, n_pairs: int) -> int:
    """The velocity and refinement heads on ``n_pairs`` endpoint pairs."""
    x = 3 * conf["baseSize"] * conf["scoringExpansionFactor"]
    hv, hr = conf["velocityPredictorHiddenSize"], conf["refinedOFPredictorHiddenSize"]
    return 2 * n_pairs * (x * hv + hv * 128 + x * hr + hr * 4)


def train_step_flops(conf, batch: int, t: int, k: int) -> int:
    """Forward and backward (twice the forward) of a batch of ``batch``
    chunks of ``t`` frames with ``k`` label slots a track."""
    return 3 * (segment_flops(conf, t, batch) + heads_flops(conf, batch * N_TRACKS * k))
