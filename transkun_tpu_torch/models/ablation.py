"""TransKun V1 (the NeurIPS 2021 system): frames -> mel -> CNN -> BiGRU ->
pairwise-feature scorer -> semi-CRF, in PyTorch: the training objective and
the decode.

Port of ``transkun_tpu/models/ablation.py`` (ref ``transkun/Model_ablation.py``
and ``Layers_ablation.py``).  Module and parameter names are the reference
model's, so a reference V1 ``.pt`` loads with ``load_state_dict`` as it is and
``transkun_tpu.utils.torch_convert.convert_state_dict_ablation`` reads a
state_dict of this module (``utils.convert.state_dict_from_flax_ablation`` is
its inverse).

Layouts: the conv stack runs NCHW with H = time and W = frequency; the GRU
runs batch-major [N, T, C]; the scorer takes time-major [T, N, C] and returns
the interval scores in the alpha layout [end, begin, N * P] and a learned
skip (noise) score [T-1, N * P].  Unlike V2's, that noise is not zero, so the
Viterbi, alpha and beta kernels run on the unpadded routes
(``semicrf.viterbi_backward_tables_best``, ``semicrf.log_z_best``), which pad
once and hand the learned noise on.

BatchNorm (``SyncBatchNorm``) keeps the reference's train-mode statistics
(biased variance to normalize, running variance ``ss / (n - 1) - mean**2``)
and, under data parallelism (``make_train_loss(group=...)``), sums them over
the group's ranks, differentiably.  Train and eval modes
are explicit, as in ``models/transkun.py``.  Segments are decoded one after
the other, the final ones shorter (not padded), as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.note import Note, resolve_overlapping
from ..ops import distributions as dist
from ..ops import frontend, semicrf
from ..parallel.dist import all_reduce_sum_differentiable
from ..utils import compute_param_size
from .layers import Dropout, set_dropout_generator
from .transkun import MelFrontend, _gather_ctx, target_midi_pitches


class AblationConfig:
    """The reference V1 ``ModelConfig`` (``Model_ablation.py:16-62``), as the
    JAX package's ``AblationConfig``."""

    def __init__(self):
        self.f_min = 30
        self.f_max = 8000
        self.n_mels = 229
        self.hopSize = 1024
        self.windowSize = 4096
        self.fs = 44100
        self.nExtraWins = 5
        self.preConvSpec = [
            {"outputSize": 48, "hiddenSize": 48, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
            {"outputSize": 64, "hiddenSize": 64, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
            {"outputSize": 92, "hiddenSize": 92, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
            {"outputSize": 128, "hiddenSize": 128, "kernelSize": 3, "stride": (1, 2), "dropoutProb": 0.0},
        ]
        self.ctxSize = 512
        self.nLayersCtx = 2
        self.rnnHiddenSize = 256
        self.lengthScaling = True
        self.postConv = True
        self.disableUnitary = False
        self.pitchEmbedSize = 256
        self.scoreDropoutProb = 0.1
        self.contextDropoutProb = 0.1
        self.velocityDropoutProb = 0.1
        self.refinedOFDropoutProb = 0.1
        # segment processing defaults (shared conventions with V2)
        self.segmentHopSizeInSecond = 8
        self.segmentSizeInSecond = 16

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AblationConfig":
        conf = cls()
        for k, v in d.items():
            setattr(conf, k, v)
        return conf

    def __repr__(self):
        return repr(self.__dict__)


Config = AblationConfig


def _pair(stride) -> Tuple[int, int]:
    return (stride, stride) if isinstance(stride, int) else tuple(stride)


class SyncBatchNorm(nn.Module):
    """BatchNorm over every axis but the channels (axis 1), with the
    reference SyncBN's train-mode rules (``SyncBN.py:112-143``): normalize
    with the biased ``E[x^2] - E[x]^2``; update the running statistics with
    momentum 0.01 and ``uvar = ss / (n - 1) - mean^2`` (which differs from
    the unbiased variance by ``n / (n - 1)`` on the mean^2 term; kept for
    parity).  Eval mode normalizes with the running statistics.  With a
    ``group`` (a ``torch.distributed`` group, set by ``set_sync_group``) the
    train-mode statistics (s, ss, n) are summed over its ranks by an
    autograd-aware all-reduce (``parallel.all_reduce_sum_differentiable``),
    whose backward sums the cotangents over the ranks as the transpose of
    the JAX package's ``psum`` does (``models/ablation.py:112-119``);
    without one they are this process's.
    ``num_batches_tracked`` counts train-mode calls, so that a reference
    state_dict loads strictly."""

    def __init__(self, num_features: int, momentum: float = 0.01, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        xf = x.float()
        if self.training:
            red = [0, *range(2, x.dim())]
            s = xf.sum(red)
            ss = (xf * xf).sum(red)
            n = float(xf.numel() // c)
            if self.group is not None:
                stats = torch.cat([s, ss, s.new_full((1,), n)])
                stats = all_reduce_sum_differentiable(stats, self.group)
                s, ss, n = stats[:c], stats[c : 2 * c], stats[2 * c]
            mean = s / n
            var = ss / n - mean * mean
            with torch.no_grad():
                m = self.momentum
                uvar = ss.detach() / (n - 1.0) - mean.detach() * mean.detach()
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean.detach())
                self.running_var.copy_((1.0 - m) * self.running_var + m * uvar)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, c) + (1,) * (x.dim() - 2)
        inv_std = torch.rsqrt(var + self.eps)
        y = (xf - mean.view(shape)) * inv_std.view(shape) * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def set_sync_group(module: nn.Module, group) -> None:
    """Point every ``SyncBatchNorm`` under ``module`` at ``group`` (None:
    this process's statistics alone)."""
    for m in module.modules():
        if isinstance(m, SyncBatchNorm):
            m.group = group


class ConvBlock(nn.Module):
    """Conv-BN-GELU twice, then an average pool of ``stride`` (flax's VALID:
    a ragged last column is dropped) (ref ``ConvBlock_ablation``).  x [N, C,
    T, F]."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 kernel_size: int = 3, stride=(1, 1)):
        super().__init__()
        pad = kernel_size // 2
        self.conv1 = nn.Conv2d(input_size, hidden_size, kernel_size, padding=pad)
        self.bn1 = SyncBatchNorm(hidden_size)
        self.conv2 = nn.Conv2d(hidden_size, output_size, kernel_size, padding=pad)
        self.bn2 = SyncBatchNorm(output_size)
        self.stride = _pair(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = F.gelu(self.bn1(self.conv1(x)))
        z = F.gelu(self.bn2(self.conv2(z)))
        if self.stride != (1, 1):
            z = F.avg_pool2d(z, self.stride, self.stride)
        return z


class PreLayer(nn.Module):
    def __init__(self, blocks: Sequence[ConvBlock]):
        super().__init__()
        self.layers = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class BiGRU(nn.Module):
    """A bidirectional GRU stack and its output projection (ref
    ``SimpleRNN``): x [N, T, C] -> [N, T, output_size].  Dropout between
    layers is ``nn.GRU``'s own, which draws from torch's global generator of
    x's device.  With ``self.generator`` set (``set_dropout_generator``, a
    generator a step) that generator is seeded from the step generator's
    seed for the call and restored after, so the masks follow the step's
    stream (a rank's own in data parallelism).  On a card cuDNN keeps its
    own dropout state, seeded once a process at the first train-mode call:
    from the first step's seed."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, n_layers: int,
                 dropout: float = 0.0):
        super().__init__()
        self.grus = nn.GRU(input_size, hidden_size, n_layers, batch_first=True,
                           dropout=dropout if n_layers > 1 else 0.0, bidirectional=True)
        self.outProj = nn.Linear(2 * hidden_size, output_size)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.grus.dropout > 0 and self.generator is not None):
            return self.outProj(self.grus(x)[0])
        on_card = x.device.type == "cuda"
        with torch.random.fork_rng(devices=[x.device] if on_card else []):
            gen = torch.cuda.default_generators[x.device.index] if on_card else torch.default_generator
            gen.manual_seed(self.generator.initial_seed())
            return self.outProj(self.grus(x)[0])


def _mlp3(input_size: int, hidden1: int, hidden2: int, output_size: int, dropout: float) -> nn.Sequential:
    """Linear -> GELU -> Dropout -> Linear -> GELU -> Dropout -> Linear (the
    weights at indices 0, 3 and 6, as in the reference)."""
    return nn.Sequential(
        nn.Linear(input_size, hidden1), nn.GELU(), Dropout(dropout),
        nn.Linear(hidden1, hidden2), nn.GELU(), Dropout(dropout),
        nn.Linear(hidden2, output_size),
    )


class ScoreMatrixPostProcessor(nn.Module):
    """Two 3x3 convolutions over the [end, begin] score image, the first
    padded by 2 and the second VALID, so the image keeps its size (ref
    ``Layers_ablation.py:94-114``)."""

    def __init__(self, n_target: int, n_hidden: int, dropout: float = 0.0):
        super().__init__()
        self.map = nn.Sequential(
            nn.Conv2d(n_target, n_hidden, 3, padding=2), nn.GELU(), Dropout(dropout),
            nn.Conv2d(n_hidden, n_target, 3),
        )

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        # s [nEnd, nBegin, N, P] <-> image [N, P, nEnd, nBegin]
        return self.map(s.permute(2, 3, 0, 1)).permute(2, 3, 0, 1)


class PairwiseFeatureBatch(nn.Module):
    """Scores every (begin, end) pair from the two endpoints' features and
    the first three moments of the features over the span, through a
    3-layer MLP, and every skip t -> t+1 from [x_t, x_{t+1}, x_t x_{t+1}]
    (ref ``Layers_ablation.py:116-241``).

    As the JAX package: rows of ends in blocks of ``row_block`` (indices
    clamped to T-1), the whole row of begins each, spans' lengths clamped to
    at least 1 (the upper triangle is masked afterwards, and a zero length
    would put NaN into the backward); moments from cumulative sums with a
    zero row in front; the upper triangle zeroed before the post-conv; each
    score scaled by ``max(|b - e|, 1)``."""

    def __init__(self, input_size: int, output_size: int, dropout: float = 0.0,
                 length_scaling: bool = True, post_conv: bool = True,
                 disable_unitary: bool = False, hidden_size: Optional[int] = None,
                 row_block: int = 16):
        super().__init__()
        hidden = hidden_size or output_size * 4
        self.length_scaling, self.disable_unitary, self.row_block = length_scaling, disable_unitary, row_block
        self.scoreMap = _mlp3(6 * input_size, hidden, hidden, output_size, dropout)
        self.scoreMapSkip = _mlp3(3 * input_size, hidden, hidden, output_size, dropout)
        self.post = ScoreMatrixPostProcessor(output_size, output_size * 3, dropout) if post_conv else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [T, N, C] -> (s [T(end), T(begin), N, P], s_skip [T-1, N, P])."""
        t, n, c = x.shape
        zero = x.new_zeros(1, n, c)
        x_cum = torch.cumsum(torch.cat([zero, x]), 0)
        x2_cum = torch.cumsum(torch.cat([zero, x**2]), 0)
        x3_cum = torch.cumsum(torch.cat([zero, x**3]), 0)
        idx_b = torch.arange(t, device=x.device)
        k = self.row_block
        blocks = []
        for a0 in range(0, t, k):
            idx_a = torch.clamp(a0 + torch.arange(k, device=x.device), max=t - 1)
            cur_a = x[idx_a][:, None]  # [K, 1, N, C]
            cur_b = x[None]  # [1, T, N, C]
            length = (idx_a[:, None] - idx_b[None, :] + 1).to(x.dtype)
            length = torch.clamp(length, min=1.0)[:, :, None, None]
            m1 = (x_cum[idx_a + 1][:, None] - x_cum[None, :t]) / length
            m2 = (x2_cum[idx_a + 1][:, None] - x2_cum[None, :t]) / length
            m3 = (x3_cum[idx_a + 1][:, None] - x3_cum[None, :t]) / length
            inp = torch.cat([cur_a.expand(k, t, n, c), cur_b.expand(k, t, n, c), cur_a * cur_b,
                             m1, m2, m3], dim=-1)
            blocks.append(self.scoreMap(inp))  # [K, T, N, P]
        s = torch.cat(blocks)[:t]
        tril = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[:, :, None, None]
        s = torch.where(tril, s, 0.0)
        if self.post is not None:
            s = self.post(s)
        if self.length_scaling:
            len_ba = torch.clamp((idx_b[:, None] - idx_b[None, :]).abs().to(s.dtype), min=1.0)
            s = len_ba[:, :, None, None] * s
        s_skip = self.scoreMapSkip(torch.cat([x[:-1], x[1:], x[:-1] * x[1:]], dim=-1))
        if self.disable_unitary:
            s_skip = s_skip * 0
        return s, s_skip


class TransKunAblationModule(nn.Module):
    """The on-device part of the V1 model (ref ``Model_ablation.py:118-269``).
    ``compute_dtype`` goes to the mel frontend only, as in the JAX package."""

    def __init__(self, conf: AblationConfig, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
        self.conf = conf
        n_sym = len(target_midi_pitches())
        self.framewiseFeatureExtractor = MelFrontend(conf, compute_dtype)
        blocks, channels, n_freq = [], conf.nExtraWins + 1, conf.n_mels
        for spec in conf.preConvSpec:
            stride = _pair(spec["stride"])
            blocks.append(ConvBlock(channels, spec["outputSize"], spec["hiddenSize"],
                                    spec["kernelSize"], stride))
            channels, n_freq = spec["outputSize"], n_freq // stride[1]
        self.preLayer = PreLayer(blocks)
        self.inputProj = nn.Sequential(nn.Linear(channels * n_freq, conf.ctxSize))
        self.contextModel = BiGRU(conf.ctxSize, conf.rnnHiddenSize, conf.ctxSize, conf.nLayersCtx,
                                  conf.contextDropoutProb)
        self.pairwiseScore = PairwiseFeatureBatch(
            conf.ctxSize, n_sym, dropout=conf.scoreDropoutProb,
            length_scaling=getattr(conf, "lengthScaling", True), post_conv=conf.postConv,
            disable_unitary=getattr(conf, "disableUnitary", False),
        )
        self.pitchEmbedding = nn.Embedding(n_sym, conf.pitchEmbedSize)
        head_in = 3 * conf.ctxSize + conf.pitchEmbedSize
        self.velocityPredictor = _mlp3(head_in, 512, 512, 128, conf.velocityDropoutProb)
        self.refinedOFPredictor = _mlp3(head_in, 512, 128, 2, conf.refinedOFDropoutProb)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights drawn from ``generator`` with the initializers of
        the JAX package's flax modules: LeCun normal (truncated at 2 sigma)
        for dense, conv and the GRU's input weights, orthogonal recurrent
        weights, N(0, 1/90) pitch embeddings, zero biases; BatchNorm and the
        analysis windows at their fixed initial values."""

        def lecun_normal(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                lecun_normal(mod.weight, mod.weight[0].numel())
                mod.bias.zero_()
            elif isinstance(mod, nn.GRU):
                h = mod.hidden_size
                for name, p in mod.named_parameters():
                    if name.startswith("weight_ih"):
                        for gate in p.split(h):
                            lecun_normal(gate, p.shape[1])
                    elif name.startswith("weight_hh"):
                        for gate in p.split(h):
                            nn.init.orthogonal_(gate, generator=generator)
                    else:
                        p.zero_()
            elif isinstance(mod, SyncBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                mod.num_batches_tracked.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[0]), generator=generator)
        init = frontend.gaussian_windows_init(self.conf.nExtraWins)
        win_gen = self.framewiseFeatureExtractor.spectrogramExtractor.winGen
        win_gen.sigma.copy_(torch.from_numpy(init["sigma"]))
        win_gen.center.copy_(torch.from_numpy(init["center"]))

    def process_frames(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """frames [N, C, T, W] -> (s [T, T, N*P] alpha layout, s_skip [T-1,
        N*P], ctx [N, T, ctxSize]), in the module's current mode."""
        h = self.preLayer(self.framewiseFeatureExtractor(frames).permute(0, 3, 1, 2))
        n, c, t, f = h.shape
        # flatten (channel, freq) in that order (ref ``Model_ablation.py:239``)
        ctx = self.contextModel(self.inputProj(h.permute(0, 2, 1, 3).reshape(n, t, c * f)))
        s, s_skip = self.pairwiseScore(ctx.transpose(0, 1))
        return s.reshape(t, t, -1), s_skip.reshape(t - 1, -1), ctx

    def attributes(self, ctx_a: torch.Tensor, ctx_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Endpoint contexts [N, P, K, D] -> (velocity logits [..., 128],
        refined onset/offset logits [..., 2]); V1 appends a learned pitch
        embedding and has no presence head."""
        p = ctx_a.shape[1]
        pe = self.pitchEmbedding.weight[:p][None, :, None, :].expand(*ctx_a.shape[:3], -1)
        x = torch.cat([ctx_a, ctx_b, ctx_a * ctx_b, pe], dim=-1)
        return self.velocityPredictor(x), self.refinedOFPredictor(x)


Labels = Tuple[torch.Tensor, ...]


def log_prob_padded(module: TransKunAblationModule, frames: torch.Tensor, labels: Labels) -> torch.Tensor:
    """The V1 training objective: per-track log-probability [N, P] (ref
    ``log_prob``, ``Model_ablation.py:271-364``), in the module's current
    mode (train mode updates the BatchNorm running statistics).

    labels = (begins, ends, mask, velocity, refine, presence) from
    ``data.labels.encode_batch``, as tensors on the module's device; V1 has
    no presence term."""
    begins, ends, mask, velocity, refine, _presence = labels
    n, p, k = begins.shape
    s, s_skip, ctx = module.process_frames(frames)
    path = semicrf.eval_path_padded(
        s, s_skip, begins.reshape(n * p, k), ends.reshape(n * p, k), mask.reshape(n * p, k))
    logp = (path - semicrf.log_z_best(s, s_skip)).reshape(n, p)

    vel_logits, of_value = module.attributes(_gather_ctx(ctx[:, None], begins), _gather_ctx(ctx[:, None], ends))
    logp_vel = torch.log_softmax(vel_logits, dim=-1).gather(-1, velocity[..., None].long())[..., 0]
    refined = refine * 0.99 + 0.5
    logp_of = dist.continuous_bernoulli_log_prob(of_value, refined).sum(-1)
    attr = torch.where(mask.bool(), logp_vel + logp_of, 0.0).sum(-1)
    return logp + attr


class TransKunAblation:
    """Host-facing V1 model: the training objective, and the segment-wise
    transcription with forcedStartPos stitching (no presence flags)."""

    Config = AblationConfig

    def __init__(self, conf: AblationConfig, device=None, seed: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``device`` is the card (``cuda``) unless given: without a CUDA
        device, pass ``device="cpu"``, else this raises.  On the card TF32
        is turned off for matmuls and cuDNN (the convolutions and the GRU),
        as the port's CLIs do: the model computes in fp32, as the JAX
        package's does.  ``seed`` draws random weights from a
        ``torch.Generator``; without it, load weights with
        ``load_state_dict``.  ``compute_dtype`` is the mel frontend's."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                'TransKunAblation runs on the card unless asked for the CPU: CUDA is not '
                'available, pass device="cpu"'
            )
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.conf = conf
        self.device = device
        self.fs = conf.fs
        self.hopSize = conf.hopSize
        self.windowSize = conf.windowSize
        self.segmentSizeInSecond = conf.segmentSizeInSecond
        self.segmentHopSizeInSecond = conf.segmentHopSizeInSecond
        self.targetMIDIPitch = target_midi_pitches()
        module = TransKunAblationModule(conf, compute_dtype)
        if seed is not None:
            module.reset_parameters(torch.Generator().manual_seed(seed))
        self.module = module.to(self.device).eval()

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict, strict=True)

    def param_count(self) -> float:
        """Parameters in millions (the running statistics are buffers)."""
        return compute_param_size(self.module)

    # -- training -------------------------------------------------------------

    def frames(self, audio_batch: np.ndarray) -> torch.Tensor:
        """audio [N, nSample, C] -> frames [N, C, T, W] on the device."""
        x = torch.from_numpy(np.ascontiguousarray(np.swapaxes(audio_batch, -1, -2), np.float32))
        return frontend.make_frame(x.to(self.device), self.hopSize, self.windowSize)

    def labels(self, notes_batch, max_events: int = 32, k_sync=None) -> Labels:
        """Note lists -> padded label tensors on the device (``k_sync``: see
        ``data.labels.encode_batch``)."""
        from ..data.labels import encode_batch

        labels = encode_batch(notes_batch, self.hopSize / self.fs, self.targetMIDIPitch, max_events,
                              k_sync=k_sync)
        return tuple(torch.from_numpy(a).to(self.device) for a in labels.astuple())

    def make_train_loss(self, group=None):
        """loss_fn(frames, labels, generator) -> logp [N, P] in train mode
        (BatchNorm on the batch's statistics, summed over ``group``'s ranks
        where one is given, its running statistics updated), with the
        scorer's, heads' and GRU's dropout masks drawn from ``generator``
        (the GRU's: see ``BiGRU``)."""

        def loss_fn(frames, labels, generator):
            self.module.train()
            set_dropout_generator(self.module, generator)
            set_sync_group(self.module, group)
            return log_prob_padded(self.module, frames, labels)

        return loss_fn

    def log_prob(self, audio_batch: np.ndarray, notes_batch, max_events: int = 32) -> torch.Tensor:
        """audio [N, nSample, C] + note lists -> per-track log-probability
        [N, P], in eval mode."""
        self.module.eval()
        return log_prob_padded(self.module, self.frames(audio_batch), self.labels(notes_batch, max_events))

    # -- decode -----------------------------------------------------------------

    @torch.no_grad()
    def _decode(self, frames: torch.Tensor):
        """frames -> (ptr [T-1, N*P] int32, diag [T, N*P] bool, ctx), the
        Viterbi tables from the learned noise (the kernel on the card)."""
        self.module.eval()
        s, s_skip, ctx = self.module.process_frames(frames)
        ptr, diag = semicrf.viterbi_backward_tables_best(s, s_skip)
        return ptr, diag, ctx

    @torch.no_grad()
    def transcribe_frames(
        self,
        frames: torch.Tensor,
        forced_start_pos: Optional[Sequence[int]] = None,
        velocity_criterion: str = "hamming",
        onset_bound: Optional[int] = None,
    ) -> Tuple[List[List[Note]], List[int]]:
        """Decode one batch of segments [N, C, T, W] -> (notes per segment,
        lastP per track) (ref ``Model_ablation.py:565-733``): no presence
        flags, lastP the end of each track's last decoded interval.  The
        velocity is the argmax whatever ``velocity_criterion`` says, as in
        the JAX package."""
        n_batch = frames.shape[0]
        n_sym = len(self.targetMIDIPitch)
        ptr, diag, ctx = self._decode(frames)
        path = semicrf.backtrack_backward(ptr.cpu().numpy(), diag.cpu().numpy(), forced_start_pos)
        if onset_bound is not None:
            path = [[e for e in p if e[0] < onset_bound] for p in path]
        last_p = [p[-1][1] if p else 0 for p in path]
        intervals_batch = [path[i * n_sym : (i + 1) * n_sym] for i in range(n_batch)]
        if sum(len(p) for p in path) == 0:
            return [[] for _ in range(n_batch)], last_p

        kmax = max(len(p) for p in path)
        k = 8
        while k < kmax:
            k *= 2
        begins = np.zeros((n_batch, n_sym, k), np.int64)
        ends = np.zeros((n_batch, n_sym, k), np.int64)
        for i in range(n_batch):
            for j in range(n_sym):
                for e_idx, (b, e) in enumerate(intervals_batch[i][j]):
                    begins[i, j, e_idx] = b
                    ends[i, j, e_idx] = e
        ctx = ctx[:, None]
        vel_logits, of_value = self.module.attributes(
            _gather_ctx(ctx, torch.from_numpy(begins).to(ctx.device)),
            _gather_ctx(ctx, torch.from_numpy(ends).to(ctx.device)),
        )
        velocity = torch.argmax(vel_logits, dim=-1).cpu().numpy()
        of = torch.clamp((dist.continuous_bernoulli_mean(of_value) - 0.5) / 0.99, -0.5, 0.5)
        of = of.cpu().numpy().astype(np.float64)

        frame_dur = self.hopSize / self.fs
        notes: List[List[Note]] = [[] for _ in range(n_batch)]
        for i in range(n_batch):
            for j, event_type in enumerate(self.targetMIDIPitch):
                last_end = 0.0
                for e_idx, interval in enumerate(intervals_batch[i][j]):
                    off = of[i, j, e_idx]
                    start = (interval[0] + off[0]) * frame_dur
                    end = (interval[1] + off[1]) * frame_dur
                    start = max(start, last_end)
                    end = max(end, start + 1e-8)
                    last_end = end
                    notes[i].append(Note(start, end, event_type, int(velocity[i, j, e_idx])))
            notes[i].sort(key=lambda x: (x.start, x.end, x.pitch))
        return notes, last_p

    def compute_stats_mireval(self, audio_batch: np.ndarray, notes_batch) -> Dict[str, float]:
        """Note-with-offset counts by full decode and matching (ref
        ``Model_ablation.py:366-412``)."""
        from ..eval.evaluation import compare_transcription

        notes_est, _ = self.transcribe_frames(self.frames(audio_batch))
        n_gt = n_est = n_correct = 0.0
        for est, gt in zip(notes_est, notes_batch):
            metrics = compare_transcription(est, gt)
            _, r, _, _ = metrics["note+offset"]
            n_gt += metrics["nGT"]
            n_est += metrics["nEst"]
            n_correct += r * metrics["nGT"]
        return {"nGT": n_gt, "nEst": n_est, "nCorrect": n_correct}

    @torch.no_grad()
    def compute_stats(self, audio_batch: np.ndarray, notes_batch) -> Dict[str, float]:
        """Decode-vs-GT bracket and framewise counts, as V2's without the
        forced attribute errors, which V1 reports as 0."""
        from ..data.labels import prepare_intervals
        from ..eval.evaluation import compare_bracket, compare_framewise

        ptr, diag, _ = self._decode(self.frames(audio_batch))
        path = semicrf.backtrack_backward(ptr.cpu().numpy(), diag.cpu().numpy())
        flat_gt = []
        for notes in notes_batch:
            flat_gt.extend(prepare_intervals(notes, self.hopSize / self.fs, self.targetMIDIPitch)["intervals"])
        stats = [compare_bracket(a, b) for a, b in zip(path, flat_gt)]
        fw = [compare_framewise(a, b) for a, b in zip(path, flat_gt)]
        return {
            "nGT": sum(s[0] for s in stats),
            "nEst": sum(s[1] for s in stats),
            "nCorrect": sum(s[2] for s in stats),
            "nGTFramewise": sum(s[0] for s in fw),
            "nEstFramewise": sum(s[1] for s in fw),
            "nCorrectFramewise": sum(s[2] for s in fw),
            "seVelocityForced": 0.0,
            "seOFForced": 0.0,
        }

    @torch.no_grad()
    def transcribe(
        self,
        x: np.ndarray,
        step_in_second: float = 10,
        segment_size_in_second: float = 20,
        discard_second_half: bool = False,
    ) -> List[Note]:
        """V1 streaming transcription (ref ``Model_ablation.py:735-816``):
        segments of ``segment_size_in_second`` every ``step_in_second``,
        decoded one after the other with forcedStartPos stitching, no event
        merging.  The final segments are decoded shorter, not padded (padding
        would change the backward DP's values inside the real frames).
        ``onset_bound`` is the step in samples, compared with frame indices,
        as in the JAX package.

        x: [nSample, nChannel] float waveform at conf.fs (int16 is read as
        x / 32768)."""
        self.module.eval()
        x = np.asarray(x)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = x.T.astype(np.float32)  # [C, nSample]
        pad_time_begin = segment_size_in_second - step_in_second
        pad = math.ceil(pad_time_begin * self.fs)
        audio = torch.from_numpy(np.pad(x, ((0, 0), (pad, pad)))).to(self.device)
        n_sample = audio.shape[-1]

        events_all: List[Note] = []
        start_pos = [math.floor(pad_time_begin * self.fs / self.hopSize)] * len(self.targetMIDIPitch)
        step_size = math.ceil(step_in_second * self.fs / self.hopSize) * self.hopSize
        segment_size = math.ceil(segment_size_in_second * self.fs)
        onset_bound = step_size if discard_second_half else None
        for i in range(0, n_sample, step_size):
            j = min(i + segment_size, n_sample)
            begin_time = i / self.fs - pad_time_begin
            frames = frontend.make_frame(audio[:, i:j], self.hopSize, self.windowSize)[None]
            cur_events, last_p = self.transcribe_frames(
                frames, forced_start_pos=start_pos, velocity_criterion="hamming", onset_bound=onset_bound)
            cur_events = cur_events[0]
            start_pos = [max(k - int(step_size / self.hopSize), 0) for k in last_p]
            for e in cur_events:
                e.start += begin_time
                e.end += begin_time
                e.start = max(e.start, 0)
                e.end = max(e.end, e.start + 1e-5)
            events_all.extend(cur_events)
        return resolve_overlapping(events_all)
