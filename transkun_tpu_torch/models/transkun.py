"""TransKun V2: frames -> mel -> backbone -> interval scores -> semi-CRF,
in PyTorch: the training objective and the decode.

Port of ``transkun_tpu/models/transkun.py``.  Transcription follows the JAX
package's default route: ``transcribe`` is ``_transcribe_dispatch`` followed
by ``_transcribe_finish``.  The dispatch enqueues every group of
``segment_batch`` segments (``_fused_group``): the Viterbi tables, the
pointer walk and the stitching chain (``ops/walk.py``, one kernel launch a
group on the card), the compaction of the events into a ``k_budget`` buffer
and the attribute heads on the real events, with the next group's forced
start passed device to device, and the outputs copied to pinned host
buffers; it waits for nothing.  The finish waits for the piece's event,
assembles every group's events at once and, from the first group whose
walk or budget overflowed, redoes the rest on the host-walk route
(``_transcribe_host_walk`` -> ``_process_group``), which gives the same
notes.  ``transcribe_many`` dispatches piece i+1 before it finishes piece i.
Training runs ``log_prob_padded`` on the fused route: the scorer writes the
padded alpha-layout score tensor once, and ``ops/logz`` takes logZ from it
with the alpha and beta kernels.

With ``useInnerProductScorer`` false the scores come from the pairwise
scorer of the V1 model over the projected ctx of every track, with a
learned skip score, and take the JAX package's generic routes: the decode's
Viterbi tables from ``semicrf.viterbi_backward_tables_best`` (everything
downstream of the tables as on the padded route), the objective's logZ from
``semicrf.log_z_best``.

Train and eval modes are explicit: each entry point sets the mode it needs
(``make_train_loss`` train; ``log_prob``, the stats and the decode eval).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import math
import os
from collections import defaultdict, deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.device_dataset import dequantize_int16
from ..data.note import Note, resolve_overlapping
from ..ops import distributions as dist
from ..ops import frontend, logz, semicrf, walk
from ..ops.viterbi import viterbi_backward_tables_padded
from ..utils import compute_param_size
from ..utils import profiling
from .backbone import Backbone, UpConvSkip
from .config import ModelConfig
from .layers import (
    MultiHeadAttention,
    ScaledInnerProductIntervalScorer,
    SpatialPositionEmbedding,
    mlp,
    set_dropout_generator,
)

Config = ModelConfig

# Segments a group of ``TransKun.transcribe`` holds when the caller names no
# ``segment_batch``: one group's ctx (4 x 64 MB at flagship width) is the most
# that is alive on the default route, two on the host-walk route, at any piece
# length.  (The JAX package's default of 1 was measured on a TPU's link.)
DEFAULT_SEGMENT_BATCH = 4

# Events a segment's track keeps on the default route, and events a group
# keeps a segment when ``decode_k_budget`` is None (~5x the densest real
# piano); past either the piece resumes on the host-walk route.
DECODE_K_MAX = 128
DECODE_EVENTS_PER_SEGMENT = 2048


def target_midi_pitches(_conf: ModelConfig = None) -> List[int]:
    """Event tracks: sustain (-64) and una-corda (-67) pedals + piano keys
    21..108 -> 90 tracks."""
    return [-64, -67] + list(range(21, 109))


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _track_pad(n: int, p: int, lane: int = semicrf.PALLAS_LN) -> int:
    """Smallest p_pad >= p such that n * p_pad is a multiple of ``lane``."""
    return _pad_to(p, lane // math.gcd(n, lane))


class GaussianWindows(nn.Module):
    """The learnable Gaussian analysis windows (``winGen``)."""

    def __init__(self, n: int):
        super().__init__()
        init = frontend.gaussian_windows_init(n)
        self.sigma = nn.Parameter(torch.from_numpy(init["sigma"]))
        self.center = nn.Parameter(torch.from_numpy(init["center"]))


class SpectrogramExtractor(nn.Module):
    def __init__(self, n_extra_wins: int):
        super().__init__()
        self.winGen = GaussianWindows(n_extra_wins)


class MelFrontend(nn.Module):
    """Gain-normalized multi-window log-mel: frames [N, C, T, W] ->
    [N, T, n_mels, nWins].  The Hann window, DFT band and filterbank are
    buffers that are not saved in the state_dict.  ``compute_dtype`` goes to
    ``frontend.mel_spectrum_gemm``."""

    def __init__(self, conf: ModelConfig, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.window_size = conf.windowSize
        self.spectrogramExtractor = SpectrogramExtractor(conf.nExtraWins)
        fbank = frontend.melscale_fbanks(
            conf.windowSize // 2 + 1, conf.f_min, conf.f_max, conf.n_mels, conf.fs
        )
        cos_m, sin_m, fb_band = frontend.dft_mel_matrices(conf.windowSize, fbank)
        self.register_buffer("hann", frontend.hann_window(conf.windowSize), persistent=False)
        self.register_buffer("cos_m", torch.from_numpy(cos_m), persistent=False)
        self.register_buffer("sin_m", torch.from_numpy(sin_m), persistent=False)
        self.register_buffer("fb_band", torch.from_numpy(fb_band), persistent=False)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        # gain normalization over everything but the batch axis, unbiased std
        mean = frames.mean(dim=(1, 2, 3), keepdim=True)
        n_el = frames.shape[1] * frames.shape[2] * frames.shape[3]
        var = ((frames - mean) ** 2).sum(dim=(1, 2, 3), keepdim=True) / max(n_el - 1, 1)
        frames = (frames - mean) / (torch.sqrt(var) + 1e-8)
        win_gen = self.spectrogramExtractor.winGen
        wins = torch.cat(
            [
                self.hann[None],
                frontend.gaussian_windows(win_gen.sigma, win_gen.center, self.window_size),
            ]
        )
        mel = frontend.mel_spectrum_gemm(
            frames, wins, self.cos_m, self.sin_m, self.fb_band, log=True, to_mono=True,
            compute_dtype=self.compute_dtype,
        )  # [N, 1, T, M, nWins]
        return mel[:, 0]


class TransKunModule(nn.Module):
    """The on-device part of the model.

    ``compute_dtype`` (``torch.bfloat16`` or None) is the JAX module's field
    of that name: the DFT products, the backbone and the scorer's score
    tensor run in it; parameters, the attribute heads (which read the fp32
    ctx) and ``boundary_offset_presence`` stay fp32."""

    def __init__(self, conf: ModelConfig, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
        self.conf = conf
        d = conf.baseSize * conf.scoringExpansionFactor
        self.framewiseFeatureExtractor = MelFrontend(conf, compute_dtype)
        self.backbone = Backbone(
            input_size=conf.nExtraWins + 1,
            base_size=conf.baseSize,
            n_head=conf.nHead,
            hidden_factor=conf.hiddenFactor,
            hidden_factor_attn=conf.hiddenFactorAttn,
            expansion_factor=conf.scoringExpansionFactor,
            dropout=conf.contextDropoutProb,
            n_layers=conf.nLayers,
            enabled_attn=conf.enabledAttn,
            downsample_f=conf.downsampleF,
            upsample_proj_only=conf.upsampleProjOnly,
            use_gradient_checkpoint=conf.useGradientCheckpoint,
            dtype=compute_dtype,
        )
        if conf.useInnerProductScorer:
            self.scorer = ScaledInnerProductIntervalScorer(d, d, 1, score_dtype=compute_dtype)
        else:
            # the V1 pairwise scorer over the projected ctx of every track
            # (fp32, as in the JAX package); a late import, as ablation
            # imports this module
            from .ablation import PairwiseFeatureBatch

            n_sym = len(target_midi_pitches())
            self.scorerProj = nn.Linear(n_sym * d, 512)
            self.scorer = PairwiseFeatureBatch(512, n_sym, dropout=conf.scoreDropoutProb)
        self.velocityPredictor = mlp(
            3 * d, conf.velocityPredictorHiddenSize, 128, conf.velocityDropoutProb
        )
        self.refinedOFPredictor = mlp(
            3 * d, conf.refinedOFPredictorHiddenSize, 4, conf.refinedOFDropoutProb
        )
        self.register_buffer(
            "pitches", torch.tensor(target_midi_pitches(), dtype=torch.float32),
            persistent=False,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights drawn from ``generator`` with the initializers of
        the JAX package's flax modules: LeCun normal (truncated at 2 sigma)
        for dense and conv weights with zero biases, Xavier uniform for the
        attention projections, N(0, 1/gamma) weights and U[0, 2 pi) phases
        for the position-embedding projections; LayerScale, GroupNorm and
        the analysis windows at their fixed initial values."""

        def lecun_normal(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, UpConvSkip)):
                # the upsample is a dense map from its w.shape[0] inputs
                w = mod.weight
                lecun_normal(w, w.shape[0] if isinstance(mod, UpConvSkip) else w[0].numel())
                mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MultiHeadAttention):
                for w in (mod.q_proj_weight, mod.k_proj_weight, mod.v_proj_weight):
                    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    w.uniform_(-bound, bound, generator=generator)
        for mod in self.modules():
            if isinstance(mod, SpatialPositionEmbedding):
                mod.proj.weight.normal_(0.0, 1.0 / self.conf.posEmbedInitGamma, generator=generator)
                mod.proj.bias.uniform_(0.0, 2 * math.pi, generator=generator)
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1e-2)
        init = frontend.gaussian_windows_init(self.conf.nExtraWins)
        win_gen = self.framewiseFeatureExtractor.spectrogramExtractor.winGen
        win_gen.sigma.copy_(torch.from_numpy(init["sigma"]))
        win_gen.center.copy_(torch.from_numpy(init["center"]))

    def _ctx(self, frames: torch.Tensor) -> torch.Tensor:
        return self.backbone(self.framewiseFeatureExtractor(frames), self.pitches)

    def process_frames(
        self, frames: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """frames [N, C, T, W] -> (S [T, T, N*P] alpha layout, noise
        [T-1, N*P], ctx [N, P, T, D]).  The noise is zero with the
        inner-product scorer and the learned skip score with the pairwise
        one."""
        ctx = self._ctx(frames)
        if self.conf.useInnerProductScorer:
            s, noise = self.scorer(ctx)
        else:
            # [N, P, T, D] -> [T, N, P*D], projected, scored pairwise
            ctx_score = ctx.permute(2, 0, 1, 3).reshape(ctx.shape[2], ctx.shape[0], -1)
            s, noise = self.scorer(self.scorerProj(ctx_score))
        t = s.shape[0]
        return s.reshape(t, t, -1), noise.reshape(t - 1, -1), ctx

    def process_frames_train(
        self, frames: torch.Tensor, t_pad: int, p_pad: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """frames -> (s_pad [t_pad, t_pad, N*p_pad] alpha layout, NEG-padded,
        for the logZ kernels; noise [t_pad, N*p_pad]; ctx [N, P, T, D])."""
        ctx = self._ctx(frames)
        s_pad, noise = self.scorer.train_scores(ctx, t_pad, p_pad)
        return s_pad, noise, ctx

    def process_frames_decode(
        self, frames: torch.Tensor, t_pad: int, p_pad: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """frames [N, C, T, W] -> (s_t [t_pad, t_pad, N*p_pad] decode layout,
        noise [t_pad, N*p_pad], diag [t_pad, N*p_pad] un-gated, ctx
        [N, P, T, D])."""
        ctx = self._ctx(frames)
        s_t, noise, diag = self.scorer.decode_scores(ctx, t_pad, p_pad)
        return s_t, noise, diag, ctx

    def attributes(
        self, ctx_a: torch.Tensor, ctx_b: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Endpoint context pair -> (velocity logits [..., 128], ofValue
        logits [..., 2], ofPresence logits [..., 2])."""
        x = torch.cat([ctx_a, ctx_b, ctx_a * ctx_b], dim=-1)
        of = self.refinedOFPredictor(x)
        return self.velocityPredictor(x), of[..., :2], of[..., 2:]

    def boundary_offset_presence(self, ctx: torch.Tensor, n_edge: int) -> torch.Tensor:
        """Offset-presence bits for every interval ending in the last
        ``n_edge`` frames: [N, P, T, n_edge] bool, entry (b, j) = presence
        for the interval (b, T-n_edge+j).  The first layer is applied to the
        three input blocks separately, so the concatenation is never built."""
        d = ctx.shape[-1]
        ctx_e = ctx[:, :, ctx.shape[2] - n_edge :]
        lin1, lin2 = self.refinedOFPredictor[0], self.refinedOFPredictor[3]
        k1 = lin1.weight.t()
        ka, kb, kab = k1[:d], k1[d : 2 * d], k1[2 * d :]
        ha = ctx @ ka
        hb = ctx_e @ kb
        outs = []
        for j in range(n_edge):
            h = ha + hb[:, :, j : j + 1] + (ctx * ctx_e[:, :, j : j + 1]) @ kab + lin1.bias
            of = torch.nn.functional.gelu(h) @ lin2.weight.t() + lin2.bias
            outs.append(of[..., 3] > 0)
        return torch.stack(outs, dim=-1)


def _gather_ctx(ctx: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ctx [N, P, T, D], idx [N, P, K] -> [N, P, K, D]."""
    return torch.take_along_dim(ctx, idx[..., None].long(), dim=2)


Labels = Tuple[torch.Tensor, ...]


def log_prob_padded(module: TransKunModule, frames: torch.Tensor, labels: Labels) -> torch.Tensor:
    """The training objective: per-track log-probability [N, P] (ref
    ``log_prob``), as the JAX package's ``log_prob_padded`` routes it.  Runs
    in the module's current mode.  With the inner-product scorer, the fused
    route: the padded alpha-layout scores, written once, and
    ``logz.log_z_padded``.  With the pairwise scorer, the unfused route:
    ``process_frames``' scores and learned noise, and ``semicrf.log_z_best``
    (the alpha and beta kernels on the card, with the exact-marginal
    backward and the noise cotangent).

    labels = (begins, ends, mask, velocity [N, P, K], refine, presence
    [N, P, K, 2]) from ``data.labels.encode_batch``, as tensors
    on the module's device."""
    begins, ends, mask, velocity, refine, presence = labels
    n, p, k = begins.shape
    if module.conf.useInnerProductScorer:
        t = frames.shape[2]
        t_pad, p_pad = _pad_to(t, semicrf.PALLAS_KP), _track_pad(n, p)
        s_pad, noise_pad, ctx = module.process_frames_train(frames, t_pad, p_pad)

        def lanes(a):  # [N, P, K] -> [N * p_pad, K], padded tracks empty
            return torch.nn.functional.pad(a, (0, 0, 0, p_pad - p)).reshape(n * p_pad, k)

        path = semicrf.eval_path_padded(s_pad, noise_pad[:-1], lanes(begins), lanes(ends), lanes(mask))
        log_z = logz.log_z_padded(t, s_pad, noise_pad)
        logp = (path - log_z).reshape(n, p_pad)[:, :p]
    else:
        s, noise, ctx = module.process_frames(frames)
        path = semicrf.eval_path_padded(
            s, noise, begins.reshape(n * p, k), ends.reshape(n * p, k), mask.reshape(n * p, k))
        logp = (path - semicrf.log_z_best(s, noise)).reshape(n, p)

    vel_logits, of_value, of_presence = module.attributes(
        _gather_ctx(ctx, begins), _gather_ctx(ctx, ends)
    )
    logp_vel = torch.log_softmax(vel_logits, dim=-1).gather(-1, velocity[..., None].long())[..., 0]
    refined = refine * 0.99 + 0.5  # [-0.5, 0.5] -> [0.005, 0.995]
    logp_of = dist.continuous_bernoulli_log_prob(of_value, refined).sum(-1)
    logp_presence = dist.bernoulli_log_prob(of_presence, presence).sum(-1)
    attr = torch.where(mask.bool(), logp_vel + logp_of + logp_presence, 0.0).sum(-1)
    return logp + attr


def quantize_link(x: np.ndarray, mode: Optional[bool], scale: float = 32768.0) -> np.ndarray:
    """The dtype a host waveform crosses to the device in: int16 when every
    sample is exactly an int16 over ``scale`` (half the bytes; dividing by
    the same scale on the device gives the same floats back), else float32.
    ``mode``: None detects, False keeps float32, True rounds and clips to
    int16.  ``scale`` is the one the floats came from: 32767 (``iinfo.max``)
    for the training slicer, the scale ``TransKun.frames`` divides int16 by;
    2**15 for ``read_audio``, the decode path's, whose int16 link the port
    does not have.

    The port's copy of the JAX package's ``_quantize_link``
    (``transkun_tpu/models/transkun.py:344-379``): the detection runs in
    blocks and stops at the first inexact one; an int16 times either scale
    is exact in float32, so ``rint(xs) == xs`` holds exactly when the block
    is int16-representable."""
    if x.dtype == np.int16:
        return x
    if mode is False:
        return x.astype(np.float32)
    if mode is True:
        return np.clip(np.round(x * x.dtype.type(scale)), -32768, 32767).astype(np.int16)
    link16 = np.empty(x.shape, np.int16)
    blk = 1 << 19
    for lo in range(0, x.shape[-1], blk):
        xs = x[..., lo: lo + blk] * x.dtype.type(scale)
        xi = np.rint(xs)
        if (
            xi.max(initial=0.0) > 32767
            or xi.min(initial=0.0) < -32768  # -1.0 is representable
            or not np.array_equal(xi, xs)
        ):
            return x.astype(np.float32)
        link16[..., lo: lo + blk] = xi
    return link16


class TransKun:
    """Host-facing model: owns the config and the module, runs the device
    work and the host decode / note assembly."""

    Config = ModelConfig

    def __init__(self, conf: ModelConfig, device=None, seed: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """``device`` is the card (``cuda``) unless given: without a CUDA
        device, pass ``device="cpu"``, else this raises.  ``seed`` draws
        random weights from a ``torch.Generator``; without it, load weights
        with ``load_state_dict``.  ``compute_dtype=torch.bfloat16`` runs the
        activations in bf16 (the CLIs' ``--bf16``); the parameters, and so
        the checkpoints, stay fp32."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                'TransKun runs on the card unless asked for the CPU: CUDA is not '
                'available, pass device="cpu"'
            )
        self.conf = conf
        self.device = device
        self.fs = conf.fs
        self.hopSize = conf.hopSize
        self.windowSize = conf.windowSize
        self.segmentSizeInSecond = conf.segmentSizeInSecond
        self.segmentHopSizeInSecond = conf.segmentHopSizeInSecond
        self.targetMIDIPitch = target_midi_pitches()
        module = TransKunModule(conf, compute_dtype)
        if seed is not None:
            module.reset_parameters(torch.Generator().manual_seed(seed))
        self.module = module.to(self.device).eval()
        # the default route's capacities: events a track keeps a segment, and
        # the group's compact buffer (None: DECODE_EVENTS_PER_SEGMENT a
        # segment of the group).  Past either, the piece resumes on the
        # host-walk route from the group that overflowed, with the same notes.
        self.decode_k_max = DECODE_K_MAX
        self.decode_k_budget: Optional[int] = None
        # what the last transcription did: the group the host-walk route
        # resumed from (None: it did not), and each group's compact count
        self.last_transcribe_fallback_from: Optional[int] = None
        self.last_transcribe_group_counts: List[int] = []
        # with TRANSKUN_TPU_TIMING set: the last transcription's (label, host
        # clock) marks, from the dispatch's start to the merge's end, read
        # off its spans
        self.last_transcribe_marks: List[Tuple[str, float]] = []
        # the key of a piece's spans, from its dispatch to its finish
        self._piece_serial = itertools.count()
        # transcribe_many(devices=...): the module replicated on each other
        # device, keyed by device, with the weights' versions it was copied at
        self._replicas: Dict[torch.device, Tuple[Any, "TransKun"]] = {}

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict, strict=True)

    def param_count(self) -> float:
        """Parameters in millions."""
        return compute_param_size(self.module)

    # -- training -------------------------------------------------------------

    def frames(self, audio_batch) -> torch.Tensor:
        """audio [N, nSample, C] -> frames [N, C, T, W] on the device.

        ``audio_batch`` is float audio on the host; int16 audio on the host
        (the training link, ``quantize_link(x, mode, 32767.0)``), uploaded as
        int16 and divided by 32767 on the device (``dequantize_int16``: the
        host slicer's floats, bit for bit); or a float32 tensor on the device
        (the device corpus's ``slice_batch``)."""
        if not isinstance(audio_batch, torch.Tensor):
            a = np.asarray(audio_batch)
            audio_batch = torch.from_numpy(np.ascontiguousarray(a if a.dtype == np.int16 else a.astype(np.float32)))
        x = audio_batch.to(self.device)
        if x.dtype == torch.int16:
            x = dequantize_int16(x)
        return frontend.make_frame(x.swapaxes(-1, -2), self.hopSize, self.windowSize)

    def labels(self, notes_batch, max_events: int = 32, k_sync=None) -> Labels:
        """Note lists -> padded label tensors on the device (``k_sync``: see
        ``data.labels.encode_batch``)."""
        from ..data.labels import encode_batch

        labels = encode_batch(notes_batch, self.hopSize / self.fs, self.targetMIDIPitch, max_events,
                              k_sync=k_sync)
        return tuple(torch.from_numpy(a).to(self.device) for a in labels.astuple())

    def make_train_loss(self, group=None):
        """loss_fn(frames, labels, generator) -> logp [N, P] in train mode,
        with every dropout mask drawn from ``generator``.  ``group`` is
        unused: V2 has no statistics to sum across ranks (V1's BatchNorm
        takes it)."""

        def loss_fn(frames, labels, generator):
            self.module.train()
            set_dropout_generator(self.module, generator)
            return log_prob_padded(self.module, frames, labels)

        return loss_fn

    def log_prob(self, audio_batch: np.ndarray, notes_batch, max_events: int = 32) -> torch.Tensor:
        """audio [N, nSample, C] + note lists -> per-track log-probability
        [N, P], in eval mode."""
        self.module.eval()
        return log_prob_padded(self.module, self.frames(audio_batch), self.labels(notes_batch, max_events))

    # -- training-time metrics -------------------------------------------------

    @torch.no_grad()
    def _decode(self, frames: torch.Tensor):
        """frames -> (ptr [T-1, N*P] int32, diag [T, N*P] bool, ctx), the
        Viterbi tables through ``semicrf.viterbi_backward_tables_best`` (the
        kernel for a CUDA tensor), from either scorer's noise."""
        self.module.eval()
        s, noise, ctx = self.module.process_frames(frames)
        ptr, diag = semicrf.viterbi_backward_tables_best(s, noise)
        return ptr, diag, ctx

    @torch.no_grad()
    def compute_stats(self, audio_batch: np.ndarray, notes_batch) -> Dict[str, float]:
        """Decode-vs-GT bracket and framewise counts, and the forced velocity
        and onset/offset square errors on the GT intervals (ref
        ``computeStats``)."""
        from ..data.labels import prepare_intervals
        from ..eval.evaluation import compare_bracket, compare_framewise

        frames = self.frames(audio_batch)
        n_batch = frames.shape[0]
        n_sym = len(self.targetMIDIPitch)
        ptr, diag, ctx = self._decode(frames)
        path = semicrf.backtrack_backward(ptr.cpu().numpy(), diag.cpu().numpy())

        intervals_batch, velocity_gt, of_gt = [], [], []
        for notes in notes_batch:
            data = prepare_intervals(notes, self.hopSize / self.fs, self.targetMIDIPitch)
            intervals_batch.append(data["intervals"])
            velocity_gt.append([v for track in data["velocity"] for v in track])
            of_gt.append([r for track in data["endPointRefine"] for r in track])
        flat_gt = [t for b in intervals_batch for t in b]
        if len(path) != len(flat_gt):
            raise ValueError(f"{len(path)} decoded tracks for {len(flat_gt)} label tracks")

        # Python sums, in track order, as the JAX package adds them
        bracket = [sum(c) for c in zip(*(compare_bracket(a, b) for a, b in zip(path, flat_gt)))]
        framewise = [sum(c) for c in zip(*(compare_framewise(a, b) for a, b in zip(path, flat_gt)))]

        k = max(max((len(t) for b in intervals_batch for t in b), default=1), 1)
        begins = np.zeros((n_batch, n_sym, k), np.int64)
        ends = np.zeros((n_batch, n_sym, k), np.int64)
        mask = np.zeros((n_batch, n_sym, k), bool)
        vel_arr = np.zeros((n_batch, n_sym, k), np.float64)
        of_arr = np.zeros((n_batch, n_sym, k, 2), np.float64)
        for i, b in enumerate(intervals_batch):
            vi = 0
            for j, track in enumerate(b):
                for e_idx, (bb, ee) in enumerate(track):
                    begins[i, j, e_idx] = bb
                    ends[i, j, e_idx] = ee
                    mask[i, j, e_idx] = True
                    vel_arr[i, j, e_idx] = velocity_gt[i][vi]
                    of_arr[i, j, e_idx] = of_gt[i][vi]
                    vi += 1
        velocity, of_value, _ = self._attr_readout(
            ctx, torch.from_numpy(begins).to(ctx.device), torch.from_numpy(ends).to(ctx.device), "mse"
        )
        velocity = velocity.cpu().numpy()
        of_value = of_value.cpu().numpy()
        return {
            "nGT": bracket[0],
            "nEst": bracket[1],
            "nCorrect": bracket[2],
            "nGTFramewise": framewise[0],
            "nEstFramewise": framewise[1],
            "nCorrectFramewise": framewise[2],
            "seVelocityForced": float((((velocity - vel_arr) ** 2) * mask).sum()),
            "seOFForced": float((((of_value - of_arr) ** 2) * mask[..., None]).sum()),
        }

    def compute_stats_mireval(self, audio_batch: np.ndarray, notes_batch) -> Dict[str, float]:
        """Note-with-offset counts by full decode and matching (ref
        ``computeStatsMIREVAL``)."""
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
    def transcribe_frames(
        self,
        frames: torch.Tensor,
        forced_start_pos: Optional[Sequence[int]] = None,
        velocity_criterion: str = "hamming",
        onset_bound: Optional[int] = None,
        last_frame_idx: Optional[int] = None,
    ) -> Tuple[List[List[Note]], List[int]]:
        """Decode one batch of segments [N, C, T, W] -> (notes per segment,
        lastP per track) (ref ``transcribeFrames``)."""
        n_batch = frames.shape[0]
        n_sym = len(self.targetMIDIPitch)
        if last_frame_idx is None:
            last_frame_idx = frames.shape[-2] - 1
        ptr, diag, ctx = self._decode(frames)
        path = semicrf.backtrack_backward(ptr.cpu().numpy(), diag.cpu().numpy(), forced_start_pos)
        if onset_bound is not None:
            path = [[e for e in p if e[0] < onset_bound] for p in path]
        intervals_batch = [path[i * n_sym : (i + 1) * n_sym] for i in range(n_batch)]
        return self._attr_and_assemble(ctx, intervals_batch, velocity_criterion, last_frame_idx)

    # -- attribute heads and note assembly ------------------------------------

    def _attr_readout(
        self, ctx: torch.Tensor, begins: torch.Tensor, ends: torch.Tensor, criterion: str
    ):
        """Endpoint contexts -> heads -> (velocity, refined onset/offset in
        frames, offset presence), with the velocity criterion applied."""
        return self._attr_from_pairs(_gather_ctx(ctx, begins), _gather_ctx(ctx, ends), criterion)

    def _attr_from_pairs(self, ctx_a: torch.Tensor, ctx_b: torch.Tensor, criterion: str):
        """The heads and the velocity criterion on gathered endpoint context
        pairs of any batch shape."""
        vel_logits, of_value, of_presence = self.module.attributes(ctx_a, ctx_b)
        p_velocity = torch.softmax(vel_logits, dim=-1)
        w = torch.arange(128, dtype=p_velocity.dtype, device=p_velocity.device)
        if criterion == "mse":
            velocity = (p_velocity * w).sum(dim=-1)
        elif criterion == "match":
            utility = ((w[:, None] - w[None, :]).abs() < 0.1 * 128).to(p_velocity.dtype)
            velocity = torch.argmax(p_velocity @ utility, dim=-1)
        elif criterion == "hamming":
            velocity = torch.argmax(p_velocity, dim=-1)
        elif criterion == "mae":
            pcum = torch.cumsum(p_velocity, dim=-1)
            w2 = torch.arange(128, 0, -1, dtype=p_velocity.dtype, device=p_velocity.device)
            velocity = torch.argmax(((pcum - 0.5) > 0) * w2, dim=-1)
        else:
            raise ValueError(f"Unrecognized criterion: {criterion}")
        of = torch.clamp((dist.continuous_bernoulli_mean(of_value) - 0.5) / 0.99, -0.5, 0.5)
        return velocity, of, of_presence > 0

    def _attr_and_assemble(
        self,
        ctx: torch.Tensor,
        intervals_batch,
        velocity_criterion: str,
        last_frame_idx: int,
        begin_times: Optional[np.ndarray] = None,
    ) -> Tuple[List[List[Note]], List[int]]:
        """Attribute readout + note assembly for decoded interval tracks
        ``intervals_batch[segment][track] = [(begin, end), ...]``."""
        n_batch = len(intervals_batch)
        n_sym = len(self.targetMIDIPitch)
        kmax = max((len(p) for b in intervals_batch for p in b), default=0)
        if kmax == 0:
            return [[] for _ in range(n_batch)], [0] * (n_batch * n_sym)
        k = 64
        while k < kmax:
            k *= 2
        begins = np.zeros((n_batch, n_sym, k), np.int64)
        ends = np.zeros((n_batch, n_sym, k), np.int64)
        counts = np.zeros((n_batch, n_sym), np.int64)
        for i in range(n_batch):
            for j in range(n_sym):
                track = intervals_batch[i][j]
                counts[i, j] = len(track)
                for e_idx, (b, e) in enumerate(track):
                    begins[i, j, e_idx] = b
                    ends[i, j, e_idx] = e
        velocity, of_value, of_presence = self._attr_readout(
            ctx,
            torch.from_numpy(begins).to(ctx.device),
            torch.from_numpy(ends).to(ctx.device),
            velocity_criterion,
        )
        mask = np.arange(k)[None, None, :] < counts[..., None]
        return self._assemble_from_arrays(
            begins, ends, mask,
            velocity.cpu().numpy(),
            # float64 on the host so tiny epsilons survive
            of_value.cpu().numpy().astype(np.float64),
            of_presence.cpu().numpy(),
            last_frame_idx, begin_times,
        )

    def _assemble_from_arrays(
        self,
        begins: np.ndarray,
        ends: np.ndarray,
        mask: np.ndarray,
        velocity: np.ndarray,
        of_value: np.ndarray,
        of_presence: np.ndarray,
        last_frame_idx: int,
        begin_times: Optional[np.ndarray] = None,
    ) -> Tuple[List[List[Note]], List[int]]:
        """Vectorized note assembly from padded event arrays [N, P, K] (the
        tail of ref ``transcribeFrames``).  ``mask`` marks real events, a
        prefix of each track in walk order.  ``begin_times`` [N] shifts each
        segment into piece time with the clamps start >= 0, end >= start."""
        n_batch, n_sym, k = begins.shape
        frame_dur = self.hopSize / self.fs
        kmax_used = int(mask.sum(axis=-1).max()) if mask.any() else 0
        start_raw = (begins.astype(np.float64) + of_value[..., 0]) * frame_dur
        end_raw = (ends.astype(np.float64) + of_value[..., 1]) * frame_dur
        # presence only decides for events touching the segment's first or
        # last frame
        has_onset = (begins > 0) | of_presence[..., 0]
        has_offset = (ends < last_frame_idx) | of_presence[..., 1]
        # monotonic clamps: start >= previous end, end >= start + 1e-8
        start_c = np.zeros_like(start_raw)
        end_c = np.zeros_like(end_raw)
        last_end = np.zeros((n_batch, n_sym), np.float64)
        for e_idx in range(kmax_used):
            s = np.maximum(start_raw[..., e_idx], last_end)
            e = np.maximum(end_raw[..., e_idx], s + 1e-8)
            start_c[..., e_idx] = s
            end_c[..., e_idx] = e
            last_end = np.where(mask[..., e_idx], e, last_end)
        last_p_arr = np.max(np.where(mask & has_offset, ends, 0), axis=-1, initial=0)
        if begin_times is not None:
            start_c = np.maximum(start_c + begin_times[:, None, None], 0.0)
            end_c = np.maximum(end_c + begin_times[:, None, None], start_c)

        pitches = np.asarray(self.targetMIDIPitch)
        notes: List[List[Note]] = []
        for i in range(n_batch):
            jj, kk = np.nonzero(mask[i])
            ss, ee = start_c[i][jj, kk], end_c[i][jj, kk]
            order = np.lexsort((pitches[jj], ee, ss))
            jj, kk = jj[order], kk[order]
            notes.append(
                [
                    Note(start=s, end=e, pitch=p, velocity=v, hasOnset=on, hasOffset=off)
                    for s, e, p, v, on, off in zip(
                        ss[order].tolist(),
                        ee[order].tolist(),
                        pitches[jj].tolist(),
                        velocity[i][jj, kk].tolist(),
                        has_onset[i][jj, kk].tolist(),
                        has_offset[i][jj, kk].tolist(),
                    )
                ]
            )
        return notes, [int(v) for v in last_p_arr.reshape(-1)]

    # -- transcription ----------------------------------------------------------

    def _segment_tables(self, seg_audio: torch.Tensor, last_frame_idx: int):
        """One segment [C, S] -> (ptr [t-1, P] int32, diag [t, P] bool,
        bpres [P, t, n_edge] bool, ctx [P, t, D]), all left on the device.
        The Viterbi tables come from ``viterbi_backward_tables_padded``: the
        CUDA kernel for a CUDA segment.  With the pairwise scorer, the JAX
        package's generic route: the unpadded scores and learned noise
        through ``semicrf.viterbi_backward_tables_best`` (the same kernel),
        the same outputs."""
        with profiling.span("transkun.segment"):
            n_sym = len(self.targetMIDIPitch)
            frames = frontend.make_frame(seg_audio[None], self.hopSize, self.windowSize)
            t = frames.shape[-2]
            if not self.conf.useInnerProductScorer:
                s, noise, ctx = self.module.process_frames(frames)
                ptr, diag = semicrf.viterbi_backward_tables_best(s, noise)
                bpres = self.module.boundary_offset_presence(ctx, t - last_frame_idx)
                return ptr, diag, bpres[0], ctx[0]
            t_pad, p_pad = _pad_to(t, semicrf.PALLAS_KP), _track_pad(1, n_sym)
            s_t, noise, diag_raw, ctx = self.module.process_frames_decode(frames, t_pad, p_pad)
            ptr = viterbi_backward_tables_padded(s_t, noise, diag_raw * (diag_raw > 0))
            bpres = self.module.boundary_offset_presence(ctx, t - last_frame_idx)
            return ptr[: t - 1, :n_sym], (diag_raw > 0)[:t, :n_sym], bpres[0], ctx[0]

    def _group_tables(self, audio: torch.Tensor, starts: Sequence[int], segment_size: int,
                      last_frame_idx: int):
        """``_segment_tables`` of the segments of ``audio`` [C, nSample] that
        begin at ``starts``, enqueued one after the other: (ptr [n, t-1, P],
        diag [n, t, P], bpres [n, P, t, n_edge], ctx [n, P, t, D]) on the
        device.  Each segment's ctx is written into the group's one buffer
        as it is made, so a group holds its ctx once."""
        ptrs, diags, bpress, ctx_group = [], [], [], None
        for i, s in enumerate(starts):
            ptr, diag, bpres, ctx = self._segment_tables(
                audio[:, s : s + segment_size], last_frame_idx)
            if ctx_group is None:
                ctx_group = ctx.new_empty((len(starts), *ctx.shape))
            ctx_group[i] = ctx
            ptrs.append(ptr)
            diags.append(diag)
            bpress.append(bpres)
        return torch.stack(ptrs), torch.stack(diags), torch.stack(bpress), ctx_group

    def _fused_group(
        self,
        audio: torch.Tensor,
        starts: Sequence[int],
        start_pos: torch.Tensor,
        criterion: str,
        onset_bound: int,
        segment_size: int,
        last_frame_idx: int,
        step_frames: int,
        k_max: int,
        k_budget: int,
    ) -> Tuple[torch.Tensor, ...]:
        """The group program (the JAX package's ``_fused_group_traced``,
        ``:988-1115``): the segments of ``audio`` beginning at ``starts`` and
        the group's forced starts [P] -> (src, cb, ce [k_budget + 1] int32,
        velocity, of [k_budget + 1, 2] fp32, pres [k_budget + 1, 2] bool,
        count, the next group's forced starts [P] int32, overflow), all on
        the device and nothing waited for.

        The walk and the chain run in ``walk.walk_group``.  The events are
        compacted by a cumsum into a ``k_budget`` buffer whose row
        ``k_budget`` is scratch: src is an event's flat (segment, track, k)
        index, -1 past the count.  The attribute heads run on the compact
        rows only.  ``overflow`` is any track's walk overflow, or more events
        than the budget.  The group's ctx is dropped when this returns."""
        ptr, diag, bpres, ctx = self._group_tables(audio, starts, segment_size, last_frame_idx)
        with profiling.span("transkun.walk"):
            begins, ends, cnt, ovf, start_next = walk.walk_group(
                ptr, diag, bpres, start_pos, k_max, last_frame_idx, step_frames, onset_bound)
        del ptr, diag, bpres
        with profiling.span("transkun.heads"):
            dev = ctx.device
            valid = torch.arange(k_max, device=dev) < cnt[..., None]
            if onset_bound >= 0:
                valid &= begins < onset_bound
            flatv = valid.reshape(-1)
            count = flatv.sum(dtype=torch.int32)
            # an invalid event, and every slot at or past the budget, goes to the
            # scratch row: a torch scatter faults on a slot out of range where
            # the JAX package's drops it
            slot = torch.where(flatv, torch.cumsum(flatv, 0) - 1, k_budget).clamp_(max=k_budget)
            src = torch.full((k_budget + 1,), -1, dtype=torch.int32, device=dev).index_put_(
                (slot,), torch.arange(flatv.numel(), dtype=torch.int32, device=dev))
            cb = torch.zeros(k_budget + 1, dtype=torch.int32, device=dev).index_put_(
                (slot,), begins.reshape(-1))
            ce = torch.zeros(k_budget + 1, dtype=torch.int32, device=dev).index_put_(
                (slot,), ends.reshape(-1))
            row = torch.clamp(src, min=0) // k_max  # flat (segment, track)
            ctx_flat = ctx.reshape(-1, ctx.shape[2], ctx.shape[3])
            velocity, of, pres = self._attr_from_pairs(ctx_flat[row, cb], ctx_flat[row, ce], criterion)
            overflow = ovf.any() | (count > k_budget)
            return src, cb, ce, velocity, of, pres, count, start_next, overflow

    @torch.no_grad()
    def transcribe(
        self,
        x: np.ndarray,
        step_in_second: Optional[float] = None,
        segment_size_in_second: Optional[float] = None,
        discard_second_half: bool = False,
        merge_incomplete_event: bool = True,
        velocity_criterion: str = "hamming",
        segment_batch: Optional[int] = None,
    ) -> List[Note]:
        """Full-piece transcription with exact cross-segment stitching
        (ref ``transcribe``, ``ModelTransformer.py:729-848``).

        x: [nSample, nChannel] float waveform at conf.fs (int16 is read as
        x / 32768).

        ``_transcribe_dispatch`` then ``_transcribe_finish``.  The segments
        go through the device in groups of ``segment_batch`` (``None``:
        DEFAULT_SEGMENT_BATCH), each group's stitching chain on the device
        and its start handed to the next group there, so the whole piece is
        enqueued before anything is fetched, and a group's ctx is dropped
        once its heads are enqueued: device memory does not grow with the
        piece.  The notes do not depend on ``segment_batch``, nor on the
        route (``decode_k_max``, ``decode_k_budget``)."""
        plan = self._transcribe_dispatch(
            x, step_in_second, segment_size_in_second, discard_second_half,
            velocity_criterion, segment_batch)
        return self._transcribe_finish(plan, merge_incomplete_event)

    def transcribe_many(
        self,
        pieces: Iterable[Any],
        step_in_second: Optional[float] = None,
        segment_size_in_second: Optional[float] = None,
        discard_second_half: bool = False,
        merge_incomplete_event: bool = True,
        velocity_criterion: str = "hamming",
        segment_batch: Optional[int] = None,
        depth: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
    ) -> Iterator[List[Note]]:
        """Pipelined transcription of many pieces: a generator of one note
        list a piece, in input order (the JAX package's
        ``transcribe_many``, ``:1237-1310``).

        ``pieces`` is an iterable of waveforms, or of (anything, waveform)
        pairs, read lazily.  ``depth`` pieces stay in flight (default: one a
        device): piece i+1 is read and dispatched before piece i is
        finished, so the card works on it while the host assembles piece
        i's notes.  ``devices`` (e.g. every visible card) takes the pieces
        round-robin, each piece's chain on its own device; the module is
        replicated once on each device other than this model's and kept for
        later calls until its weights change."""
        devs = [self.device] if not devices else [torch.device(d) for d in devices]
        if depth is None:
            depth = len(devs)
        if depth < 0:
            raise ValueError(f"depth must be at least 0, got {depth}")
        models = [self._replica(d) for d in devs]
        queue = deque()
        for i, item in enumerate(pieces):
            x = item[1] if isinstance(item, tuple) else item
            m = models[i % len(models)]
            with m._on_device():
                queue.append((m, m._transcribe_dispatch(
                    x, step_in_second, segment_size_in_second, discard_second_half,
                    velocity_criterion, segment_batch)))
            if len(queue) > depth:
                yield self._finish_on(*queue.popleft(), merge_incomplete_event)
        while queue:
            yield self._finish_on(*queue.popleft(), merge_incomplete_event)

    def _finish_on(self, m: "TransKun", plan: Dict[str, Any], merge_incomplete_event: bool) -> List[Note]:
        """``_transcribe_finish`` of a plan dispatched by ``m`` (this model or
        a replica), its route's record copied to this model."""
        with m._on_device():
            notes = m._transcribe_finish(plan, merge_incomplete_event)
        if m is not self:
            self.last_transcribe_fallback_from = m.last_transcribe_fallback_from
            self.last_transcribe_group_counts = m.last_transcribe_group_counts
            self.last_transcribe_marks = m.last_transcribe_marks
        return notes

    def _on_device(self):
        """The model's card as the current CUDA device: the kernels launch on
        the current device's stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _replica(self, device: torch.device) -> "TransKun":
        """This model on ``device``: itself on its own device, else a copy of
        the module there, cached while the weights are unchanged."""
        def canonical(d):
            if d.type == "cuda" and d.index is None:
                return torch.device("cuda", torch.cuda.current_device())
            return d

        device = canonical(device)
        if device == canonical(self.device):
            return self
        tensors = self.module.state_dict().values()
        version = tuple((t.data_ptr(), t._version) for t in tensors)
        cached = self._replicas.get(device)
        if cached is None or cached[0] != version:
            replica = copy.copy(self)
            replica.module = copy.deepcopy(self.module).to(device)
            replica.device = device
            replica._replicas = {}
            self._replicas[device] = (version, replica)
        return self._replicas[device][1]

    @torch.no_grad()
    def _transcribe_dispatch(
        self,
        x: np.ndarray,
        step_in_second: Optional[float],
        segment_size_in_second: Optional[float],
        discard_second_half: bool,
        velocity_criterion: str,
        segment_batch: Optional[int],
    ) -> Dict[str, Any]:
        """Phase 1 of a piece: upload the padded waveform once, enqueue every
        group's program with the forced starts chained device to device, and
        enqueue the copies of each group's outputs into pinned host buffers.
        Returns the plan ``_transcribe_finish`` takes; waits for nothing (on
        the card: the upload is from pinned memory, and no value is read).

        The root span ``transkun.dispatch`` (``utils.profiling``) holds
        ``transkun.prepare`` (int16 to float32, transpose, pad),
        ``transkun.pin``, ``transkun.upload`` (the enqueue of the copy) and
        one ``transkun.group`` a group: its ``transkun.segment`` spans,
        ``transkun.walk``, ``transkun.heads`` and ``transkun.to_host``.  The
        piece's serial number keys them, and the plan carries it and the
        root to ``_transcribe_finish``."""
        self.module.eval()
        key = next(self._piece_serial)
        with profiling.root("transkun.dispatch", key) as root:
            if step_in_second is None and segment_size_in_second is None:
                step_in_second = self.segmentHopSizeInSecond
                segment_size_in_second = self.segmentSizeInSecond
            if segment_batch is None:
                segment_batch = DEFAULT_SEGMENT_BATCH
            if segment_batch < 1:
                raise ValueError(f"segment_batch must be at least 1, got {segment_batch}")
            pad_time_begin = segment_size_in_second - step_in_second
            pad = math.ceil(pad_time_begin * self.fs)
            start_frame_idx = math.floor(pad_time_begin * self.fs / self.hopSize)
            step_size = math.ceil(step_in_second * self.fs / self.hopSize) * self.hopSize
            segment_size = math.ceil(segment_size_in_second * self.fs)
            last_frame_idx = round(segment_size / self.hopSize)
            onset_bound = step_size if discard_second_half else None
            step_frames = int(step_size / self.hopSize)
            n_sym = len(self.targetMIDIPitch)
            k_max = self.decode_k_max
            k_budget = self.decode_k_budget
            if k_budget is None:
                k_budget = DECODE_EVENTS_PER_SEGMENT * segment_batch

            # the padded waveform goes to the device once, from pinned memory;
            # the extra segment of zeros keeps every window in bounds
            with profiling.span("transkun.prepare"):
                x = np.asarray(x)
                if x.dtype == np.int16:
                    x = x.astype(np.float32) / 32768.0
                x = x.T.astype(np.float32)  # [C, nSample]
                host = torch.from_numpy(np.pad(x, ((0, 0), (pad, pad + segment_size))))
                start = torch.full((n_sym,), start_frame_idx, dtype=torch.int32)
            n_sample = x.shape[-1] + 2 * pad
            starts = list(range(0, n_sample, step_size))
            groups = [starts[g0 : g0 + segment_batch] for g0 in range(0, len(starts), segment_batch)]
            on_card = self.device.type == "cuda"
            if on_card:
                with profiling.span("transkun.pin"):
                    host, start = host.pin_memory(), start.pin_memory()
            with profiling.span("transkun.upload"):
                audio = host.to(self.device, non_blocking=True)
                start_dev = start.to(self.device, non_blocking=True)

            outs = []
            for group in groups:
                with profiling.span("transkun.group"):
                    out = self._fused_group(
                        audio, group, start_dev, velocity_criterion,
                        -1 if onset_bound is None else onset_bound,
                        segment_size, last_frame_idx, step_frames, k_max, k_budget)
                    start_dev = out[7]
                    with profiling.span("transkun.to_host"):
                        outs.append(tuple(_to_host(a) for a in out))
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            profiling.count("pieces")
            profiling.count("segments", len(starts))
            profiling.count("groups", len(groups))
        return dict(
            audio=audio, host=host, outs=outs, done=done, groups=groups, start=start.tolist(),
            segment_batch=segment_batch, n_sym=n_sym, k_max=k_max, segment_size=segment_size,
            last_frame_idx=last_frame_idx, step_frames=step_frames, pad_time_begin=pad_time_begin,
            velocity_criterion=velocity_criterion, onset_bound=onset_bound, key=key, dispatch=root,
        )

    @torch.no_grad()
    def _transcribe_finish(self, plan: Dict[str, Any], merge_incomplete_event: bool = True) -> List[Note]:
        """Phase 2 of a piece: wait for the piece's event (and nothing
        enqueued after it), scatter every group's compact events into
        [segments, P, k_max] arrays, assemble them at once, resume on the
        host-walk route from the first group that overflowed, with the forced
        starts the device chain carried to it, and merge.

        The root span ``transkun.finish`` holds ``transkun.wait``,
        ``transkun.assemble``, ``transkun.host_walk`` (where the route
        resumes) and ``transkun.merge``.  With ``TRANSKUN_TPU_TIMING`` set,
        ``last_transcribe_marks`` is read off the piece's spans (``begin``
        the dispatch's start; ``upload enqueued``, ``group g enqueued``,
        ``event waited for``, ``assembled``, ``host-walk route from group
        g`` and ``merged`` the ends of theirs), and each phase is printed
        unless the variable is ``silent``."""
        with profiling.root("transkun.finish", plan["key"]) as root:
            with profiling.span("transkun.wait"):
                if plan["done"] is not None:
                    plan["done"].synchronize()
            with profiling.span("transkun.assemble"):
                outs = [[a.numpy() for a in out] for out in plan["outs"]]
                counts = [int(out[6]) for out in outs]
                fallback_from = next((g for g, out in enumerate(outs) if bool(out[8])), None)
                self.last_transcribe_fallback_from = fallback_from
                self.last_transcribe_group_counts = counts
                n_ok = len(plan["groups"]) if fallback_from is None else fallback_from
                seg_notes: List[List[Note]] = []
                if n_ok:
                    seg_notes.extend(self._assemble_groups(plan, outs, counts, n_ok))
            if fallback_from is not None:
                profiling.count("host_walk_resumes")
                with profiling.span("transkun.host_walk"):
                    start_pos = plan["start"] if fallback_from == 0 else outs[fallback_from - 1][7].tolist()
                    seg_notes.extend(self._transcribe_host_walk(plan, fallback_from, start_pos))
            with profiling.span("transkun.merge"):
                merged = _merge_segments(seg_notes, merge_incomplete_event)
        if os.environ.get(profiling.ENV) and root.records and plan["dispatch"].records:
            marks = _marks(plan["dispatch"], root.records, fallback_from)
            self.last_transcribe_marks = marks
            if os.environ.get(profiling.ENV) != "silent":
                for (_, before), (label, at) in zip(marks, marks[1:]):
                    print(f"  [transcribe] {label}: +{(at - before) * 1e3:.1f} ms")
        return merged

    def _assemble_groups(self, plan: Dict[str, Any], outs, counts: List[int], n_ok: int) -> List[List[Note]]:
        """The notes of the first ``n_ok`` groups of the default route, each
        segment's in piece time: their compact events scattered into
        [segments, P, k_max] arrays and assembled at once."""
        groups, segment_batch = plan["groups"], plan["segment_batch"]
        n_sym, k_max = plan["n_sym"], plan["k_max"]

        def cat(i):
            return np.concatenate([outs[g][i][: counts[g]] for g in range(n_ok)])

        src = np.concatenate([
            outs[g][0][: counts[g]].astype(np.int64) + g * segment_batch * n_sym * k_max
            for g in range(n_ok)
        ])
        gi, gj, gk = src // (n_sym * k_max), (src // k_max) % n_sym, src % k_max
        n_seg = sum(len(g) for g in groups[:n_ok])
        begins = np.zeros((n_seg, n_sym, k_max), np.int32)
        ends = np.zeros((n_seg, n_sym, k_max), np.int32)
        mask = np.zeros((n_seg, n_sym, k_max), bool)
        velocity = cat(3)
        vel_d = np.zeros((n_seg, n_sym, k_max), velocity.dtype)
        of_d = np.zeros((n_seg, n_sym, k_max, 2), np.float64)
        pres_d = np.zeros((n_seg, n_sym, k_max, 2), bool)
        begins[gi, gj, gk] = cat(1)
        ends[gi, gj, gk] = cat(2)
        mask[gi, gj, gk] = True
        vel_d[gi, gj, gk] = velocity
        of_d[gi, gj, gk] = cat(4)
        pres_d[gi, gj, gk] = cat(5)
        begin_times = np.array(
            [s / self.fs - plan["pad_time_begin"] for g in groups[:n_ok] for s in g], np.float64)
        notes, _ = self._assemble_from_arrays(
            begins, ends, mask, vel_d, of_d, pres_d, plan["last_frame_idx"], begin_times)
        return notes

    def _transcribe_host_walk(self, plan: Dict[str, Any], g0: int, start_pos: List[int]) -> List[List[Note]]:
        """The host-walk route from group ``g0`` on, from ``start_pos``: each
        group's tables are enqueued one group ahead of its walk
        (``_process_group``), so at most two groups' ctx are alive."""
        groups = plan["groups"]

        def tables(g):
            return self._group_tables(plan["audio"], groups[g], plan["segment_size"], plan["last_frame_idx"])

        seg_notes: List[List[Note]] = []
        enqueued = tables(g0)
        for g in range(g0, len(groups)):
            handles, enqueued = enqueued, None
            if g + 1 < len(groups):
                enqueued = tables(g + 1)  # the next group's device work before this one's fetch
            begin_times = np.array([s / self.fs - plan["pad_time_begin"] for s in groups[g]], np.float64)
            notes, start_pos = self._process_group(
                handles, start_pos, plan["velocity_criterion"], plan["onset_bound"],
                plan["last_frame_idx"], plan["step_frames"], begin_times)
            seg_notes.extend(notes)
        return seg_notes

    def _process_group(
        self,
        handles: Tuple[torch.Tensor, ...],
        start_pos: List[int],
        velocity_criterion: str,
        onset_bound: Optional[int],
        last_frame_idx: int,
        step_frames: int,
        begin_times: np.ndarray,
    ) -> Tuple[List[List[Note]], List[int]]:
        """One group on the host-walk route (the JAX package's
        ``_process_group``, ``:1156-1206``): one fetch of its tables, the
        pointer walk and the stitching chain on the host, one attribute call
        for the group.  Returns (notes per segment in piece time, the next
        group's forced starts)."""
        ptr, diag, bpres, ctx = handles
        paths, next_start = host_chain(
            ptr.cpu().numpy(), diag.cpu().numpy(), bpres.cpu().numpy(), start_pos,
            last_frame_idx, step_frames, onset_bound)
        del ptr, diag, bpres
        notes, _ = self._attr_and_assemble(ctx, paths, velocity_criterion, last_frame_idx, begin_times)
        return notes, next_start


def _marks(dispatch: profiling.Open, finish: List[profiling.Span],
           fallback_from: Optional[int]) -> List[Tuple[str, float]]:
    """A piece's ``TRANSKUN_TPU_TIMING`` marks, (label, host clock), read
    off its dispatch root and its finish root's records."""
    ends = [s.t1 for s in dispatch.records if s.name == "transkun.group"]
    marks = [("begin", dispatch.t0)]
    marks += [("upload enqueued", s.t1) for s in dispatch.records if s.name == "transkun.upload"]
    marks += [(f"group {g} enqueued", t) for g, t in enumerate(ends)]
    labels = {"transkun.wait": "event waited for", "transkun.assemble": "assembled",
              "transkun.host_walk": f"host-walk route from group {fallback_from}", "transkun.merge": "merged"}
    return marks + [(labels[s.name], s.t1) for s in finish if s.name in labels]


def _to_host(a: torch.Tensor) -> torch.Tensor:
    """``a`` on the host: from the card a copy into a pinned buffer, enqueued
    and not waited for; on the CPU ``a`` itself."""
    if a.device.type == "cpu":
        return a
    return torch.empty(a.shape, dtype=a.dtype, pin_memory=True).copy_(a, non_blocking=True)


def host_chain(
    ptr: np.ndarray,
    diag: np.ndarray,
    bpres: np.ndarray,
    start: Sequence[int],
    last_frame_idx: int,
    step_frames: int,
    onset_bound: Optional[int] = None,
) -> Tuple[List[List[List[Tuple[int, int]]]], List[int]]:
    """The host-walk route's stitching chain over a group's segments: ptr
    [n, t-1, P], diag [n, t, P], bpres [n, P, t, n_edge] and the group's
    forced starts -> (each segment's intervals per track, the next group's
    forced starts).  Each segment starts where the previous one's lastP
    (the end of its last interval whose offset is real: interior, or
    confirmed by the presence bits at the edge) less ``step_frames`` puts
    it."""
    paths = []
    cur_start = list(start)
    for gi in range(ptr.shape[0]):
        path = semicrf.backtrack_backward(ptr[gi], diag[gi], cur_start)
        if onset_bound is not None:
            path = [[e for e in p if e[0] < onset_bound] for p in path]
        paths.append(path)
        last_p = []
        for j, events in enumerate(path):
            cur_last = 0
            for b, e in events:
                if e < last_frame_idx or bpres[gi, j, b, e - last_frame_idx]:
                    cur_last = e
            last_p.append(cur_last)
        cur_start = [max(k - step_frames, 0) for k in last_p]
    return paths, cur_start


def _merge_segments(seg_notes: List[List[Note]], merge_incomplete_event: bool) -> List[Note]:
    """Cross-segment merge of notes already in piece time: a note that
    starts before the previous same-pitch note ends replaces it (if it has
    an onset) or extends it; the last note of each pitch gets a forced
    offset; notes without offset are dropped."""
    events_by_type: Dict[int, List[Note]] = defaultdict(list)
    for cur_events in seg_notes:
        for e in cur_events:
            if merge_incomplete_event and len(events_by_type[e.pitch]) > 0:
                last_e = events_by_type[e.pitch][-1]
                if e.start < last_e.end:
                    if e.hasOnset:
                        events_by_type[e.pitch][-1] = e
                    else:
                        last_e.hasOffset = e.hasOffset
                        last_e.end = max(e.end, last_e.end)
                    continue
            if e.hasOnset:
                events_by_type[e.pitch].append(e)
    for events in events_by_type.values():
        if events:
            events[-1].hasOffset = True
    return resolve_overlapping([n for lst in events_by_type.values() for n in lst if n.hasOffset])
