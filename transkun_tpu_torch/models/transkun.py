"""TransKun V2: frames -> mel -> backbone -> interval scores -> semi-CRF,
in PyTorch: the training objective and the decode.

Port of ``transkun_tpu/models/transkun.py``.  Transcription follows the JAX
package's host-walk decode route (``_transcribe_segment_group`` ->
``_process_group`` -> ``_attr_and_assemble`` -> ``_assemble_from_arrays``),
which gives the same notes as its default route.  A segment's device work
is independent of the stitching state, so the segments run in groups
(``segment_batch``): a group's work is enqueued one group ahead of the
pointer walk and the forcedStartPos chain, which run on the host over one
fetch a group, and a group's device tensors are dropped once its notes are
assembled, so device memory does not grow with the piece.  Training runs
``log_prob_padded`` on the fused route: the scorer writes the padded
alpha-layout score tensor once, and ``ops/logz`` takes logZ from it with the
alpha and beta kernels.

Train and eval modes are explicit: each entry point sets the mode it needs
(``make_train_loss`` train; ``log_prob``, the stats and the decode eval).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.note import Note, resolve_overlapping
from ..ops import distributions as dist
from ..ops import frontend, logz, semicrf
from ..ops.viterbi import viterbi_backward_tables_padded
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
# ``segment_batch``: two groups' ctx (2 x 4 x 64 MB at flagship width) are the
# most that is alive, at any piece length.
DEFAULT_SEGMENT_BATCH = 4


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
        if not conf.useInnerProductScorer:
            raise NotImplementedError("only the inner-product scorer (V2) is ported")
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
        self.scorer = ScaledInnerProductIntervalScorer(d, d, 1, score_dtype=compute_dtype)
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
            if isinstance(mod, (nn.Linear, nn.Conv2d, UpConvSkip)):
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
        [T-1, N*P], ctx [N, P, T, D])."""
        ctx = self._ctx(frames)
        s, noise = self.scorer(ctx)
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
    ``log_prob``), on the fused route of the JAX package's
    ``log_prob_padded``.  Runs in the module's current mode.

    labels = (begins, ends, mask, velocity [N, P, K], refine, presence
    [N, P, K, 2]) from ``data.labels.encode_batch``, as tensors
    on the module's device."""
    begins, ends, mask, velocity, refine, presence = labels
    n, p, k = begins.shape
    t = frames.shape[2]
    t_pad, p_pad = _pad_to(t, semicrf.PALLAS_KP), _track_pad(n, p)
    s_pad, noise_pad, ctx = module.process_frames_train(frames, t_pad, p_pad)

    def lanes(a):  # [N, P, K] -> [N * p_pad, K], padded tracks empty
        return torch.nn.functional.pad(a, (0, 0, 0, p_pad - p)).reshape(n * p_pad, k)

    path = semicrf.eval_path_padded(s_pad, noise_pad[:-1], lanes(begins), lanes(ends), lanes(mask))
    log_z = logz.log_z_padded(t, s_pad, noise_pad)
    logp = (path - log_z).reshape(n, p_pad)[:, :p]

    vel_logits, of_value, of_presence = module.attributes(
        _gather_ctx(ctx, begins), _gather_ctx(ctx, ends)
    )
    logp_vel = torch.log_softmax(vel_logits, dim=-1).gather(-1, velocity[..., None].long())[..., 0]
    refined = refine * 0.99 + 0.5  # [-0.5, 0.5] -> [0.005, 0.995]
    logp_of = dist.continuous_bernoulli_log_prob(of_value, refined).sum(-1)
    logp_presence = dist.bernoulli_log_prob(of_presence, presence).sum(-1)
    attr = torch.where(mask.bool(), logp_vel + logp_of + logp_presence, 0.0).sum(-1)
    return logp + attr


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

    def load_state_dict(self, state_dict) -> None:
        self.module.load_state_dict(state_dict, strict=True)

    # -- training -------------------------------------------------------------

    def frames(self, audio_batch: np.ndarray) -> torch.Tensor:
        """audio [N, nSample, C] -> frames [N, C, T, W] on the device."""
        x = torch.from_numpy(np.ascontiguousarray(np.swapaxes(audio_batch, -1, -2), np.float32))
        return frontend.make_frame(x.to(self.device), self.hopSize, self.windowSize)

    def labels(self, notes_batch, max_events: int = 32) -> Labels:
        """Note lists -> padded label tensors on the device."""
        from ..data.labels import encode_batch

        labels = encode_batch(notes_batch, self.hopSize / self.fs, self.targetMIDIPitch, max_events)
        return tuple(torch.from_numpy(a).to(self.device) for a in labels.astuple())

    def make_train_loss(self):
        """loss_fn(frames, labels, generator) -> logp [N, P] in train mode,
        with every dropout mask drawn from ``generator``."""

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
        Viterbi tables through ``semicrf.viterbi_backward_tables`` (the
        kernel for a CUDA tensor)."""
        self.module.eval()
        s, noise, ctx = self.module.process_frames(frames)
        ptr, diag = semicrf.viterbi_backward_tables(s, noise)
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
        vel_logits, of_value, of_presence = self.module.attributes(
            _gather_ctx(ctx, begins), _gather_ctx(ctx, ends)
        )
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
        CUDA kernel for a CUDA segment."""
        n_sym = len(self.targetMIDIPitch)
        frames = frontend.make_frame(seg_audio[None], self.hopSize, self.windowSize)
        t = frames.shape[-2]
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

        The segments go through the device in groups of ``segment_batch``
        (``None``: DEFAULT_SEGMENT_BATCH, whatever the piece's length).  A
        segment's device work does not depend on the stitching state, so
        group g+1 is enqueued before group g's tables are fetched and the
        card works while the host walks.  Group g's pointers are then
        walked, its attributes read from its ctx and its device tensors
        dropped: at most two groups' ctx are alive at any time, so device
        memory does not grow with the piece.  The notes do not depend on
        ``segment_batch``."""
        self.module.eval()
        if step_in_second is None and segment_size_in_second is None:
            step_in_second = self.segmentHopSizeInSecond
            segment_size_in_second = self.segmentSizeInSecond
        if segment_batch is None:
            segment_batch = DEFAULT_SEGMENT_BATCH
        if segment_batch < 1:
            raise ValueError(f"segment_batch must be at least 1, got {segment_batch}")
        x = np.asarray(x)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = x.T.astype(np.float32)  # [C, nSample]

        pad_time_begin = segment_size_in_second - step_in_second
        pad = math.ceil(pad_time_begin * self.fs)
        n_sample = x.shape[-1] + 2 * pad
        start_frame_idx = math.floor(pad_time_begin * self.fs / self.hopSize)
        step_size = math.ceil(step_in_second * self.fs / self.hopSize) * self.hopSize
        segment_size = math.ceil(segment_size_in_second * self.fs)
        last_frame_idx = round(segment_size / self.hopSize)
        onset_bound = step_size if discard_second_half else None
        starts = list(range(0, n_sample, step_size))
        step_frames = int(step_size / self.hopSize)
        n_sym = len(self.targetMIDIPitch)
        groups = [starts[g0 : g0 + segment_batch] for g0 in range(0, len(starts), segment_batch)]

        # the padded waveform goes to the device once; the extra segment of
        # zeros keeps every window in bounds
        audio = torch.from_numpy(np.pad(x, ((0, 0), (pad, pad + segment_size))))
        audio = audio.to(self.device)

        seg_notes: List[List[Note]] = []
        cur_start = [start_frame_idx] * n_sym
        enqueued = self._group_tables(audio, groups[0], segment_size, last_frame_idx)
        for g, group in enumerate(groups):
            ptr, diag, bpres, ctx = enqueued
            # the next group's device work before this group's first fetch
            enqueued = None
            if g + 1 < len(groups):
                enqueued = self._group_tables(audio, groups[g + 1], segment_size, last_frame_idx)
            ptr_np, diag_np, bpres_np = ptr.cpu().numpy(), diag.cpu().numpy(), bpres.cpu().numpy()
            del ptr, diag, bpres

            # the sequential stitching chain on the host
            paths = []
            for gi in range(len(group)):
                path = semicrf.backtrack_backward(ptr_np[gi], diag_np[gi], cur_start)
                if onset_bound is not None:
                    path = [[e for e in p if e[0] < onset_bound] for p in path]
                paths.append(path)
                # lastP: end of the last decoded interval whose offset is real;
                # edge-touching intervals consult the presence bits
                last_p = []
                for j in range(n_sym):
                    cur_last = 0
                    for b, e in path[j]:
                        if e < last_frame_idx or bpres_np[gi, j, b, e - last_frame_idx]:
                            cur_last = e
                    last_p.append(cur_last)
                cur_start = [max(k - step_frames, 0) for k in last_p]

            begin_times = np.array([s / self.fs - pad_time_begin for s in group], np.float64)
            notes, _ = self._attr_and_assemble(
                ctx, paths, velocity_criterion, last_frame_idx, begin_times)
            seg_notes.extend(notes)
            del ctx
        return _merge_segments(seg_notes, merge_incomplete_event)


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
