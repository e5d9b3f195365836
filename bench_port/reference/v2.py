"""Plain reference of TransKun V2 (Yan & Duan, ISMIR 2024, "Scoring Time
Intervals Using Non-Hierarchical Transformer for Automatic Piano
Transcription"; transkun/ModelTransformer.py): the log-mel frontend, the
strided-convolution patchifier, the axial (frequency, then time) attention
encoder over the mel lattice with one token per pitch track appended, the
temporal upsample, the scaled inner-product interval scorer, the semi-CRF
objective and its Viterbi decode with the segment stitching, and the
attribute heads.

Written as functions of a ``state_dict`` in the program's key names, in
float32, with no kernel, cache or batching of the program's.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import frontend, semicrf

PITCHES = [-64, -67] + list(range(21, 109))  # sustain and una-corda pedals, then the keys


def _linear(P, name, x):
    return x @ P[name + ".weight"].t() + P[name + ".bias"]


def _mlp(P, name, x, drop=None):
    """Linear, exact GELU, dropout (``drop``, in training), Linear (indices
    0 and 3)."""
    h = F.gelu(_linear(P, name + ".0", x))
    return _linear(P, name + ".3", h if drop is None else drop(h))


def dropout(p: float, generator: torch.Generator):
    """Inverted dropout at rate ``p`` whose keep mask, the shape of its
    input, is drawn from ``generator``; the identity at p == 0, which draws
    nothing."""

    def drop(x):
        if p == 0.0:
            return x
        keep = 1.0 - p
        mask = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(keep, generator=generator)
        return x * mask / keep

    return drop


def _rms(x):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)


def _pos_embed(P, name, coords):
    z = torch.cos(_linear(P, name + ".proj", coords))
    return _mlp(P, name + ".mlp", z / math.sqrt(z.shape[-1] / 2))


def _attn_block(P, name, x, mem, heads):
    """x + LayerScale * MHA(rms(x) as queries, the block input as keys and
    values), attending along axis -2."""
    q = _rms(x) @ P[name + ".module.q_proj_weight"]
    k = mem @ P[name + ".module.k_proj_weight"]
    v = mem @ P[name + ".module.v_proj_weight"]
    hd = q.shape[-1] // heads

    def split(a):
        return a.reshape(*a.shape[:-1], heads, hd).transpose(-2, -3)

    w = torch.softmax(split(q) @ split(k).transpose(-1, -2) / math.sqrt(hd), dim=-1)
    o = (w @ split(v)).transpose(-2, -3)
    o = o.reshape(*o.shape[:-2], heads * hd)
    return x + _linear(P, name + ".module.out_proj", o) * P[name + ".scale"]


def _ffn_block(P, name, x):
    return x + _mlp(P, name + ".module", _rms(x)) * P[name + ".scale"]


def _conv(P, name, x, stride=1):
    return F.conv2d(x, P[name + ".weight"], P[name + ".bias"], stride=stride, padding=1)


def _group_norm(P, name, x):
    return F.group_norm(x, 4, P[name + ".weight"], P[name + ".bias"], eps=1e-5)


class Model:
    """The V2 network for one configuration (a dict of the published conf's
    keys) and one set of weights."""

    def __init__(self, conf: dict, params: Dict[str, torch.Tensor], device):
        self.conf = conf
        self.P = params
        self.k = frontend.Constants(conf, device)
        self.device = device
        self.pitches = torch.tensor(PITCHES, dtype=torch.float32, device=device)

    # -- network ----------------------------------------------------------------

    def features(self, fr: torch.Tensor) -> torch.Tensor:
        return frontend.log_mel(self.P, "framewiseFeatureExtractor.spectrogramExtractor.", self.k, fr)

    def ctx(self, fr: torch.Tensor) -> torch.Tensor:
        """Frames [N, C, T, W] -> per-track context [N, P, T, D]."""
        P, conf = self.P, self.conf
        x = self.features(fr)  # [N, T, F, C]
        n, n_t, n_f, _ = x.shape
        dev = x.device
        pos_f = _pos_embed(P, "backbone.posEmbedBuilder",
                           torch.arange(n_f, dtype=torch.float32, device=dev)[:, None])
        h = _conv(P, "backbone.inputConv", x.permute(0, 3, 1, 2)) + pos_f.t()[:, None, :]
        # the patchifier: 8x in time, 4x in frequency
        h = F.pad(h, (2, 1, 4, 3))
        for conv, norm, stride in ((1, 2, (2, 1)), (5, 6, (2, 2)), (9, 10, (2, 2))):
            h = F.gelu(_group_norm(P, f"backbone.downConv.{norm}",
                                   _conv(P, f"backbone.downConv.{conv}", h, stride)))
        h = _group_norm(P, "backbone.downConv.14", _conv(P, "backbone.downConv.13", h))
        h = h.permute(0, 2, 3, 1)  # [N, T', F', D]
        h = F.pad(h, (0, 0, 1, 0, 1, 0))  # an aggregation step in front of time and frequency
        tp, fp = h.shape[1], h.shape[2]
        ct = torch.arange(tp, dtype=torch.float32, device=dev)
        cf = torch.arange(fp, dtype=torch.float32, device=dev)
        grid_tf = torch.stack(torch.meshgrid(ct, cf, indexing="ij"), -1)
        grid_te = torch.stack(torch.meshgrid(ct, self.pitches, indexing="ij"), -1)
        h = h + _pos_embed(P, "backbone.posEmbedBuilderAttnTF", grid_tf)
        te = _pos_embed(P, "backbone.posEmbedBuilderAttnTE", grid_te)
        h = torch.cat([h, te.expand(n, *te.shape)], dim=2)  # [N, T', F'+P, D]
        heads = conf["nHead"]
        for i in range(conf["nLayers"]):
            name = f"backbone.encoderLayers.{i}"
            mem = h
            h = _ffn_block(P, name + ".fnnBlockF", _attn_block(P, name + ".mhaBlockF", h, mem, heads))
            h, mem = h.transpose(1, 2), mem.transpose(1, 2)
            h = _ffn_block(P, name + ".fnnBlockT", _attn_block(P, name + ".mhaBlockT", h, mem, heads))
            h = h.transpose(1, 2)
        h = h[:, 1:, fp:]  # the pitch tracks, without the aggregation step
        n_p, d = h.shape[2], h.shape[3]
        w = P["backbone.upConv1dSkip.weight"]  # [d, out, steps]
        steps, out = w.shape[2], w.shape[1]
        up = h.transpose(1, 2) @ w.permute(0, 2, 1).reshape(d, steps * out) + P["backbone.upConv1dSkip.bias"]
        up = up.reshape(n, n_p, (tp - 1) * steps, out)
        return up[:, :, :n_t]

    def scores(self, ctx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ctx [N, P, T, D] -> (S [N, P, T_end, T_begin] with |end - begin|
        scaling and the singleton score on the diagonal, the singleton
        scores [N, P, T])."""
        mapped = _linear(self.P, "scorer.map.0", ctx)
        e = (mapped.shape[-1] - 1) // 2
        q = mapped[..., :e] / math.sqrt(e)
        k = mapped[..., e:2 * e]
        diag = mapped[..., 2 * e]
        t = ctx.shape[2]
        idx = torch.arange(t, device=ctx.device)
        s = (q @ k.transpose(-1, -2)) * (idx[:, None] - idx[None, :]).abs().float()
        s = s + torch.diag_embed(diag)
        return s, diag

    def heads(self, ctx_a, ctx_b, generator=None):
        """-> (velocity logits [..., 128], onset/offset refinement logits
        [..., 2], onset/offset presence logits [..., 2]).  With
        ``generator`` (training), each head's hidden layer takes dropout at
        the configuration's rate, the refinement head's mask drawn first."""
        x = torch.cat([ctx_a, ctx_b, ctx_a * ctx_b], dim=-1)
        drop_of = drop_vel = None
        if generator is not None:
            drop_of = dropout(self.conf["refinedOFDropoutProb"], generator)
            drop_vel = dropout(self.conf["velocityDropoutProb"], generator)
        of = _mlp(self.P, "refinedOFPredictor", x, drop_of)
        return _mlp(self.P, "velocityPredictor", x, drop_vel), of[..., :2], of[..., 2:]

    # -- training objective ------------------------------------------------------

    def log_prob(self, fr: torch.Tensor, labels: dict, generator=None) -> torch.Tensor:
        """Per-track log-likelihood [N, P] of the labelled intervals and
        their attributes; with ``generator``, in training, the heads'
        dropout masks drawn from it.  The backbone's dropout rate
        (``contextDropoutProb``) is 0 in the published configuration and
        the interval scorer has none, so the heads draw every mask."""
        if generator is not None and self.conf["contextDropoutProb"] != 0.0:
            raise NotImplementedError("the reference draws no dropout mask in the backbone")
        ctx = self.ctx(fr)
        s, _ = self.scores(ctx)
        n, n_p, t, _ = s.shape
        lanes = s.permute(2, 3, 0, 1).reshape(t, t, n * n_p)
        noise = lanes.new_zeros(t - 1, n * n_p)
        b, e, m = (labels[k].reshape(n * n_p, -1) for k in ("begins", "ends", "mask"))
        lp = (semicrf.path_score(lanes, noise, b, e, m) - semicrf.log_z(lanes, noise)).reshape(n, n_p)
        gb = torch.take_along_dim(ctx, labels["begins"][..., None], dim=2)
        ge = torch.take_along_dim(ctx, labels["ends"][..., None], dim=2)
        vel, of_value, of_pres = self.heads(gb, ge, generator)
        lp_vel = torch.log_softmax(vel, -1).gather(-1, labels["velocity"][..., None])[..., 0]
        refined = labels["refine"] * 0.99 + 0.5
        lp_of = continuous_bernoulli_log_prob(of_value, refined).sum(-1)
        lp_pres = (labels["presence"] * of_pres - F.softplus(of_pres)).sum(-1)
        attr = torch.where(labels["mask"], lp_vel + lp_of + lp_pres, 0.0).sum(-1)
        return lp + attr

    # -- transcription -----------------------------------------------------------

    @torch.no_grad()
    def transcribe(self, x: np.ndarray, block: int = 4) -> List[dict]:
        """Mono waveform [n] at conf fs -> notes (dicts of start, end,
        pitch, velocity): 16 s segments every 8 s over the piece padded by
        8 s each side, each segment decoded from where the previous one's
        last confirmed offset, less the hop, leaves each track; the segments'
        notes merged across the overlaps."""
        conf = self.conf
        fs, hop, win = conf["fs"], conf["hopSize"], conf["windowSize"]
        seg_s, step_s = conf["segmentSizeInSecond"], conf["segmentHopSizeInSecond"]
        lead = seg_s - step_s
        pad = math.ceil(lead * fs)
        step = math.ceil(step_s * fs / hop) * hop
        seg = math.ceil(seg_s * fs)
        last_frame = round(seg / hop)
        step_frames = step // hop
        audio = np.pad(np.asarray(x, np.float32), (pad, pad + seg))
        starts = list(range(0, len(x) + 2 * pad, step))
        start = np.full(len(PITCHES), math.floor(lead * fs / hop), np.int64)
        frame_s = hop / fs
        seg_notes = []
        for b0 in range(0, len(starts), block):
            group = starts[b0:b0 + block]
            wave = torch.from_numpy(np.stack([audio[s:s + seg] for s in group])).to(self.device)
            fr = frontend.frames(wave[:, None], hop, win)  # [B, 1, T, W]
            ctx = self.ctx(fr)
            s, diag = self.scores(ctx)
            nb, n_p, t, _ = s.shape
            # [begin, end, lane] for the backward recursion
            s_be = s.permute(3, 2, 0, 1).reshape(t, t, nb * n_p)
            ptr, present = semicrf.viterbi_backward(
                s_be, s_be.new_zeros(t - 1, nb * n_p), diag.permute(2, 0, 1).reshape(t, nb * n_p))
            ptr = ptr.cpu().numpy().reshape(t - 1, nb, n_p)
            present = present.cpu().numpy().reshape(t, nb, n_p)
            for i, s0 in enumerate(group):
                tracks = semicrf.walk(ptr[:, i], present[:, i], start)
                notes, ends_real = self._notes(ctx[i], tracks, last_frame, frame_s, s0 / fs - lead)
                seg_notes.append(notes)
                start = np.maximum(ends_real - step_frames, 0)
        return merge(seg_notes)

    def _notes(self, ctx, tracks, last_frame, frame_s, t0):
        """One segment's intervals -> notes in piece time, and each track's
        last interval end whose offset is real (the next segment's start)."""
        n_p = len(tracks)
        b, e, m = semicrf.interval_arrays(tracks)
        bt, et = (torch.from_numpy(a).to(ctx.device) for a in (b, e))
        vel, of_value, of_pres = self.heads(torch.take_along_dim(ctx, bt[..., None], dim=1),
                                            torch.take_along_dim(ctx, et[..., None], dim=1))
        velocity = vel.argmax(-1).cpu().numpy()
        of = torch.clamp((continuous_bernoulli_mean(of_value) - 0.5) / 0.99, -0.5, 0.5)
        of = of.cpu().numpy().astype(np.float64)
        pres = (of_pres > 0).cpu().numpy()
        has_on = (b > 0) | pres[..., 0]
        has_off = (e < last_frame) | pres[..., 1]
        ends_real = np.max(np.where(m & has_off, e, 0), axis=1, initial=0)
        notes = []
        for j in range(n_p):
            prev_end = 0.0
            for i in range(int(m[j].sum())):
                s_ = max((b[j, i] + of[j, i, 0]) * frame_s, prev_end)
                e_ = max((e[j, i] + of[j, i, 1]) * frame_s, s_ + 1e-8)
                prev_end = e_
                start = max(s_ + t0, 0.0)
                notes.append(dict(start=start, end=max(e_ + t0, start), pitch=PITCHES[j],
                                  velocity=int(velocity[j, i]), on=bool(has_on[j, i]),
                                  off=bool(has_off[j, i])))
        notes.sort(key=lambda n: (n["start"], n["end"], n["pitch"]))
        return notes, ends_real


def merge(seg_notes: List[List[dict]]) -> List[dict]:
    """Notes of overlapping segments -> one list: a note that starts before
    the previous note of its pitch ends replaces it if it has an onset, else
    extends it; the last note of each pitch is closed; notes without an
    offset are dropped; then each note is cut at the next onset of its
    pitch and empty notes go."""
    by_pitch = defaultdict(list)
    for notes in seg_notes:
        for n in notes:
            lst = by_pitch[n["pitch"]]
            if lst and n["start"] < lst[-1]["end"]:
                if n["on"]:
                    lst[-1] = dict(n)
                else:
                    lst[-1]["off"] = n["off"]
                    lst[-1]["end"] = max(n["end"], lst[-1]["end"])
                continue
            if n["on"]:
                lst.append(dict(n))
    for lst in by_pitch.values():
        if lst:
            lst[-1]["off"] = True
    out = sorted((n for lst in by_pitch.values() for n in lst if n["off"]),
                 key=lambda n: (n["start"], n["end"], n["pitch"]))
    last = {}
    for n in out:
        prev = last.get(n["pitch"])
        if prev is not None and prev["end"] > n["start"]:
            prev["end"] = n["start"]
        last[n["pitch"]] = n
    return [n for n in out if n["start"] < n["end"]]


def continuous_bernoulli_log_norm(logits):
    a = logits.abs()
    far = a > 8e-3
    safe = torch.where(far, a, torch.ones_like(a))
    exact = torch.log(safe) - (torch.log1p(-torch.exp(-safe)) - torch.log1p(torch.exp(-safe)))
    d = torch.sigmoid(logits) - 0.5
    return torch.where(far, exact, math.log(2.0) + 4.0 / 3.0 * d ** 2 + 104.0 / 45.0 * d ** 4)


def continuous_bernoulli_log_prob(logits, value):
    return value * logits - F.softplus(logits) + continuous_bernoulli_log_norm(logits)


def continuous_bernoulli_mean(logits):
    far = logits.abs() > 8e-3
    safe = torch.where(far, logits, torch.ones_like(logits))
    exact = torch.sigmoid(safe) / torch.tanh(safe / 2.0) - 1.0 / safe
    d = torch.sigmoid(logits) - 0.5
    return torch.where(far, exact, 0.5 + d / 3.0 + 16.0 / 45.0 * d ** 3)
