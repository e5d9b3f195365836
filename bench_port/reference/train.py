"""Plain reference of a training step: a chunk's audio and labels worked
out from the corpus, the loss, its gradient by autograd, the clip to a
running quantile of past gradient norms, and rectified AdaBelief with
decoupled weight decay (transkun/train.py and TrainUtil.py; optax's
``scale_by_belief`` order).  Nothing here imports the program.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import frontend

# parameters that do not decay: biases, the patchifier's GroupNorms and the
# position-embedding builders (TrainUtil.py)
NO_DECAY = re.compile(r"\.bias$|^backbone\.downConv\.(2|6|10|14)\.|^backbone\.posEmbedBuilder")


def chunk_notes(notes: Sequence[tuple], begin: float, end: float) -> List[tuple]:
    """Notes (start, end, pitch, velocity) of a piece overlapping [begin,
    end) -> (start, end, pitch, velocity, has_onset, has_offset) in chunk
    time, cut at the chunk's edges."""
    out = []
    for s, e, p, v in notes:
        if s < end and e > begin:
            out.append((max(s, begin) - begin, min(e, end) - begin, p, v, s >= begin, e < end))
    return out


def labels(notes_batch, hop_s: float, pitches: Sequence[int], device, max_events=None) -> Dict[str, torch.Tensor]:
    """Chunk notes -> per-track intervals on the frame grid (endpoints
    rounded, the residuals kept as refinement targets; two notes of a
    pitch that collide on the grid merge, keeping the first velocity) as
    padded [N, P, K] tensors.  K is the densest track's count, or with
    ``max_events`` the training command's slots: ``max_events``, grown to
    the next multiple of 16 for a denser track (the heads' dropout masks
    take K's shape)."""
    per_item = []
    for notes in notes_batch:
        tracks = defaultdict(list)
        for n in sorted(notes, key=lambda n: (n[0], n[1], n[2])):
            tracks[n[2]].append(n)
        items = []
        for p in pitches:
            ivs = []
            for s, e, _, v, on, off in tracks[p]:
                sq, eq = int(round(s / hop_s)), int(round(e / hop_s))
                sr, er = s / hop_s - sq, e / hop_s - eq
                if ivs and (sq < ivs[-1][1] or (eq == ivs[-1][1] and ivs[-1][0] == sq)):
                    last = ivs[-1]
                    ivs[-1] = (last[0], eq, last[2], last[3], er, last[5], off)
                else:
                    ivs.append((sq, eq, v, sr, er, on, off))
            items.append(ivs)
        per_item.append(items)
    densest = max((len(t) for it in per_item for t in it), default=0)
    if max_events is None:
        k = max(densest, 1)
    else:
        k = max_events if densest <= max_events else -(-densest // 16) * 16
    n, n_p = len(notes_batch), len(pitches)
    a = {name: np.zeros((n, n_p, k), dt) for name, dt in
         (("begins", np.int64), ("ends", np.int64), ("mask", bool), ("velocity", np.int64))}
    refine = np.zeros((n, n_p, k, 2), np.float32)
    presence = np.zeros((n, n_p, k, 2), np.float32)
    for i, items in enumerate(per_item):
        for j, ivs in enumerate(items):
            for q, (b, e, v, sr, er, on, off) in enumerate(ivs):
                a["begins"][i, j, q], a["ends"][i, j, q], a["mask"][i, j, q] = b, e, True
                a["velocity"][i, j, q] = v
                refine[i, j, q] = (sr, er)
                presence[i, j, q] = (on, off)
    out = {name: torch.from_numpy(v).to(device) for name, v in a.items()}
    out["refine"] = torch.from_numpy(refine).to(device)
    out["presence"] = torch.from_numpy(presence).to(device)
    return out


def dropout_seed(run_seed: int, step: int) -> int:
    """The seed of a one-process training run's dropout generator at
    ``step``, as the training command states it: ``step * 7919 +
    run_seed``, modulo 2**32."""
    return (step * 7919 + run_seed) % 2**32


def chunk_audio(wave_int16: np.ndarray, begin: float, fs: int, length: int) -> np.ndarray:
    """A chunk of ``length`` samples from ``floor(begin * fs)``, zeros
    outside the piece, as int16 / 32767 in float32."""
    b = math.floor(begin * fs)
    out = np.zeros(length, np.float32)
    lo, hi = max(b, 0), min(b + length, len(wave_int16))
    if hi > lo:
        out[lo - b:hi - b] = np.divide(wave_int16[lo:hi], 32767, dtype=np.float32)
    return out


def batch_frames(waves: List[np.ndarray], conf: dict, device) -> torch.Tensor:
    x = torch.from_numpy(np.stack(waves)).to(device)[:, None]
    return frontend.frames(x, conf["hopSize"], conf["windowSize"])


class Optimizer:
    """Quantile clip and rectified AdaBelief over named float32 leaves,
    starting from zero moments at ``count``."""

    def __init__(self, params: Dict[str, torch.Tensor], count: int, max_lr=2e-4, weight_decay=1e-4,
                 n_iter=180000, warmup_cutoff=500, b1=0.9, b2=0.999, eps=1e-8, clip_init=40.0,
                 quantile=0.8):
        self.params = params
        self.count = count
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.norms = [clip_init]
        self.hp = dict(max_lr=max_lr, wd=weight_decay, n_iter=n_iter, cutoff=warmup_cutoff, b1=b1, b2=b2,
                       eps=eps, q=quantile)

    def _lr(self) -> float:
        """OneCycle (cosine, 5% warm-up, divisors 20 and 2) whose clock
        starts after the cutoff, times the RAdam rectification; in float32,
        as optax computes it."""
        h = self.hp
        f = np.float32
        values = np.cumprod([h["max_lr"] / 20.0, 20.0, 1.0 / 40.0])
        ends, halves = values[1:].astype(f), ((values[:-1] - values[1:]) / 2.0).astype(f)
        bounds = [0, int(0.05 * h["n_iter"]), int(h["n_iter"])]
        eff = min(max(self.count - h["cutoff"], 0), h["n_iter"])
        lr = f(0.0)
        for i in range(2):
            if bounds[i] <= eff < bounds[i + 1]:
                pct = f(eff - bounds[i]) / f(bounds[i + 1] - bounds[i])
                lr = ends[i] + halves[i] * (np.cos(f(math.pi) * pct) + f(1.0))
        if eff >= bounds[-1]:
            lr = ends[-1]
        t = f(self.count) + f(1.0)
        rho_inf = f(2.0 / (1.0 - h["b2"]) - 1.0)
        b2t = f(h["b2"]) ** t
        rho = rho_inf - f(2.0) * t * b2t / (f(1.0) - b2t)
        if rho <= 4.0:
            return 0.0
        ratio = (rho - f(4.0)) * (rho - f(2.0)) * rho_inf / ((rho_inf - f(4.0)) * (rho_inf - f(2.0)) * rho)
        return float(f(lr) * np.sqrt(ratio))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip and update; returns the gradients as the moments took them."""
        h = self.hp
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        clip = float(np.quantile(np.array(self.norms), h["q"]))
        scale = min(clip / (norm + 1e-6), 1.0)
        self.norms.append(norm)
        lr = self._lr()
        t = self.count + 1
        bc1, bc2 = 1 - h["b1"] ** t, 1 - h["b2"] ** t
        taken = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            taken[k] = g
            self.mu[k] = h["b1"] * self.mu[k] + (1 - h["b1"]) * g
            self.nu[k] = h["b2"] * self.nu[k] + (1 - h["b2"]) * (g - self.mu[k]) ** 2 + 1e-16
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + h["eps"])
            if NO_DECAY.search(k) is None:
                u = u + h["wd"] * p
            p.sub_(lr * u)
        self.count += 1
        return taken
